"""PyTorch port, cap autotuning (``repro_torch.solver.autotune`` and
``FmmSolver.tune``) held to the JAX reference's on the same seeded numpy
samples (the twins of ``tests/test_solver.py``'s tune tests): trials,
stats, tuned configs and tile trials equal field for field; the tuned
solver's phi within 1e-10 relative of the reference's (f64). The port
runs with ``device="cpu"``."""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from repro.solver import FmmSolver as JaxSolver
from repro.solver import probe_caps as jax_probe_caps
from repro.solver import tune_caps as jax_tune_caps
from repro.solver import tune_tiles as jax_tune_tiles
from repro.solver import autotune as jax_autotune
from repro_torch.solver import (FmmSolver, TuneResult, get_backend,
                                probe_caps, register_backend, tune_caps,
                                tune_tiles)
from repro_torch.solver import autotune

from _torch_parity import configs, inputs, rel

TOL = 1e-10
CPU = "cpu"
# the reference tests' CFG64
JCFG, TCFG = configs(n=256, nlevels=2, p=10, dtype="f64")
TINY = dict(strong_cap=2, weak_cap=2)


def _batch(b, n=TCFG.n, dist="uniform", seed0=0):
    zs, qs = zip(*(inputs(dist, n, seed0 + i) for i in range(b)))
    return np.stack(zs), np.stack(qs)


def _sample(kind):
    if kind == "single":
        return inputs("normal", TCFG.n, 5)
    return _batch(4, dist="normal" if kind == "batch-normal" else "uniform")


def _cfgs(caps):
    kw = TINY if caps == "tiny" else {}
    return (dataclasses.replace(JCFG, **kw), dataclasses.replace(TCFG, **kw))


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("kind", ["single", "batch", "batch-normal"])
@pytest.mark.parametrize("caps", ["default", "tiny"])
@pytest.mark.parametrize("hooks", [None, "cuda"])
def test_probe_caps_matches_reference(kind, caps, hooks):
    """One build per row; a (B, N) sample takes the worst row (minimum
    margin per class, maximum count); the "cuda" topology hook (its
    plain version here) gives the same lists."""
    z, q = _sample(kind)
    jcfg, tcfg = _cfgs(caps)
    topo = None if hooks is None else get_backend(hooks).topology_impls()
    got = probe_caps(z, q, tcfg, topology_impls=topo, device=CPU)
    assert got == jax_probe_caps(jnp.asarray(z), jnp.asarray(q), jcfg)
    if caps == "tiny":
        assert got[0] > 0                        # genuinely undersized


@pytest.mark.parametrize("kind", ["single", "batch", "batch-normal"])
@pytest.mark.parametrize("caps", ["default", "tiny"])
def test_tune_caps_matches_reference(kind, caps):
    """Grow, shrink to margin x the maxima rounded up, verify: the same
    trials, stats and tuned config."""
    z, q = _sample(kind)
    jcfg, tcfg = _cfgs(caps)
    res = tune_caps(z, q, tcfg, device=CPU)
    jres = jax_tune_caps(jnp.asarray(z), jnp.asarray(q), jcfg)
    assert isinstance(res, TuneResult)
    assert res.trials == jres.trials and res.stats == jres.stats
    assert _fields(res.cfg) == _fields(jres.cfg)
    assert res.stats["overflow"] == 0 and res.trials[-1][2] == 0
    assert res.cfg.strong_cap >= res.stats["strong_max"]
    assert res.cfg.weak_cap >= res.stats["weak_max"]
    if caps == "tiny":                           # growth trials recorded
        assert any(t[2] > 0 for t in res.trials)


@pytest.mark.parametrize("margin,round_to", [(1.0, 8), (1.5, 16), (2.0, 4)])
def test_tune_caps_margin_and_rounding_match_reference(margin, round_to):
    z, q = _sample("single")
    res = tune_caps(z, None, TCFG, margin=margin, round_to=round_to,
                    device=CPU)
    jres = jax_tune_caps(jnp.asarray(z), None, JCFG, margin=margin,
                         round_to=round_to)
    assert res.trials == jres.trials and _fields(res.cfg) == _fields(jres.cfg)
    assert res.cfg.strong_cap % round_to == 0


def test_tune_caps_errors_match_reference():
    with pytest.raises(ValueError):
        tune_caps(np.zeros(4), None, TCFG, margin=0.5)
    z, q = _sample("single")
    _, tiny = _cfgs("tiny")
    with pytest.raises(RuntimeError, match="still overflows") as ei:
        tune_caps(z, q, tiny, max_grow=1, device=CPU)
    with pytest.raises(RuntimeError) as jei:
        jax_tune_caps(jnp.asarray(z), jnp.asarray(q), _cfgs("tiny")[0],
                      max_grow=1)
    assert str(ei.value) == str(jei.value)


# ---------------------------------------------------------------------------
# the tile fields
# ---------------------------------------------------------------------------

BIG_LEAVES = dict(n=1 << 15, nlevels=2, p=10, dtype="f32")


@pytest.mark.parametrize("kw", [dict(n=256, nlevels=2, p=10, dtype="f64"),
                                BIG_LEAVES,
                                dict(n=1 << 20, nlevels=7, p=17)])
def test_tile_formulas_match_reference(kw):
    jcfg, tcfg = configs(**kw)
    for tb in (1, 2, 4, 8, 16):
        for sw in (1, 2, 4):
            assert (autotune.eval_fused_vmem_bytes(tcfg, tb, sw)
                    == jax_autotune.eval_fused_vmem_bytes(jcfg, tb, sw))
    for budget in (1 << 20, autotune.EVAL_VMEM_BUDGET):
        assert (autotune.tile_candidates(tcfg, budget)
                == jax_autotune.tile_candidates(jcfg, budget))
    assert _fields(autotune.heuristic_tiles(tcfg)) == _fields(
        jax_autotune.heuristic_tiles(jcfg))


@pytest.mark.parametrize("backend,jax_backend", [("reference", "reference"),
                                                 ("cuda", "pallas")])
def test_tune_tiles_without_a_timer_is_the_heuristic(backend, jax_backend):
    """No backend is timed by itself: the reference's "not measurable"
    branch, the heuristic tile with None seconds."""
    z, q = _sample("single")
    got = tune_tiles(z, q, TCFG, backend=backend, device=CPU)
    jgot = jax_tune_tiles(jnp.asarray(z), jnp.asarray(q), JCFG,
                          backend=jax_backend)
    assert _fields(got[0]) == _fields(jgot[0]) and got[1] == jgot[1]
    assert got[1] == [(got[0].tile_boxes, 1, None)]


def _timer(log):
    def timer(z, q, cfg):
        log.append((tuple(z.shape), cfg.tile_boxes, cfg.stage_width))
        return float(cfg.tile_boxes)
    return timer


def test_tune_tiles_timer_sweep_matches_reference():
    """The reference sweeps an injected timer over its tile fields; no
    CUDA kernel reads them, so the port refuses the timer before it
    times anything."""
    z, q = _sample("single")
    log = []
    with pytest.raises(NotImplementedError, match="tile_boxes/stage_width"):
        tune_tiles(z, q, TCFG, timer=_timer(log), device=CPU)
    assert log == []


@pytest.mark.parametrize("backend,batched", [("reference", True),
                                             ("cuda", True),
                                             ("fallback", False)])
def test_tune_tiles_batched_sample_keeps_the_batch_axis(backend, batched):
    """A (B, N) sample with a timer is refused on every backend,
    whatever its ``batched_dispatch``; without one it gets the heuristic
    tile, as a single problem does."""
    if backend == "fallback":
        register_backend(dataclasses.replace(
            get_backend("cuda"), name="fallback",
            batched_dispatch="fallback"))
    assert (get_backend(backend).batched_dispatch != "fallback") == batched
    zb, qb = _batch(3)
    log = []
    with pytest.raises(NotImplementedError):
        tune_tiles(zb, qb, TCFG, backend=backend, timer=_timer(log),
                   device=CPU)
    assert log == []
    z, q = _sample("single")
    assert (tune_tiles(zb, qb, TCFG, backend=backend, device=CPU)
            == tune_tiles(z, q, TCFG, backend=backend, device=CPU))


# ---------------------------------------------------------------------------
# FmmSolver.tune
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,jax_backend", [("reference", "reference"),
                                                 ("cuda", "pallas")])
@pytest.mark.parametrize("tiles", ["off", "heuristic", "timer"])
def test_solver_tune_matches_reference(backend, jax_backend, tiles):
    zb, qb = _batch(4)
    kw = {"tiles": tiles != "off"}
    if tiles == "timer":
        # the reference's sweep times fields no CUDA kernel reads: the
        # port refuses the timer and the reference's run is not needed
        log = []
        with pytest.raises(NotImplementedError):
            FmmSolver.build(TCFG, backend, CPU).tune(zb, qb,
                                                     tile_timer=_timer(log))
        assert log == []
        return
    tuned = FmmSolver.build(TCFG, backend, CPU).tune(zb, qb, **kw)
    jtuned = JaxSolver.build(JCFG, jax_backend).tune(jnp.asarray(zb),
                                                     jnp.asarray(qb), **kw)
    res, jres = tuned.tune_result, jtuned.tune_result
    assert _fields(tuned.cfg) == _fields(res.cfg) == _fields(jres.cfg)
    assert (res.stats, res.trials, res.tile_trials) == (
        jres.stats, jres.trials, jres.tile_trials)
    names = {"pallas": "cuda"}
    assert res.dispatched == tuple((k, names.get(v, v))
                                   for k, v in jres.dispatched)
    assert dict(res.dispatched) == {"apply": backend,
                                    "apply_batched": backend}
    assert tuned.device.type == CPU and tuned.backend_name == backend
    # a copy of the cached solver: the cache entry carries no result
    cached = FmmSolver.build(res.cfg, backend, CPU)
    assert tuned is not cached and cached.tune_result is None
    if tiles == "off":
        assert res.tile_trials == ()


def test_tuned_solver_computes_the_same_answer():
    """Shrunk caps drop nothing: the tuned phi is the untuned one's and
    within 1e-10 of the reference's tuned solver."""
    zb, qb = _batch(4)
    solver = FmmSolver.build(TCFG, "cuda", CPU)
    tuned = solver.tune(zb, qb)
    assert tuned.cfg.strong_cap <= TCFG.strong_cap
    assert tuned.cfg.weak_cap <= TCFG.weak_cap
    phi = tuned.apply(zb[0], qb[0])
    assert rel(phi, solver.apply(zb[0], qb[0])) <= TOL
    jtuned = JaxSolver.build(JCFG, "reference").tune(jnp.asarray(zb),
                                                     jnp.asarray(qb))
    assert rel(phi, np.asarray(jtuned.apply(jnp.asarray(zb[0]),
                                            jnp.asarray(qb[0])))) <= TOL


def test_tune_probes_through_the_backends_topology_hook():
    """Every probe (one per trial and row) builds through the solver's
    topology hook, once a tree level — on the card, one classify launch
    each."""
    calls = []
    base = get_backend("cuda")

    def classify(*args, **kwargs):
        calls.append(1)
        return base.leaf_classify(*args, **kwargs)

    register_backend(dataclasses.replace(base, name="cuda-counted",
                                         leaf_classify=classify))
    z, q = _sample("single")
    _, tiny = _cfgs("tiny")
    tuned = FmmSolver.build(tiny, "cuda-counted", CPU).tune(z, q)
    assert len(calls) == tiny.nlevels * len(tuned.tune_result.trials)
    assert len(tuned.tune_result.trials) >= 3
    zb, qb = _batch(2)
    calls.clear()
    res = FmmSolver.build(TCFG, "cuda-counted", CPU).tune(zb, qb).tune_result
    assert len(calls) == 2 * TCFG.nlevels * len(res.trials)
