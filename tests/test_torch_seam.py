"""PyTorch port, the solver seam: ``refresh``/``apply_plan``/``plan``/
``stats``, the plan cache's counters, ``trace_counts`` and the
batched-dispatch contract, each against the JAX reference's
``FmmSolver`` on its "reference" backend on the same seeded numpy inputs
(the twins of ``tests/test_solver.py``'s dispatch, refresh, stats and
cache tests). Tolerances: phi within 1e-10 relative in f64; plans,
lists, counts and stats exact."""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import connectivity_stats as jax_connectivity_stats
from repro.solver import FmmSolver as JaxSolver
from repro_torch.core import connectivity_stats
from repro_torch.core import fmm as F
from repro_torch.errors import BackendDowngradeWarning, ShapeError
from repro_torch.solver import (BATCHED_DISPATCH, Backend, CacheInfo,
                                FmmSolver, get_backend, register_backend)
from repro_torch.solver import backends as backends_mod
from repro_torch.solver import solver as solver_mod

from _torch_parity import configs, inputs, rel

TOL = 1e-10
# the reference tests' CFG64
JCFG, TCFG = configs(n=256, nlevels=2, p=10, dtype="f64")


def _perturbed(z, seed, eps=1e-4):
    """``tests/test_solver.py:_perturbed``: positions moved by eps N(0, 1)
    per component, clamped to the unit square."""
    rng = np.random.default_rng(seed)
    zd = z + eps * (rng.normal(size=z.shape) + 1j * rng.normal(size=z.shape))
    return np.clip(zd.real, 0, 1) + 1j * np.clip(zd.imag, 0, 1)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_refresh_plus_apply_plan_is_apply(backend):
    """The seam runs exactly ``apply``'s calls: bitwise its phi, and the
    reference's refresh + apply_plan within 1e-10."""
    z, q = inputs("normal", TCFG.n, 7)
    solver = FmmSolver.build(TCFG, backend=backend, device="cpu")
    plan = solver.refresh(z, q)
    assert plan.tree.z.shape == (1, TCFG.n)
    phi = solver.apply_plan(plan)
    assert phi.shape == (TCFG.n,)
    assert torch.equal(phi, solver.apply(z, q))
    jsolver = JaxSolver.build(JCFG, "reference")
    ref = np.asarray(jsolver.apply_plan(jsolver.refresh(z, q)))
    assert rel(phi, ref) <= TOL
    # ``plan`` is ``refresh``: the same lists as the reference's plan
    jplan = jsolver.plan(z, q)
    for a, b in zip(solver.plan(z, q).conn.weak, jplan.conn.weak):
        assert np.array_equal(a[0].numpy(), np.asarray(b))


def test_refresh_steps_prepare_once_and_a_new_batch_raises_the_count():
    """Three time steps on moved particles prepare the build and the
    evaluation once each (the reference: traced once each); a new
    problem shape (B = 2) prepares both again; calls are not counted."""
    z, q = inputs("uniform", TCFG.n, 8)
    solver = FmmSolver(TCFG, "cuda", device="cpu")   # fresh counters
    assert solver.trace_counts == {"build": 0, "evaluate": 0}
    jsolver = JaxSolver(JCFG, "reference")
    for step in range(3):
        zs = _perturbed(z, step)
        plan = solver.refresh(zs, q)
        phi = solver.apply_plan(plan)
        assert int(plan.conn.overflow) == 0
        jplan = jsolver.refresh(zs, q)
        assert np.array_equal(plan.tree.perm[0].numpy(),
                              np.asarray(jplan.tree.perm))
        assert rel(phi, np.asarray(jsolver.apply_plan(jplan))) <= TOL
    assert solver.trace_counts == {"build": 1, "evaluate": 1}
    assert jsolver.trace_counts == {"build": 1, "evaluate": 1}
    solver.apply(z, q)                                # same shape
    assert solver.trace_counts == {"build": 1, "evaluate": 1}
    zb = np.stack([z, _perturbed(z, 9)])
    solver.apply_batched(zb, np.stack([q, q]))
    assert solver.trace_counts == {"build": 2, "evaluate": 2}
    solver.apply_batched(zb, np.stack([q, q]))
    assert solver.trace_counts == {"build": 2, "evaluate": 2}


def test_refresh_and_apply_plan_validate_shapes():
    solver = FmmSolver.build(TCFG, device="cpu")
    z, q = inputs("uniform", TCFG.n, 9)
    with pytest.raises(ShapeError, match="refresh"):
        solver.refresh(z[:TCFG.n // 2], q[:TCFG.n // 2])
    with pytest.raises(ShapeError, match="refresh wants"):
        solver.refresh(z[None], q[None])
    with pytest.raises(ValueError, match="refresh wants"):
        solver.plan(z, q[:-3])
    other = FmmSolver.build(dataclasses.replace(TCFG, n=128), device="cpu")
    with pytest.raises(ShapeError, match="apply_plan wants"):
        other.apply_plan(solver.refresh(z, q))


def test_refresh_overflow_monitors_cap_drift():
    """A tight strong_cap shows in the plan's overflow scalar, the
    reference's count exactly."""
    z, q = inputs("normal", 256, 10)
    jtight, tight = (dataclasses.replace(c, strong_cap=2, weak_cap=0)
                     for c in (JCFG, TCFG))
    plan = FmmSolver.build(tight, backend="cuda", device="cpu").refresh(z, q)
    assert int(plan.conn.overflow) > 0
    jplan = JaxSolver.build(jtight, "reference").refresh(z, q)
    assert int(plan.conn.overflow) == int(jplan.conn.overflow)
    assert plan.conn.margins[0].tolist() == np.asarray(
        jplan.conn.margins).tolist()


@pytest.mark.parametrize("dist,strong_cap", [("uniform", 48), ("normal", 48),
                                             ("normal", 4)])
def test_stats_equal_the_references(dist, strong_cap):
    jcfg, tcfg = (dataclasses.replace(c, strong_cap=strong_cap, weak_cap=0)
                  for c in (JCFG, TCFG))
    z, q = inputs(dist, tcfg.n, 1)
    got = FmmSolver.build(tcfg, backend="cuda", device="cpu").stats(z, q)
    want = JaxSolver.build(jcfg, "reference").stats(z, q)
    assert got == want
    assert (got["overflow"] > 0) == (strong_cap == 4)
    assert got["p2p_pairs"] > 0


def test_stats_of_a_batch_sum_counts_and_take_the_worst_row():
    """B > 1: pair counts summed over the problems, row maxima and
    overflow the largest, margins the smallest per class."""
    tight = dataclasses.replace(TCFG, strong_cap=6, weak_cap=0)
    probs = [inputs(d, tight.n, 3) for d in ("uniform", "normal")]
    plan = F.fmm_build(torch.from_numpy(np.stack([z for z, _ in probs])),
                       torch.from_numpy(np.stack([q for _, q in probs])),
                       tight)
    rows = [connectivity_stats(F.fmm_build(torch.from_numpy(z)[None],
                                           torch.from_numpy(q)[None],
                                           tight).conn)
            for z, q in probs]
    got = connectivity_stats(plan.conn)
    for k in ("m2l_pairs", "p2p_pairs", "p2l_pairs", "m2p_pairs"):
        assert got[k] == sum(r[k] for r in rows)
    for k in ("strong_max", "weak_max", "overflow"):
        assert got[k] == max(r[k] for r in rows)
    assert got["margins"] == {c: min(r["margins"][c] for r in rows)
                              for c in got["margins"]}
    assert rows[0]["overflow"] != rows[1]["overflow"]
    # one row of the reference's plan: its own dict
    jcfg = dataclasses.replace(JCFG, strong_cap=6, weak_cap=0)
    jstats = jax_connectivity_stats(
        JaxSolver.build(jcfg, "reference").plan(*probs[1]).conn)
    assert rows[1] == jstats


def test_cache_info_counts_hits_misses_and_evictions(monkeypatch):
    FmmSolver.cache_clear()
    monkeypatch.setattr(solver_mod, "_CACHE_MAX", 2)
    cfgs = [dataclasses.replace(TCFG, p=p) for p in (3, 4, 5)]
    a = FmmSolver.build(cfgs[0], device="cpu")
    assert FmmSolver.build(cfgs[0], device="cpu") is a          # hit
    FmmSolver.build(cfgs[1], device="cpu")
    FmmSolver.build(cfgs[2], device="cpu")                      # evicts a
    info = FmmSolver.cache_info()
    assert isinstance(info, CacheInfo)
    assert info.hits == 1 and info.misses == 3
    assert info.evictions == 1 and info.currsize == 2 == info.maxsize
    assert FmmSolver.cache_size() == 2
    # the evicted solver builds anew; the old one stays usable
    assert FmmSolver.build(cfgs[0], device="cpu") is not a
    assert FmmSolver.cache_info().misses == 4
    z, q = inputs("uniform", TCFG.n, 2)
    assert a.apply(z, q).shape == (TCFG.n,)
    FmmSolver.cache_clear()
    zeroed = FmmSolver.cache_info()
    assert (zeroed.hits, zeroed.misses, zeroed.evictions,
            zeroed.currsize) == (0, 0, 0, 0)


def test_fallback_backend_downgrades_batches_and_warns_once():
    """A backend that cannot serve batches declares "fallback": its
    batches run the reference hooks, recorded in ``dispatched``, with
    one ``BackendDowngradeWarning`` per solver."""
    register_backend(Backend(name="unbatchable",
                             batched_dispatch="fallback"))
    try:
        solver = FmmSolver(TCFG, "unbatchable", device="cpu")
        assert solver.dispatched == {"apply": "unbatchable",
                                     "apply_batched": "reference"}
        probs = [inputs("uniform", TCFG.n, s) for s in (0, 1)]
        zb = np.stack([z for z, _ in probs])
        qb = np.stack([q for _, q in probs])
        with pytest.warns(BackendDowngradeWarning,
                          match="apply_batched dispatches") as rec:
            phib = solver.apply_batched(zb, qb)
        assert len(rec) == 1
        with warnings.catch_warnings():            # silent on repeat
            warnings.simplefilter("error")
            again = solver.apply_batched_checked(zb, qb)
        assert torch.equal(phib, again)
        ref = FmmSolver.build(TCFG, backend="reference", device="cpu")
        assert torch.equal(phib, ref.apply_batched(zb, qb))
        jref = np.asarray(JaxSolver.build(JCFG, "reference").apply_batched(
            zb, qb))
        assert rel(phib, jref) <= TOL
    finally:
        backends_mod._REGISTRY.pop("unbatchable", None)


def test_backend_rejects_unknown_batched_dispatch():
    assert BATCHED_DISPATCH == ("native", "vmap", "fallback")
    with pytest.raises(ValueError, match="batched_dispatch"):
        Backend(name="bogus", batched_dispatch="maybe")


def test_unsupported_config_is_refused():
    class NoLog(Backend):
        def supports(self, cfg):
            return cfg.kernel != "log"

    register_backend(NoLog(name="nolog"))
    try:
        FmmSolver(TCFG, "nolog", device="cpu")
        with pytest.raises(NotImplementedError, match="nolog"):
            FmmSolver(dataclasses.replace(TCFG, kernel="log"), "nolog",
                      device="cpu")
    finally:
        backends_mod._REGISTRY.pop("nolog", None)


def test_cuda_backend_is_batch_native_and_never_warns():
    """"cuda" declares "native" (the B axis goes into each launch),
    "reference" the default "vmap"; neither downgrades."""
    cpu = torch.device("cpu")
    assert get_backend("cuda", cpu).batched_dispatch == "native"
    assert get_backend("reference", cpu).batched_dispatch == "vmap"
    assert all(get_backend(n, cpu).supports(TCFG)
               for n in ("cuda", "reference"))
    solver = FmmSolver.build(TCFG, backend="cuda", device="cpu")
    assert solver.dispatched == {"apply": "cuda", "apply_batched": "cuda"}
    probs = [inputs(d, TCFG.n, 4) for d in ("uniform", "layer")]
    zb = np.stack([z for z, _ in probs])
    qb = np.stack([q for _, q in probs])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        phib = solver.apply_batched(zb, qb)
    jref = np.asarray(JaxSolver.build(JCFG, "reference").apply_batched(zb, qb))
    assert rel(phib, jref) <= TOL
