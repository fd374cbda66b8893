"""PyTorch port, the serving plane (``repro_torch.serve``,
``repro_torch.testing.serve_faults``, ``repro_torch.launch.runtime.
StragglerMonitor``) held to the JAX reference's on the same seeded numpy
inputs: the twin of ``tests/test_serve.py``. The port runs with
``device="cpu"``, on its "cuda" backend (the kernel wrappers' plain
versions) and on "reference"; the reference runs on "reference". Both
planes get the same counting clock and a no-op sleep, so every
``ServeReport`` field compares equal, ``latency_s`` included (backend
names mapped: the reference's "reference" is the port's plane backend);
phi agrees within 1e-10 relative (f64). Also held: ``pad_problem`` bit
for bit, the cache counters, the injectors, the shed ladder (which no
reference test drives) and the port's one departure there: an untyped
error (a kernel that fails to build or launch) leaves ``serve``, where
the reference sheds it.
"""
import dataclasses
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.serve as jax_serve
import repro.testing.serve_faults as jax_faults
from repro.configs.fmm2d import fmm_config as jax_fmm_config
from repro.data.synthetic import ragged_requests as jax_ragged
from repro.errors import RecoveryExhaustedError as JaxRecoveryExhausted
from repro.launch.runtime import StragglerMonitor as JaxMonitor
from repro.solver import FmmSolver as JaxSolver
from repro.solver import GuardedSolver as JaxGuarded
import repro_torch.serve as serve
import repro_torch.testing.serve_faults as faults
from repro_torch.configs import fmm_config
from repro_torch.data import ragged_requests
from repro_torch.errors import (BackendDowngradeWarning,
                                DeviceUnavailableError, FmmError,
                                RecoveryExhaustedError, ShapeError)
from repro_torch.launch import StragglerMonitor
from repro_torch.solver import FmmSolver, GuardedSolver

from _torch_parity import inputs

TOL = 1e-10
CPU = "cpu"
SIZES = (32, 64, 128)


def _cheap(fmm_cfg):
    """The reference tests' cheap config (p = 6, f64, caps 48/96)."""
    return lambda n: dataclasses.replace(fmm_cfg(n, p=6, dtype="f64"),
                                         strong_cap=48, weak_cap=96)


class _Clock:
    """A clock that ticks ``step`` a call; ``sleep`` advances it."""

    def __init__(self, step=1e-3):
        self.now, self.step = 0.0, step

    def __call__(self):
        self.now += self.step
        return self.now

    def sleep(self, s):
        self.now += s


def _planes(backend, step=1e-3, **kw):
    """(the reference's plane on "reference", the port's on ``backend``
    on the CPU), on the lattice 32/64/128, each with its own counting
    clock ticking ``step`` a call."""
    kw = {"max_batch": 4, "direct_max": 512, **kw}
    planes = []
    for mod, fmm_cfg, extra in (
            (jax_serve, jax_fmm_config, {"backend": "reference"}),
            (serve, fmm_config, {"backend": backend, "device": CPU})):
        clock = _Clock(step)
        planes.append(mod.ServePlane(
            mod.BucketLattice(sizes=SIZES), cfg_factory=_cheap(fmm_cfg),
            clock=clock, sleep=clock.sleep, **extra, **kw))
    return tuple(planes)


def _expected(jrep, backend):
    """The reference's report as the port's plane on ``backend`` gives
    it: the reference's primary backend is the port's ``backend``; the
    shed ladder's "reference" rung and the direct sum keep their names."""
    fields = dataclasses.asdict(jrep)
    if (fields["backend"] == "reference"
            and "shed:reference" not in fields["path"]):
        fields["backend"] = backend
    return fields


def _same_results(results, jresults, backend):
    assert len(results) == len(jresults)
    for (phi, rep), (jphi, jrep) in zip(results, jresults):
        assert dataclasses.asdict(rep) == _expected(jrep, backend)
        assert (phi is None) == (jphi is None)
        if phi is not None:
            jphi = np.asarray(jphi)
            assert phi.shape == jphi.shape == (rep.n,)
            assert np.abs(phi - jphi).max() <= TOL * np.abs(jphi).max()


def _stats(plane) -> dict:
    """``plane.stats()``, its median dispatch seconds as text (NaN before
    the monitor has a sample), so two planes' stats compare equal."""
    return {**plane.stats(),
            "dispatch_median_s": repr(plane.stats()["dispatch_median_s"])}


def _serve_both(jplane, plane, requests):
    """Both planes serve the same numpy requests; the port's without a
    ``BackendDowngradeWarning`` (nothing warns on the CPU)."""
    jresults = jplane.serve([jax_serve.Request(*r) for r in requests])
    with warnings.catch_warnings():
        warnings.simplefilter("error", BackendDowngradeWarning)
        results = plane.serve([serve.Request(*r) for r in requests])
    return results, jresults


# ---------------------------------------------------------------------------
# bucket lattice and padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_min,n_max,factor", [
    (64, 1024, 2.0), (64, 1 << 14, 2.0), (100, 5000, 1.5), (4, 9, 1.01)])
def test_lattice_geometry_and_lookups_match_reference(n_min, n_max, factor):
    lat = serve.BucketLattice.geometric(n_min, n_max, factor)
    jlat = jax_serve.BucketLattice.geometric(n_min, n_max, factor)
    assert lat.sizes == jlat.sizes and lat.max_size == jlat.max_size
    for n in range(1, lat.max_size + 3):
        assert lat.bucket_for(n) == jlat.bucket_for(n)
    for s in lat.sizes:
        assert lat.next_larger(s) == jlat.next_larger(s)
    with pytest.raises(ValueError):
        lat.bucket_for(0)
    for bad in ((64, 64), (128, 64), (2, 8), ()):
        with pytest.raises(ValueError):
            serve.BucketLattice(sizes=bad)
    with pytest.raises(ValueError):
        serve.BucketLattice.geometric(64, 128, factor=1.0)


def _pad_input(case):
    if case == "uniform":
        return inputs("uniform", 50, 0)
    if case == "coincident":            # zero-width box both ways
        return np.full(8, 0.25 + 0.25j), np.ones(8) + 0j
    if case == "collinear":             # zero-width box in x
        z, q = inputs("uniform", 20, 1)
        return 0.5 + 1j * z.imag, q.real            # real q, complex z
    raise ValueError(case)


@pytest.mark.parametrize("case,size,seed", [
    ("uniform", 64, 0), ("uniform", 256, 3), ("coincident", 32, 0),
    ("coincident", 512, 1), ("collinear", 64, 0)])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
def test_pad_problem_is_bit_identical_to_reference(case, size, seed, dtype):
    z, q = _pad_input(case)
    zp, qp = serve.pad_problem(z, q, size, seed=seed, dtype=dtype)
    jzp, jqp = jax_serve.pad_problem(z, q, size, seed=seed, dtype=dtype)
    for a, b in ((zp, jzp), (qp, jqp)):
        assert a.dtype == b.dtype and a.shape == b.shape == (size,)
        assert a.tobytes() == b.tobytes()
    n = z.size
    assert zp[:n].tobytes() == z.tobytes()
    assert not np.any(qp[n:])
    # no tail point coincides with a real point or another, after the
    # narrowing to the compute dtype
    tail = zp[n:].astype(dtype)
    assert np.unique(tail).size == tail.size
    assert not np.isin(tail, z.astype(dtype)).any()
    assert np.array_equal(serve.unpad(zp[None], n)[0], z)


def test_pad_problem_rejects_after_the_f32_narrowing():
    """On a box 1e-6 wide, tails distinct in f64 collide in f32: the
    padding compared in f64 keeps such pairs, the padding compared in the
    compute dtype (complex64) does not — as the reference's."""
    z, q = _pad_input("coincident")
    wide, _ = serve.pad_problem(z, q, 512)
    narrow, _ = serve.pad_problem(z, q, 512, dtype=np.complex64)
    assert np.unique(wide[8:].astype(np.complex64)).size < 504
    assert np.unique(narrow[8:].astype(np.complex64)).size == 504
    with pytest.raises(ShapeError):
        serve.pad_problem(z, q, 4)
    with pytest.raises(ShapeError):
        serve.pad_problem(z[None], q[None], 32)


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("seed", [0, 3])
def test_bucket_boundary_parity(delta, seed):
    """Padded bucket evaluation matches the unpadded apply at <= 1e-10
    (f64, p = 30) for N on a bucket edge and edge +- 1
    (``tests/test_serve.py:101``), and the port's padded apply matches the
    reference's on the same padded input."""
    edge = 64
    n = edge + delta
    z, q = inputs("uniform", n, seed)
    bucket = serve.BucketLattice(sizes=(edge, 2 * edge)).bucket_for(n)
    cfg_pad = fmm_config(bucket, p=30, dtype="f64")
    zp, qp = serve.pad_problem(z, q, bucket, dtype=cfg_pad.complex_dtype)

    phi = FmmSolver.build(fmm_config(n, p=30, dtype="f64"), "cuda",
                          CPU).apply(z, q).numpy()
    phi_pad = serve.unpad(FmmSolver.build(cfg_pad, "cuda", CPU)
                          .apply(zp, qp).numpy(), n)
    jphi_pad = np.asarray(JaxSolver.build(
        jax_fmm_config(bucket, p=30, dtype="f64"), "reference").apply(
            jnp.asarray(zp), jnp.asarray(qp)))[:n]
    scale = np.abs(phi).max()
    assert np.abs(phi_pad - phi).max() <= TOL * scale
    assert np.abs(phi_pad - jphi_pad).max() <= TOL * scale


# ---------------------------------------------------------------------------
# keyed solver cache
# ---------------------------------------------------------------------------

def test_plan_cache_counters_eviction_and_identity_match_reference():
    cache = serve.PlanCache(_cheap(fmm_config), "cuda", max_entries=2,
                            device=CPU)
    jcache = jax_serve.PlanCache(_cheap(jax_fmm_config), "reference",
                                 max_entries=2)
    seq = [(32, 1), (32, 1), (64, 1), (128, 1), (32, 1), (64, 2), (64, 2)]
    got, jgot = [], []
    for key in seq:
        got.append(cache.get(*key))
        jgot.append(jcache.get(*key))
        assert cache.info() == jcache.info() and len(cache) == len(jcache)
    assert [h for _, h in got] == [h for _, h in jgot]
    # a hit returns the same guarded solver; an evicted key a new one
    assert got[1][0] is got[0][0] and got[4][0] is not got[0][0]
    assert got[6][0] is got[5][0]
    assert all(g.device.type == "cpu" and isinstance(g, GuardedSolver)
               for g, _ in got)
    assert cache.entry(128, 1) is None and jcache.entry(128, 1) is None
    cache.clear()
    assert len(cache) == 0 and cache.info() == {}
    with pytest.raises(ValueError):
        serve.PlanCache(_cheap(fmm_config), max_entries=0, device=CPU)


def test_plan_cache_warm_prepares_each_width_once():
    """``warm`` runs the batched health entry point: the entry's solver
    has prepared each half once for the warmed width (the port's
    counterpart of the reference's compiled-program count), a second
    width prepares once more, and warming again prepares nothing."""
    FmmSolver.cache_clear()
    cache = serve.PlanCache(_cheap(fmm_config), "cuda", max_entries=4,
                            device=CPU)
    jcache = jax_serve.PlanCache(_cheap(jax_fmm_config), "reference",
                                 max_entries=4)
    assert cache.warm_all([32], [1]) == jcache.warm_all([32], [1])
    assert cache.entry(32, 1).trace_counts == {"build": 1, "evaluate": 1}
    assert cache.warm_all([32], [1, 2]) == jcache.warm_all([32], [1, 2])
    assert cache.entry(32, 2).trace_counts == {"build": 2, "evaluate": 2}
    assert cache.entry(32, 2).solver is cache.entry(32, 1).solver
    assert jcache.entry(32, 2).solver._compiled_program_count() >= 1
    assert cache.info() == jcache.info()


# ---------------------------------------------------------------------------
# the plane: admission, dispatch, degradation — wave for wave
# ---------------------------------------------------------------------------

def _mixed_wave():
    """The wave of ``tests/test_serve.py:163``."""
    zp, qp = inputs("uniform", 20, 4)
    qp = qp.copy()
    qp[0] = np.nan
    return [inputs("uniform", 30, 1), inputs("uniform", 64, 2),
            inputs("uniform", 200, 3),            # oversize -> direct
            (zp, qp),                             # poison
            (np.linspace(0, 1, 16), np.ones(16) + 0j),   # real z
            inputs("uniform", 2000, 5),           # way oversize
            (np.ones((2, 3)) + 0j, np.ones((2, 3)) + 0j)]


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_mixed_wave_matches_reference(backend):
    jplane, plane = _planes(backend)
    results, jresults = _serve_both(jplane, plane, _mixed_wave())
    _same_results(results, jresults, backend)
    stat = [r.report.status for r in results]
    assert stat == ["ok", "ok", "degraded", "rejected", "rejected",
                    "rejected", "rejected"]
    assert [r.report.error for r in results[3:]] == [
        "NonFiniteInputError", "DTypeError", "OversizedRequestError",
        "ShapeError"]
    assert results[2].report.backend == "direct"
    assert _stats(plane) == _stats(jplane)
    assert results[0].report.summary().startswith("[serve:req0]")


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_ragged_wave_matches_reference(backend):
    """A ragged stream with poison, served twice on one plane (the replay
    finds every shape class cached), one request a ``rid`` of its own."""
    jplane, plane = _planes(backend)
    for seed in (5, 5):
        gen = [(z, q) for _, z, q, _ in ragged_requests(
            10, seed=seed, median_n=40, sigma=0.6, n_max=300,
            poison_rate=0.3)]
        jgen = [(np.asarray(z), np.asarray(q)) for _, z, q, _ in jax_ragged(
            10, seed=seed, median_n=40, sigma=0.6, n_max=300,
            poison_rate=0.3)]
        for (z, q), (jz, jq) in zip(gen, jgen):
            assert z.tobytes() == jz.tobytes() and q.tobytes() == jq.tobytes()
        reqs = [(z, q, None, 100 + i if i == 3 else None)
                for i, (z, q) in enumerate(gen)]
        results, jresults = _serve_both(jplane, plane, reqs)
        _same_results(results, jresults, backend)
    assert _stats(plane) == _stats(jplane)
    assert {r.report.status for r in results} <= {"ok", "rejected",
                                                 "degraded"}
    assert all(r.report.cache == "hit" for r in results
               if r.report.bucket is not None and r.phi is not None)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_deadline_wave_matches_reference(backend):
    """A clock that jumps far past any budget: every request sheds as
    ``DeadlineExceededError``; a per-request budget overrides the
    default."""
    jplane, plane = _planes(backend, step=10.0, default_deadline_s=1.0)
    reqs = [inputs("uniform", 20, i) for i in range(3)]
    reqs.append(inputs("uniform", 20, 9) + (1e9,))
    results, jresults = _serve_both(jplane, plane, reqs)
    _same_results(results, jresults, backend)
    for phi, rep in results[:3]:
        assert phi is None and rep.error == "DeadlineExceededError"
        assert rep.deadline_exceeded
    assert results[3].report.status == "ok"
    assert _stats(plane) == _stats(jplane)


def test_straggler_monitor_records_as_reference():
    dts = [0.5, 0.01, 0.011, 0.012, 0.01, 0.013, 0.2, 0.011, 0.012, 0.5,
           0.01, 0.05, 0.04]
    mon, jmon = StragglerMonitor(window=8, threshold=3.0, warmup=1), \
        JaxMonitor(window=8, threshold=3.0, warmup=1)
    assert np.isnan(mon.median)
    assert ([mon.record(i, d) for i, d in enumerate(dts)]
            == [jmon.record(i, d) for i, d in enumerate(dts)])
    assert mon.slow_steps == jmon.slow_steps and mon.slow_steps
    assert mon.median == jmon.median and list(mon.times) == list(jmon.times)


def test_latency_spike_flags_a_slow_report_through_the_clock():
    """Every dispatch under ``latency_spike`` sleeps on the injected
    clock (no real sleep): the plane's straggler monitor flags it slow,
    in both packages alike."""
    jplane, plane = _planes("cuda", max_batch=1)
    jplane.monitor = JaxMonitor(window=16, threshold=10.0, warmup=1)
    plane.monitor = StragglerMonitor(window=16, threshold=10.0, warmup=1)
    real = GuardedSolver.apply_batched_guarded
    out = {}
    for p, inject in ((jplane, jax_faults), (plane, faults)):
        out[p] = [p.submit(*inputs("uniform", 20, 10 + i))
                  for i in range(7)]
        assert p.stats()["slow_dispatches"] == 0
        with inject.latency_spike(every=1, spike_s=0.5, sleep=p.clock.sleep):
            out[p].append(p.submit(*inputs("uniform", 20, 99)))
    _same_results(out[plane], out[jplane], "cuda")
    assert out[plane][-1].report.slow
    assert not any(r.report.slow for r in out[plane][:-1])
    assert _stats(plane) == _stats(jplane)
    assert plane.stats()["slow_dispatches"] == 1
    assert GuardedSolver.apply_batched_guarded is real


# ---------------------------------------------------------------------------
# the shed ladder (no reference test drives it)
# ---------------------------------------------------------------------------

class _Fail:
    """Make the guarded solvers of ``planes``' caches (the serving cache,
    and with ``ref`` the shed ladder's reference cache) raise ``exc``
    for the buckets in ``buckets``, in both entry points."""

    def __init__(self, cls, plane, buckets, exc, ref=False):
        self.cls, self.plane, self.buckets = cls, plane, set(buckets)
        self.exc, self.ref = exc, ref

    def _fails(self, g):
        caches = [self.plane.cache] + ([self.plane._ref_cache]
                                       if self.ref else [])
        return g.cfg.n in self.buckets and any(
            g is e for c in caches for e in c._entries.values())

    def __enter__(self):
        self.real = (self.cls.apply_batched_guarded, self.cls.apply_guarded)
        fail = self

        def wrap(real):
            def entry(g, z, q):
                if fail._fails(g):
                    raise fail.exc(f"injected fault at bucket {g.cfg.n}")
                return real(g, z, q)
            return entry

        self.cls.apply_batched_guarded = wrap(self.real[0])
        self.cls.apply_guarded = wrap(self.real[1])

    def __exit__(self, *exc):
        self.cls.apply_batched_guarded, self.cls.apply_guarded = self.real


SHED = {
    # failing buckets, reference cache too, the trail after the fault
    "bucket": ({32}, False, ["shed:bucket:64", "primary"]),
    "reference": ({32, 64}, False, [
        "shed:bucket:64", "failed:RecoveryExhaustedError", "shed:reference",
        "primary"]),
    "direct": ({32, 64}, True, [
        "shed:bucket:64", "failed:RecoveryExhaustedError", "shed:reference",
        "failed:RecoveryExhaustedError", "shed:direct", "direct"]),
}


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("walk", list(SHED))
def test_shed_ladder_matches_reference(walk, backend):
    """A typed fault of the batched dispatch (``RecoveryExhaustedError``)
    walks next-larger bucket -> reference backend -> direct, status
    "degraded", each step as the reference takes it."""
    buckets, ref, trail = SHED[walk]
    jplane, plane = _planes(backend)
    reqs = [inputs("uniform", 30, 1), inputs("uniform", 60, 2)]
    with _Fail(JaxGuarded, jplane, buckets, JaxRecoveryExhausted, ref):
        jresults = jplane.serve([jax_serve.Request(*r) for r in reqs])
    with _Fail(GuardedSolver, plane, buckets, RecoveryExhaustedError, ref), \
            warnings.catch_warnings():
        warnings.simplefilter("error", BackendDowngradeWarning)
        results = plane.serve([serve.Request(*r) for r in reqs])
    _same_results(results, jresults, backend)
    rep = results[0].report
    assert rep.status == "degraded"
    assert list(rep.path) == ["batch-fault:RecoveryExhaustedError"] + trail
    assert rep.backend == {"bucket": backend, "reference": "reference",
                           "direct": "direct"}[walk]
    assert _stats(plane) == _stats(jplane)
    assert plane.stats()["shed_walks"] == (1 if walk == "bucket" else 2)


def test_untyped_fault_leaves_serve_where_the_reference_sheds_it():
    """The port's departure: a ``RuntimeError`` out of the dispatch (what
    a kernel that fails to build or launch raises) is not shed to plain
    torch but leaves ``serve``; the reference sheds it to the next
    bucket and reports "degraded"."""
    jplane, plane = _planes("cuda")
    req = inputs("uniform", 30, 1)
    with _Fail(JaxGuarded, jplane, {32}, RuntimeError):
        (_, jrep), = jplane.serve([jax_serve.Request(*req)])
    assert jrep.status == "degraded"
    assert jrep.path[:2] == ("batch-fault:RuntimeError", "shed:bucket:64")
    with _Fail(GuardedSolver, plane, {32}, RuntimeError):
        with pytest.raises(RuntimeError, match="injected fault") as ei:
            plane.serve([serve.Request(*req)])
    assert not isinstance(ei.value, FmmError)
    assert plane.stats()["shed_walks"] == 0


# ---------------------------------------------------------------------------
# injectors, the soak, the device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", faults.POISON_KINDS)
def test_poison_request_matches_reference(kind):
    z, q = inputs("uniform", 12, 3)
    got = faults.poison_request(z, q, kind, idx=5)
    want = jax_faults.poison_request(z, q, kind, idx=5)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert np.array_equal(z, inputs("uniform", 12, 3)[0])
    with pytest.raises(ValueError):
        faults.poison_request(z, q, "bogus")


def test_cache_thrash_and_compile_storm_match_reference():
    jplane, plane = _planes("cuda")
    for p in (jplane, plane):
        for b in SIZES:
            p.cache.get(b, 1)
    with faults.cache_thrash(plane), jax_faults.cache_thrash(jplane):
        assert len(plane.cache) == len(jplane.cache) == 1
        assert plane.cache.info() == jplane.cache.info()
    assert plane.cache.max_entries == jplane.cache.max_entries == 16
    with faults.compile_storm(plane, step=16), \
            jax_faults.compile_storm(jplane, step=16):
        assert plane.lattice.sizes == jplane.lattice.sizes
        assert len(plane.lattice.sizes) > len(SIZES)
    assert plane.lattice.sizes == SIZES


def test_soak_passes_on_the_cpu():
    """``python -m repro_torch.testing.serve_faults --device cpu``: the
    five phases with the reference's gates, nothing raised, nothing
    warned (on the counting clock: the spikes advance it, not the
    host's load)."""
    lines, clock = [], _Clock()
    with warnings.catch_warnings():
        warnings.simplefilter("error", BackendDowngradeWarning)
        failures, served = faults.run_soak(CPU, log=lines.append,
                                           clock=clock, sleep=clock.sleep)
    assert failures == [], "\n".join(lines)
    phases = {p for p, _, _, _ in served}
    assert phases == {"poison-stream", "cache-thrash", "compile-storm",
                      "latency-spike", "deadline-pressure"}
    assert any(rep.path[:1] == ("oversize->direct",)
               for _, _, _, rep in served)


def test_plane_without_a_card_raises_when_built(monkeypatch):
    """The plane resolves its device when it is built: without a CUDA
    card the default raises there, not on each request."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        serve.ServePlane()
    with pytest.raises(DeviceUnavailableError):
        serve.PlanCache(serve.default_cfg_factory)
    plane = serve.ServePlane(device=CPU)
    assert plane.device.type == "cpu" and plane.cache.device.type == "cpu"
    assert plane.lattice.sizes == tuple(64 << k for k in range(9))
    cfg = serve.default_cfg_factory(2048)
    assert (cfg.dtype, cfg.p, cfg.strong_cap, cfg.weak_cap) == \
        ("f32", 17, 48, 128)
    assert cfg == dataclasses.replace(fmm_config(2048), strong_cap=48,
                                      weak_cap=128)
