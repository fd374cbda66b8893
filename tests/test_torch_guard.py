"""PyTorch port, guarded execution: the recovery ladder
(``repro_torch.solver.guard``) driven rung by rung by the fault injectors
of ``repro_torch.testing``, held to the JAX reference's ``GuardedSolver``
and injectors on the same seeded numpy inputs (the twins of
``tests/test_guard.py`` and of ``tests/test_degenerate.py`` through the
guard). The port runs with ``device="cpu"``: its "cuda" backend runs the
kernel wrappers' plain versions. The reference's "pallas" backend (in
interpret mode) is the twin of the port's "cuda". Held: every attempt's
rung, caps, margins, overflow and flags equal, the final backend equal
up to the names ``pallas`` -> ``cuda``, phi within 1e-10 relative (f64).
"""
import contextlib
import dataclasses
import warnings

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.testing as jax_faults
from repro.core import direct_potential_numpy
from repro.errors import CapOverflowError as JaxCapOverflowError
from repro.errors import FmmError as JaxFmmError
from repro.errors import NonFiniteInputError as JaxNonFiniteInputError
from repro.errors import RecoveryExhaustedError as JaxRecoveryExhaustedError
from repro.solver import FmmSolver as JaxSolver
from repro.solver import GuardedSolver as JaxGuarded
from repro.solver.guard import grow_caps as jax_grow_caps
import repro_torch.testing as faults
from repro_torch.errors import (BackendDowngradeWarning, CapOverflowError,
                                FmmError, NonFiniteInputError,
                                NonFiniteOutputError, RecoveryExhaustedError,
                                ShapeError)
from repro_torch.solver import (FmmSolver, GuardAttempt, GuardedSolver,
                                GuardReport, get_backend, register_backend)
from repro_torch.solver.guard import grow_caps

from _torch_parity import configs, inputs, rel

TOL = 1e-10
CPU = "cpu"
# the reference tests' CFG (tests/test_guard.py, tests/test_degenerate.py)
JCFG, TCFG = configs(n=256, nlevels=2, p=12, dtype="f64",
                     strong_cap=32, weak_cap=64)
# the reference's backend names -> the port's
NAMES = {"pallas": "cuda", "pallas+ref-eval": "cuda+ref-eval"}


def _problem(seed=3, dist="normal"):
    return inputs(dist, TCFG.n, seed)


def _rung(r, names):
    head, _, be = r.partition(":")
    return f"degrade:{names.get(be, be)}" if head == "degrade" else r


def _attempts(report, names=None):
    """Every field of every attempt but the note, backend names mapped
    (in the degrade rungs' names too)."""
    names = names or {}
    return [(_rung(a.rung, names), names.get(a.backend, a.backend),
             a.strong_cap, a.weak_cap, a.ok, a.overflow, a.margins,
             a.nonfinite_input, a.nonfinite_output) for a in report.attempts]


def _same_walk(rep, jrep, names=NAMES):
    assert _attempts(rep) == _attempts(jrep, names)
    assert rep.final_backend == names.get(jrep.final_backend,
                                          jrep.final_backend)
    assert rep.final_rung == _rung(jrep.final_rung, names)
    assert rep.degradations == tuple(_rung(r, names)
                                     for r in jrep.degradations)
    assert (rep.entry, rep.ok, rep.retries) == (jrep.entry, jrep.ok,
                                                jrep.retries)


# ---------------------------------------------------------------------------
# every injector walks the reference's rungs
# ---------------------------------------------------------------------------

DOUBLINGS = {"healthy": 2, "truncate": 2, "nan": 2, "overflow": 1}
RUNGS = {"healthy": ["primary"], "truncate": ["primary", "caps*64/64"],
         "nan": ["primary", "degrade:cuda+ref-eval"],
         "overflow": ["primary", "caps*64/128", "direct"]}


def _fault(mod, case, backend):
    if case == "truncate":           # strong margin 16 < 20
        return mod.truncate_interaction_lists(drop=20)
    if case == "overflow":
        return mod.force_cap_overflow(strong=1, weak=1)
    if case == "nan":
        return mod.nan_coefficients(backend, "eval_fused")
    return contextlib.nullcontext()


_JAX_WALKS: dict = {}


def _jax_walk(case, backend):
    """The reference's walk (memoized: its solvers compile per fault)."""
    if (case, backend) not in _JAX_WALKS:
        z, q = _problem()
        with _fault(jax_faults, case, backend):
            g = JaxGuarded(JCFG, backend, max_cap_doublings=DOUBLINGS[case])
            phi, rep = g.apply_guarded(jnp.asarray(z), jnp.asarray(q))
        _JAX_WALKS[case, backend] = (np.asarray(phi), rep, g.cfg)
    return _JAX_WALKS[case, backend]


@pytest.mark.parametrize("case,jax_backend,backend", [
    ("healthy", "reference", "reference"), ("healthy", "pallas", "cuda"),
    ("truncate", "reference", "reference"), ("truncate", "pallas", "cuda"),
    ("nan", "pallas", "cuda"),
    ("overflow", "reference", "reference"), ("overflow", "pallas", "cuda")])
def test_injector_walks_the_references_rungs(case, jax_backend, backend):
    jphi, jrep, jcfg = _jax_walk(case, jax_backend)
    z, q = _problem()
    with _fault(faults, case, backend):
        g = GuardedSolver(TCFG, backend, max_cap_doublings=DOUBLINGS[case],
                          device=CPU)
        phi, rep = g.apply_guarded(z, q)
        assert isinstance(rep, GuardReport)
        assert all(isinstance(a, GuardAttempt) for a in rep.attempts)
        assert [a.rung for a in rep.attempts] == RUNGS[case]
        _same_walk(rep, jrep)
        # a cap escalation promotes: the promoted solver serves healthily
        assert dataclasses.asdict(g.cfg) == dataclasses.asdict(jcfg)
        if case == "truncate":
            _, again = g.apply_guarded(z, q)
            assert again.retries == 0 and again.final_rung == "primary"
    assert phi.device.type == CPU and phi.shape == (TCFG.n,)
    assert rel(phi, jphi) <= TOL
    if case == "overflow":           # the direct rung: the exact oracle
        assert rel(phi, direct_potential_numpy(z, z, q)) <= TOL


@pytest.mark.parametrize("case", ["healthy", "truncate", "nan", "overflow"])
def test_rung_hook_sees_every_rung_and_changes_nothing(case):
    """``rung_hook`` is entered once around each rung, in the report's
    order, and leaves the walk and phi as they are without it. On the
    CPU the plain rungs do not warn (the warning is for the card)."""
    z, q = _problem()
    seen = []

    @contextlib.contextmanager
    def hook(rung):
        seen.append(("enter", rung))
        yield
        seen.append(("exit", rung))

    walks = []
    for kw in ({}, {"rung_hook": hook}):
        with _fault(faults, case, "cuda"), warnings.catch_warnings():
            warnings.simplefilter("error", BackendDowngradeWarning)
            g = GuardedSolver(TCFG, "cuda", device=CPU,
                              max_cap_doublings=DOUBLINGS[case], **kw)
            walks.append(g.apply_guarded(z, q))
    (phi, rep), (hphi, hrep) = walks
    assert [a.rung for a in hrep.attempts] == RUNGS[case]
    assert seen == [(e, r) for r in RUNGS[case] for e in ("enter", "exit")]
    assert _attempts(hrep) == _attempts(rep) and torch.equal(hphi, phi)
    seen.clear()
    with faults.truncate_interaction_lists(drop=20):
        g = GuardedSolver(TCFG, "cuda", device=CPU, rung_hook=hook)
        _, rep = g.refresh_guarded(z, q)
    assert [r for e, r in seen if e == "enter"] == [
        a.rung for a in rep.attempts] == ["primary", "caps*64/64"]


def test_healthy_guard_is_plain_apply():
    """On a healthy input the guard's phi is bitwise ``apply``'s."""
    z, q = _problem()
    phi, rep = GuardedSolver(TCFG, "cuda", device=CPU).apply_guarded(z, q)
    solver = FmmSolver.build(TCFG, "cuda", device=CPU)
    assert (phi == solver.apply(z, q)).all()
    assert rep.margins["strong"] >= 0 and "primary" in rep.summary()


@pytest.mark.parametrize("margins,weak_cap", [
    ({"strong": -2, "weak": 5, "p2p": 1, "p2l": 1, "m2p": 1}, 64),
    ({"strong": 3, "weak": -1, "p2p": 1, "p2l": 1, "m2p": 1}, 64),
    ({"strong": 3, "weak": 4, "p2p": 1, "p2l": -1, "m2p": 0}, 64),
    ({"strong": 3, "weak": -4, "p2p": 1, "p2l": 1, "m2p": -2}, 128),
    (None, 64), (None, 8 * 32)])
def test_grow_caps_matches_reference(margins, weak_cap):
    """Only the overflowed families double; weak clamps to 4*strong."""
    jcfg = dataclasses.replace(JCFG, weak_cap=weak_cap)
    tcfg = dataclasses.replace(TCFG, weak_cap=weak_cap)
    got = grow_caps(tcfg, margins)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jax_grow_caps(jcfg, margins))
    assert got.weak_cap <= 4 * got.strong_cap


# ---------------------------------------------------------------------------
# exhaustion and refusals: the typed errors
# ---------------------------------------------------------------------------

def test_exhaustion_raises_typed_error_with_report():
    z, q = _problem()
    with jax_faults.force_cap_overflow(strong=1, weak=1):
        g = JaxGuarded(JCFG, "reference", max_cap_doublings=1, direct=False)
        with pytest.raises(JaxRecoveryExhaustedError) as jei:
            g.apply_guarded(jnp.asarray(z), jnp.asarray(q))
    with faults.force_cap_overflow(strong=1, weak=1):
        g = GuardedSolver(TCFG, "reference", max_cap_doublings=1,
                          direct=False, device=CPU)
        with pytest.raises(RecoveryExhaustedError) as ei:
            g.apply_guarded(z, q)
    rep = ei.value.report
    assert isinstance(rep, GuardReport) and not rep.ok
    assert rep.attempts[-1].overflow > 0
    assert isinstance(ei.value, FmmError) and isinstance(ei.value,
                                                         RuntimeError)
    _same_walk(rep, jei.value.report)


@pytest.mark.parametrize("which", ["z", "q"])
def test_guard_refuses_nonfinite_input(which):
    z, q = _problem()
    args = {"z": z, "q": q}
    args[which] = faults.poison_input(args[which])
    assert np.isnan(args[which][0]) and not np.isnan(
        (z if which == "z" else q)[0])          # a copy was poisoned
    jg = JaxGuarded(JCFG, "reference")
    with pytest.raises(JaxNonFiniteInputError):
        jg.apply_guarded(jnp.asarray(args["z"]), jnp.asarray(args["q"]))
    g = GuardedSolver(TCFG, "cuda", device=CPU)
    with pytest.raises(NonFiniteInputError, match="NaN"):
        g.apply_guarded(args["z"], args["q"])


def test_apply_checked_raises_nonfinite_output_typed():
    z, q = _problem()
    with faults.nan_coefficients("cuda", "eval_fused"):
        solver = FmmSolver.build(TCFG, "cuda", device=CPU)
        with pytest.raises(NonFiniteOutputError, match="kernel"):
            solver.apply_checked(z, q)


def test_apply_checked_overflow_error_carries_margins():
    z, q = _problem(5)
    tiny = dict(strong_cap=2, weak_cap=2)
    with pytest.raises(JaxCapOverflowError) as jei:
        JaxSolver.build(dataclasses.replace(JCFG, **tiny),
                        "reference").apply_checked(jnp.asarray(z),
                                                   jnp.asarray(q))
    with pytest.raises(CapOverflowError) as ei:
        FmmSolver.build(dataclasses.replace(TCFG, **tiny), "cuda",
                        device=CPU).apply_checked(z, q)
    assert isinstance(ei.value, RuntimeError)
    assert (ei.value.margins, ei.value.overflow) == (jei.value.margins,
                                                     jei.value.overflow)
    assert min(ei.value.margins.values()) < 0


@pytest.mark.parametrize("phase", ["eval_fused", "p2l", "m2l_fused",
                                   "leaf_classify", "upward"])
def test_hook_exception_propagates_out_of_the_ladder(phase):
    """A hook that raises (a kernel that fails to build or launch) is not
    a rung: the exception leaves ``apply_guarded`` as it would leave
    ``apply``, with no walk to another backend or to the direct sum."""
    def broken(*args, **kwargs):
        raise RuntimeError(f"{phase}: launch failed")

    name = f"cuda-broken-{phase}"
    register_backend(dataclasses.replace(get_backend("cuda"), name=name,
                                         **{phase: broken}))
    z, q = _problem()
    g = GuardedSolver(TCFG, name, device=CPU)
    with pytest.raises(RuntimeError, match="launch failed") as ei:
        g.apply_guarded(z, q)
    assert not isinstance(ei.value, FmmError)


# ---------------------------------------------------------------------------
# batched entry, the time-stepping loop, the lattice warm-up
# ---------------------------------------------------------------------------

def _batch():
    zs, qs = zip(*(inputs("normal", TCFG.n, s) for s in (0, 1)))
    return np.stack(zs), np.stack(qs)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_apply_batched_guarded_escalates_whole_batch(backend):
    zb, qb = _batch()
    with jax_faults.truncate_interaction_lists(drop=20):
        jg = JaxGuarded(JCFG, "reference", max_cap_doublings=2)
        jphi, jrep = jg.apply_batched_guarded(jnp.asarray(zb),
                                              jnp.asarray(qb))
    with faults.truncate_interaction_lists(drop=20):
        g = GuardedSolver(TCFG, backend, max_cap_doublings=2, device=CPU)
        phi, rep = g.apply_batched_guarded(zb, qb)
    assert rep.entry == "apply_batched" and rep.ok and rep.retries >= 1
    assert rep.final_backend == backend
    _same_walk(rep, jrep, {"reference": backend})
    assert g.cfg.strong_cap > TCFG.strong_cap      # batch-wide promotion
    assert phi.shape == (2, TCFG.n)
    assert rel(phi, np.asarray(jphi)) <= TOL


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_refresh_guarded_replans_on_cap_drift(backend):
    """A drifted plan re-plans through escalation and promotes the
    solver: the next refresh is primary-healthy, and refresh +
    apply_plan matches the reference's."""
    z, q = _problem(7)
    kw = dict(strong_cap=4, weak_cap=0)
    jg = JaxGuarded(dataclasses.replace(JCFG, **kw), "reference",
                    max_cap_doublings=4)
    jplan, jrep = jg.refresh_guarded(jnp.asarray(z), jnp.asarray(q))
    g = GuardedSolver(dataclasses.replace(TCFG, **kw), backend,
                      max_cap_doublings=4, device=CPU)
    plan, rep = g.refresh_guarded(z, q)
    assert rep.entry == "refresh" and rep.ok and rep.retries >= 1
    _same_walk(rep, jrep, {"reference": backend})
    assert int(plan.conn.overflow) == 0
    assert dataclasses.asdict(g.cfg) == dataclasses.asdict(jg.cfg)
    phi = g.apply_plan(plan)
    assert rel(phi, np.asarray(jg.apply_plan(jplan))) <= TOL
    assert (phi == FmmSolver.build(g.cfg, backend, CPU).apply(z, q)).all()
    _, rep2 = g.refresh_guarded(z, q)
    assert rep2.retries == 0 and rep2.final_rung == "primary"


def test_refresh_guarded_exhaustion_raises_cap_overflow():
    z, q = _problem(7)
    with jax_faults.force_cap_overflow(strong=1, weak=1):
        jg = JaxGuarded(JCFG, "reference", max_cap_doublings=1)
        with pytest.raises(JaxCapOverflowError) as jei:
            jg.refresh_guarded(jnp.asarray(z), jnp.asarray(q))
    with faults.force_cap_overflow(strong=1, weak=1):
        g = GuardedSolver(TCFG, "cuda", max_cap_doublings=1, device=CPU)
        with pytest.raises(CapOverflowError, match="doubling") as ei:
            g.refresh_guarded(z, q)
    assert (ei.value.margins, ei.value.overflow) == (jei.value.margins,
                                                     jei.value.overflow)


def test_precompile_warms_the_rungs_the_reference_warms():
    z, q = _problem()
    small = dict(p=6)
    jg = JaxGuarded(dataclasses.replace(JCFG, **small), "reference",
                    max_cap_doublings=1)
    jwarmed = jg.precompile(jnp.asarray(z), jnp.asarray(q))
    g = GuardedSolver(dataclasses.replace(TCFG, **small), "reference",
                      max_cap_doublings=1, device=CPU)
    assert g.precompile(z, q) == jwarmed
    info = FmmSolver.cache_info()
    g.apply_guarded(z, q)
    assert FmmSolver.cache_info().misses == info.misses
    FmmSolver.build(grow_caps(g.cfg), "reference", CPU)   # a warmed rung
    assert FmmSolver.cache_info().hits == info.hits + 1
    gc = GuardedSolver(dataclasses.replace(TCFG, **small), "cuda",
                       max_cap_doublings=1, device=CPU)
    assert gc.precompile(z, q) == ["cuda@32/64", "cuda@64/128",
                                   "cuda+ref-eval@32/64",
                                   "reference@32/64"]


def test_solver_guarded_wraps_config_backend_and_device():
    z, q = _problem()
    solver = FmmSolver.build(TCFG, "cuda", device=CPU)
    g = solver.guarded(max_cap_doublings=1, direct=False)
    assert (g.cfg, g.backend_name, g.device.type) == (TCFG, "cuda", CPU)
    assert (g.max_cap_doublings, g.allow_direct) == (1, False)
    assert g.trace_counts is g.solver.trace_counts
    with pytest.raises(ValueError):
        solver.guarded(max_cap_doublings=-1)


# ---------------------------------------------------------------------------
# the degenerate layouts of tests/test_degenerate.py, through both guards
# ---------------------------------------------------------------------------

def _degenerate(case):
    rng = np.random.default_rng(7)
    n = TCFG.n
    if case == "all_coincident":
        return np.full(n, 0.3 + 0.7j), np.ones(n, np.complex128)
    if case == "one_distinct":
        z = np.full(n, 0.25 + 0.25j)
        z[0] = 0.75 + 0.75j
        return z, np.ones(n, np.complex128)
    if case == "collinear":
        return (rng.uniform(0, 1, n) + 0.4j,
                rng.normal(size=n) + 0j)
    if case == "empty_quadrants":
        return (rng.uniform(0, 0.25, n) + 1j * rng.uniform(0, 0.25, n),
                rng.normal(size=n) + 0j)
    if case.startswith("scale"):
        z, q = inputs("uniform", n, 42)
        return z * 10.0 ** float(case[5:]), q
    if case == "single_particle_like":
        z, _ = inputs("uniform", n, 7)
        return z, np.zeros(n, np.complex128)
    z, q = inputs("uniform", n, 1)                # nonsense shapes
    return z[:-1], q


@pytest.mark.parametrize("case,tol", [
    ("all_coincident", 0.0), ("one_distinct", 1e-10), ("collinear", 1e-5),
    ("empty_quadrants", 1e-5), ("scale-9", 1e-5), ("scale6", 1e-5),
    ("single_particle_like", 1e-14), ("nonsense_shapes", None)])
def test_degenerate_layouts_through_the_guard(case, tol):
    """Each layout ends as in the reference: the same rungs (the direct
    rung for coincident particles, whose FMM phi is non-finite), phi
    within 1e-10 of the reference's and at the reference test's bound
    of the numpy oracle — or the same typed refusal."""
    z, q = _degenerate(case)
    jg = JaxGuarded(JCFG, "reference", max_cap_doublings=2)
    g = GuardedSolver(TCFG, "reference", max_cap_doublings=2, device=CPU)
    if tol is None:
        with pytest.raises(JaxFmmError):
            jg.apply_guarded(jnp.asarray(z), jnp.asarray(q))
        with pytest.raises(ShapeError):
            g.apply_guarded(z, q)
        return
    jphi, jrep = jg.apply_guarded(jnp.asarray(z), jnp.asarray(q))
    phi, rep = g.apply_guarded(z, q)
    _same_walk(rep, jrep)
    assert bool(np.isfinite(phi.numpy()).all())
    jphi = np.asarray(jphi)
    assert np.abs(phi.numpy() - jphi).max() <= TOL * max(
        np.abs(jphi).max(), 1e-12)
    ref = direct_potential_numpy(z, z, q)
    assert np.abs(phi.numpy() - ref).max() <= tol * max(np.abs(ref).max(),
                                                        1e-12)
    if case == "all_coincident":
        assert rep.final_rung == "direct"
