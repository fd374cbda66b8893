"""PyTorch port, the compiled-program lifecycle: each solver entry point
runs as one program per problem shape (``repro_torch.solver.program``;
on the CPU the programs run eagerly), counted by
``_compiled_program_count`` and dropped by ``_release_executables``, held
step for step to the JAX reference's jitted programs
(``tests/test_solver.py``'s eviction test) on the same seeded numpy
inputs. Also: a second call copies nothing from the host (every device
constant is held by the programs — the CPU stand-in for "capturable"),
phi against the reference's before and after a release, and a solver
held across a connectivity fault. Tolerances: phi within 1e-12 of the
port's own ``fmm_potential``, 1e-10 relative of the reference's (f64);
program counts, trace counts and overflows exact."""
import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.testing as jax_faults
from repro.solver import FmmSolver as JaxSolver
from repro.solver import solver as jax_solver_mod
import repro_torch.testing as faults
from repro_torch.core import fmm as F
from repro_torch.core import fmm_potential
from repro_torch.core.topology import tree as tree_mod
from repro_torch.errors import ShapeError
from repro_torch.solver import FmmSolver
from repro_torch.solver import backends as backends_mod
from repro_torch.solver import program as program_mod
from repro_torch.solver import solver as solver_mod

from _torch_parity import configs, inputs, rel

TOL = 1e-10
# the reference tests' CFG64
JCFG, TCFG = configs(n=256, nlevels=2, p=10, dtype="f64")
BACKENDS = ["cuda", "reference"]


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("backend", BACKENDS)
def test_eviction_releases_programs_as_the_reference(monkeypatch, backend):
    """The twin of ``test_eviction_releases_compiled_programs``: with one
    cache slot, each step's program count is the reference's; eviction
    and ``cache_clear`` release, an evicted holder stays usable."""
    FmmSolver.cache_clear()
    JaxSolver.cache_clear()
    monkeypatch.setattr(solver_mod, "_CACHE_MAX", 1)
    monkeypatch.setattr(jax_solver_mod, "_CACHE_MAX", 1)
    (ja_cfg, a_cfg), (jb_cfg, b_cfg) = (
        configs(n=256, nlevels=2, p=p, dtype="f64") for p in (3, 4))
    z, q = inputs("uniform", TCFG.n, 1)
    jz, jq = jnp.asarray(z), jnp.asarray(q)

    def counts(port, ref):
        got = (port._compiled_program_count(), ref._compiled_program_count())
        assert got[0] == got[1], got
        return got[0]

    a = FmmSolver.build(a_cfg, backend, device="cpu")
    ja = JaxSolver.build(ja_cfg, "reference")
    a.apply(z, q)
    ja.apply(jz, jq)
    assert counts(a, ja) == 1
    a.apply_with_health(z, q)
    ja.apply_with_health(jz, jq)
    assert counts(a, ja) == 2

    FmmSolver.build(b_cfg, backend, device="cpu")          # evicts a
    JaxSolver.build(jb_cfg, "reference")
    assert FmmSolver.cache_info().evictions == 1
    assert counts(a, ja) == 0

    # the evicted instance stays usable: its next call captures again
    phi = a.apply(z, q)
    ja.apply(jz, jq)
    assert counts(a, ja) == 1
    own = fmm_potential(_t(z), _t(q), a_cfg)
    assert float((phi - own).abs().max()) <= 1e-12 * float(own.abs().max())

    b = FmmSolver.build(b_cfg, backend, device="cpu")
    jb = JaxSolver.build(jb_cfg, "reference")
    b.apply(z, q)
    jb.apply(jz, jq)
    assert counts(b, jb) == 1
    FmmSolver.cache_clear()
    JaxSolver.cache_clear()
    assert counts(b, jb) == 0
    assert counts(a, ja) == 1                  # uncached holder untouched


def test_a_program_per_entry_point_and_shape():
    """Six entry points, one program each per batch width; a second call
    at a shape runs the same program; ``copy.copy`` shares the programs.
    ``trace_counts`` counts shapes prepared, and a release keeps the
    prepared constants, so ``refresh`` then ``apply_plan`` after a
    release leave the port's counts as they were, where the reference's
    re-traces raise its counts by one each (a recorded departure)."""
    z, q = inputs("normal", TCFG.n, 2)
    zb, qb = np.stack([z, z[::-1]]), np.stack([q, q[::-1]])
    solver = FmmSolver(TCFG, "cuda", device="cpu")
    jsolver = JaxSolver(JCFG, "reference")
    for s in (solver, jsolver):
        s.apply(z, q)
        s.apply(z, q)
        s.apply_with_health(z, q)
        s.apply_batched(zb, qb)
        s.apply_batched_with_health(zb, qb)
        s.apply_plan(s.refresh(z, q))
    assert solver._compiled_program_count() == 6 == \
        jsolver._compiled_program_count()
    keys = {(e, b) for e, b, _, _ in solver.programs()}
    assert keys == {("apply", 1), ("apply_with_health", 1), ("refresh", 1),
                    ("apply_plan", 1), ("apply_batched", 2),
                    ("apply_batched_with_health", 2)}
    calls = {k[0]: p.calls for k, p in solver.programs().items()}
    assert calls["apply"] == 2 and calls["refresh"] == 1
    # a tuned-style shallow copy shares the programs (and their release)
    twin = copy.copy(solver)
    assert twin.programs() == solver.programs()
    assert solver.trace_counts == {"build": 2, "evaluate": 2}
    assert jsolver.trace_counts == {"build": 1, "evaluate": 1}
    for s in (solver, jsolver):
        s._release_executables()
        s.apply_plan(s.refresh(z, q))
    assert twin._compiled_program_count() == 2
    assert solver.trace_counts == {"build": 2, "evaluate": 2}
    assert jsolver.trace_counts == {"build": 2, "evaluate": 2}


def test_apply_plan_refuses_a_plan_of_other_shapes():
    """A program runs inputs of the shapes it was made for: a plan built
    at other caps is refused with a ``ShapeError``."""
    z, q = inputs("uniform", TCFG.n, 3)
    solver = FmmSolver(TCFG, "cuda", device="cpu")
    solver.apply_plan(solver.refresh(z, q))
    wide = FmmSolver(dataclasses.replace(TCFG, strong_cap=64), "cuda",
                     device="cpu")
    with pytest.raises(ShapeError, match="apply_plan"):
        solver.apply_plan(wide.refresh(z, q))


@pytest.mark.parametrize("backend", BACKENDS)
def test_second_calls_copy_nothing_from_the_host(monkeypatch, backend):
    """After one call of each entry point, with the constant caches'
    LRUs emptied and ``torch.as_tensor``, ``torch.from_numpy`` and
    ``torch.tensor`` raising, every entry point runs again from the
    constants its programs hold, bitwise as before."""
    z, q = (_t(a) for a in inputs("layer", TCFG.n, 4))
    zb, qb = torch.stack([z, z.flip(0)]), torch.stack([q, q.flip(0)])
    solver = FmmSolver(TCFG, backend, device="cpu")

    def run():
        plan = solver.refresh(z, q)
        return (solver.apply(z, q), solver.apply_with_health(z, q)[0],
                solver.apply_batched(zb, qb), solver.apply_plan(plan),
                plan.tree.perm, plan.conn.weak[-1])

    first = run()
    for cache in (tree_mod.leaf_layout, tree_mod.split_tables, F.m2l_mat):
        cache.cache_clear()

    def refuse(*args, **kwargs):
        raise AssertionError("a host copy on the program's path")

    for name in ("as_tensor", "from_numpy", "tensor"):
        monkeypatch.setattr(torch, name, refuse)
    second = run()
    monkeypatch.undo()
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert torch.equal(first[0], first[3])


@pytest.mark.parametrize("backend", BACKENDS)
def test_programs_match_the_reference_before_and_after_release(backend):
    """``apply``, ``apply_batched`` and ``refresh`` + ``apply_plan``
    within 1e-10 of the reference's, again after a release, and
    ``apply_plan`` of the reference's own plan via ``plan_from_numpy``."""
    from _torch_parity import shared_plan

    z, q = inputs("normal", TCFG.n, 5)
    zb, qb = np.stack([z, z[::-1]]), np.stack([q, q[::-1]])
    jsolver = JaxSolver.build(JCFG, "reference")
    ref = np.asarray(jsolver.apply(z, q))
    refb = np.asarray(jsolver.apply_batched(zb, qb))
    solver = FmmSolver.build(TCFG, backend, device="cpu")
    for _ in range(2):
        assert rel(solver.apply(z, q), ref) <= TOL
        assert rel(solver.apply_batched(zb, qb), refb) <= TOL
        assert rel(solver.apply_plan(solver.refresh(z, q)), ref) <= TOL
        solver._release_executables()
        assert solver._compiled_program_count() == 0
    jcfg, tcfg, jplan, plan = shared_plan("normal", n=TCFG.n, seed=5,
                                          nlevels=2, p=10, dtype="f64")
    fresh = FmmSolver(tcfg, backend, device="cpu")
    assert rel(fresh.apply_plan(plan),
               np.asarray(jsolver.apply_plan(jplan))) <= TOL


def test_a_held_solver_keeps_the_fault_it_captured():
    """A solver built before a ``truncate_interaction_lists`` context is
    released on entry and captures the fault at its next call; it is out
    of the cache at exit, so its programs keep the fault until released
    — exactly as the reference's held solver keeps the fault it traced.
    A solver built after the context sees none."""
    z, q = inputs("uniform", TCFG.n, 6)
    cfg = dataclasses.replace(TCFG, strong_cap=32, weak_cap=64)
    jcfg = dataclasses.replace(JCFG, strong_cap=32, weak_cap=64)
    FmmSolver.cache_clear()
    JaxSolver.cache_clear()
    solver = FmmSolver.build(cfg, "cuda", device="cpu")
    jsolver = JaxSolver.build(jcfg, "reference")

    def overflow():
        got = (int(solver.apply_with_health(z, q)[1].overflow[0]),
               int(jsolver.apply_with_health(z, q)[1].overflow))
        assert got[0] == got[1], got
        assert solver._compiled_program_count() == \
            jsolver._compiled_program_count()
        return got[0]

    assert overflow() == 0
    with faults.truncate_interaction_lists(drop=30), \
            jax_faults.truncate_interaction_lists(drop=30):
        inside = overflow()
    assert inside > 0
    assert overflow() == inside
    solver._release_executables()
    jsolver._release_executables()
    assert overflow() == 0
    fresh = FmmSolver.build(cfg, "cuda", device="cpu")
    assert int(fresh.apply_with_health(z, q)[1].overflow[0]) == 0
    # the port's phi under the fault is the reference's too
    with faults.truncate_interaction_lists(drop=30), \
            jax_faults.truncate_interaction_lists(drop=30):
        held = FmmSolver.build(cfg, "cuda", device="cpu")
        jheld = JaxSolver.build(jcfg, "reference")
        assert rel(held.apply(z, q), np.asarray(jheld.apply(z, q))) <= TOL


def test_program_counts_are_measured_at_the_first_run(monkeypatch):
    """A program keeps the launches its first run made, counted where the
    kernel wrapper launches, and counts its calls; on the CPU there is no
    capture, so nothing is recorded and nothing replays. The wrappers run
    their plain versions here and launch nothing, so a wrapper that
    counts stands in for the card."""
    from repro_torch.kernels.build import LIBRARIES

    real = LIBRARIES["m2l"].launches

    def counted(fn):
        def wrapper(*a, **k):
            LIBRARIES["m2l"].launches += 1
            return fn(*a, **k)
        return wrapper

    cuda = backends_mod.get_backend("cuda")
    be = dataclasses.replace(cuda, name="counted",
                             m2l_fused=counted(cuda.m2l_fused))
    monkeypatch.setitem(backends_mod._REGISTRY, "counted", be)
    z, q = inputs("uniform", TCFG.n, 7)
    solver = FmmSolver(TCFG, "counted", device="cpu")
    for _ in range(3):
        solver.apply(z, q)
    prog, = solver.programs().values()
    assert prog.launches == dict.fromkeys(LIBRARIES, 0) | {"m2l": 1}
    assert (prog.calls, prog.replays, prog.recorded) == (3, 0, {})
    assert not prog.captured
    assert LIBRARIES["m2l"].launches - real == 3


def test_memory_budget_releases_the_least_recently_run(monkeypatch):
    """When the pools charged to the programs of one device pass its
    budget, the sets run least recently are released until the rest fit
    — never the set that just grew — and a released solver stays usable.
    The charges stand in for a capture's pool growth, which only the card
    measures."""
    monkeypatch.setattr(program_mod, "_BUDGET", {})
    monkeypatch.setattr(program_mod, "_POOLED", program_mod.OrderedDict())
    monkeypatch.setattr(program_mod, "_RELEASED", {"sets": 0, "bytes": 0})
    cpu = torch.device("cpu")
    program_mod.set_program_budget(100, cpu)
    z, q = inputs("uniform", TCFG.n, 8)
    solvers = [FmmSolver(dataclasses.replace(TCFG, p=p), "cuda",
                         device="cpu") for p in (8, 9, 10)]
    phi = [s.apply(z, q) for s in solvers]
    sets = [s._programs for s in solvers]
    for s in sets:
        s.device = cpu
    sets[0].charge(60)
    sets[1].charge(30)
    assert [len(s) for s in sets] == [1, 1, 1]
    sets[0].touch()                       # sets[1] is now the oldest
    sets[2].charge(20)
    assert [len(s) for s in sets] == [1, 0, 1]
    assert program_mod.program_memory(cpu) == {
        "budget": 100, "held": 80, "solvers": 2, "released_sets": 1,
        "released_bytes": 30}
    sets[2].charge(200)                   # alone over budget: kept
    assert [len(s) for s in sets] == [0, 0, 1]
    assert program_mod.program_memory(cpu)["held"] == 220
    assert torch.equal(solvers[1].apply(z, q), phi[1])
    assert solvers[1]._compiled_program_count() == 1
    program_mod.set_program_budget(None, cpu)
    assert program_mod.program_budget(cpu) == 0
