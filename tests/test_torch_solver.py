"""PyTorch port, end to end: ``FmmSolver`` on the "cuda" backend with
``device="cpu"`` (every kernel wrapper runs its plain version) matches
the JAX reference's ``FmmSolver`` on its "reference" backend within
1e-10 in f64; ``apply_batched`` equals stacked ``apply`` calls; health,
validation and the plan cache behave as the reference's."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.solver import FmmSolver as JaxSolver
from repro_torch.core import fmm as F
from repro_torch.core.fmm import fmm_potential
from repro_torch.errors import (CapOverflowError, DTypeError,
                                NonFiniteInputError, ShapeError)
from repro_torch.solver import FmmSolver, host_health
from repro_torch.solver import solver as solver_mod

from _torch_parity import configs, inputs, rel

TOL = 1e-10

E2E = [("uniform", 1024, 3, "harmonic", True),
       ("normal", 1024, 3, "log", True),
       ("layer", 1024, 2, "harmonic", False),
       ("normal", 1024, 2, "log", False),
       ("uniform", 100, 0, "harmonic", True)]


@pytest.mark.parametrize("dist,n,levels,kernel,use_p2l_m2p", E2E)
def test_apply_matches_reference_solver(dist, n, levels, kernel,
                                        use_p2l_m2p):
    jcfg, tcfg = configs(n=n, nlevels=levels, p=17, dtype="f64",
                         kernel=kernel, use_p2l_m2p=use_p2l_m2p)
    z, q = inputs(dist, n, seed=levels)
    ref = np.asarray(JaxSolver.build(jcfg, backend="reference").apply(z, q))
    solver = FmmSolver.build(tcfg, backend="cuda", device="cpu")
    assert solver.dispatched == {"apply": "cuda", "apply_batched": "cuda"}
    got = solver.apply(z, q)
    assert got.shape == (n,) and got.dtype == torch.complex128
    assert rel(got, ref) <= TOL
    plain = FmmSolver.build(tcfg, backend="reference", device="cpu")
    assert rel(plain.apply(z, q), ref) <= TOL


@pytest.mark.parametrize("B,kernel", [(1, "harmonic"), (3, "harmonic"),
                                      (3, "log")])
def test_apply_batched_equals_stacked_apply(B, kernel):
    _, tcfg = configs(n=1024, nlevels=3, p=12, dtype="f64", kernel=kernel)
    probs = [inputs(d, 1024, seed=s) for d, s in
             (("normal", 1), ("layer", 2), ("uniform", 3))[:B]]
    zb = np.stack([z for z, _ in probs])
    qb = np.stack([q for _, q in probs])
    solver = FmmSolver.build(tcfg, backend="cuda", device="cpu")
    phib = solver.apply_batched(zb, qb)
    assert phib.shape == (B, 1024)
    stacked = torch.stack([solver.apply(z, q) for z, q in probs])
    assert rel(phib, stacked) <= TOL
    phic = solver.apply_batched_checked(torch.from_numpy(zb),
                                        torch.from_numpy(qb))
    assert torch.equal(phic, phib)


def test_f32_config_runs_in_f32_and_stays_accurate():
    jcfg, tcfg = configs(n=2048, nlevels=3, p=17, dtype="f32")
    z, q = inputs("uniform", 2048, seed=0)
    ref = np.asarray(JaxSolver.build(jcfg, backend="reference").apply(z, q))
    got = FmmSolver.build(tcfg, backend="cuda", device="cpu").apply(z, q)
    assert got.dtype == torch.complex64
    assert rel(got, ref) <= 1e-5


def test_health_plane_and_checked_errors():
    _, tcfg = configs(n=1024, nlevels=3, p=8, dtype="f64", strong_cap=8)
    z, q = inputs("normal", 1024, seed=1)
    solver = FmmSolver.build(tcfg, device="cpu")
    phi, health = solver.apply_with_health(z, q)
    assert health.margins.shape == (1, 5) and health.overflow.shape == (1,)
    h = host_health(health)
    assert h["overflow"] > 0 and min(h["margins"].values()) < 0
    with pytest.raises(CapOverflowError) as e:
        solver.apply_checked(z, q)
    assert e.value.overflow == h["overflow"]
    with pytest.raises(CapOverflowError):
        solver.apply_batched_checked(np.stack([z, z]), np.stack([q, q]))
    _, ok_cfg = configs(n=1024, nlevels=3, p=8, dtype="f64")
    ok = FmmSolver.build(ok_cfg, device="cpu")
    assert host_health(ok.apply_with_health(z, q)[1])["overflow"] == 0
    bad = q.copy()
    bad[3] = np.nan
    with pytest.raises(NonFiniteInputError):
        ok.apply_checked(z, bad)


def test_validation_errors():
    _, tcfg = configs(n=256, nlevels=1, p=5, dtype="f64")
    solver = FmmSolver.build(tcfg, device="cpu")
    z, q = inputs("uniform", 256)
    with pytest.raises(ShapeError):
        solver.apply(z[:100], q[:100])
    with pytest.raises(DTypeError):
        solver.apply(z.real, q)
    with pytest.raises(DTypeError):
        solver.apply(z.astype(np.complex64), q)
    with pytest.raises(DTypeError):
        solver.apply(torch.from_numpy(z.real.copy()), q)
    with pytest.raises(ShapeError):
        solver.apply_batched(z, q)
    with pytest.raises(ShapeError):
        solver.apply_batched(np.stack([z, z]), np.stack([q]))


def test_build_cache_keys_on_config_backend_and_device(monkeypatch):
    FmmSolver.cache_clear()
    _, tcfg = configs(n=256, nlevels=1, p=5)
    a = FmmSolver.build(tcfg, device="cpu")
    assert FmmSolver.build(tcfg, backend="reference", device="cpu") is a
    b = FmmSolver.build(tcfg, backend="cuda", device="cpu")
    assert b is not a
    assert FmmSolver.build(tcfg, backend="cuda", device="cpu") is b
    other = dataclasses.replace(tcfg, p=6)
    assert FmmSolver.build(other, device="cpu") is not a
    # least recently used goes first: shrunk to two entries, the cache
    # keeps ``b`` (used last) and the new config, and drops ``a``
    monkeypatch.setattr(solver_mod, "_CACHE_MAX", 2)
    FmmSolver.build(tcfg, backend="cuda", device="cpu")
    FmmSolver.build(dataclasses.replace(tcfg, p=7), device="cpu")
    assert FmmSolver.build(tcfg, backend="cuda", device="cpu") is b
    assert FmmSolver.build(tcfg, device="cpu") is not a


def test_plan_from_numpy_equals_native_build_and_evaluates_alike():
    """A reference plan carried across by ``plan_from_numpy`` equals the
    port's own build, and both evaluate to the same phi."""
    from _torch_parity import shared_plan
    _, tcfg, _, plan = shared_plan("layer", 1024, seed=9, nlevels=3, p=10,
                                   dtype="f64")
    z, q = inputs("layer", 1024, seed=9)
    own = F.fmm_build(torch.from_numpy(z)[None], torch.from_numpy(q)[None],
                      tcfg)
    assert torch.equal(own.tree.perm, plan.tree.perm)
    for a, b in zip(own.conn.weak + own.conn.strong,
                    plan.conn.weak + plan.conn.strong):
        assert torch.equal(a, b)
    assert torch.equal(F.fmm_evaluate(own, tcfg), F.fmm_evaluate(plan, tcfg))
    phi = fmm_potential(torch.from_numpy(z), torch.from_numpy(q), tcfg)
    assert torch.equal(phi, F.unsort(F.fmm_evaluate(own, tcfg),
                                     own.tree.perm)[0])
