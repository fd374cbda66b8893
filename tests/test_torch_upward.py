"""PyTorch port, the upward hook: the "cuda" backend's ``upward`` wrapper
on CPU tensors (its plain twin, ``core.fmm.upward``) against the
reference's ``upward`` on the same numpy-seeded topology, f64 within
1e-10 relative per level: both G-kernels, B = 1 and 2, nlevels 0, 1 and
3, at sizes whose leaves differ in population (padded slots).
``fmm_evaluate`` with the hook is bitwise ``fmm_evaluate`` without it on
the CPU, and the guard's degradation rung drops the hook."""
import numpy as np
import pytest
import torch

from repro.core import fmm as JF
from repro_torch.core import fmm as F
from repro_torch.core.config import FmmConfig, level_bounds
from repro_torch.kernels import upward_cuda, upward_launches
from repro_torch.solver import get_backend
from repro_torch.solver.guard import degraded_eval_backend

from _torch_parity import rel, shared_plan

TOL = 1e-10
CPU = torch.device("cpu")
# (nlevels, N): one leaf of 37; 4 leaves of 50/51; 64 leaves of 15/16
SIZES = {0: 37, 1: 203, 3: 1000}


def _stack(plans):
    """B = 1 plans of one config -> one plan of B problems."""
    trees = [p.tree for p in plans]
    tree = trees[0]._replace(
        perm=torch.cat([t.perm for t in trees]),
        z=torch.cat([t.z for t in trees]), q=torch.cat([t.q for t in trees]),
        centers=tuple(torch.cat(c) for c in zip(*(t.centers
                                                   for t in trees))),
        radii=tuple(torch.cat(r) for r in zip(*(t.radii for t in trees))))
    return F.FmmPlan(tree=tree, conn=plans[0].conn)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("nlevels", sorted(SIZES))
@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_upward_hook_matches_reference(kernel, nlevels, batch):
    n = SIZES[nlevels]
    probs = [shared_plan(dist, n, seed=seed, nlevels=nlevels, p=17,
                         dtype="f64", kernel=kernel)
             for dist, seed in (("normal", 3), ("layer", 4))[:batch]]
    jcfg, tcfg = probs[0][:2]
    sizes = np.diff(level_bounds(tcfg)[-1])
    assert nlevels == 0 or sizes.min() < sizes.max()   # padded slots
    plan = _stack([p[3] for p in probs])
    rho = F.effective_radii(plan.tree, tcfg)
    got = upward_cuda(plan.tree, tcfg, rho)
    assert len(got) == nlevels + 1
    for b, (_, _, jp, _) in enumerate(probs):
        want = JF.upward(jp.tree, jcfg)
        for l, (g, w) in enumerate(zip(got, want)):
            assert g.shape == (batch, 4**l, tcfg.p + 1)
            assert rel(g[b], w) <= TOL, (b, l)
    assert np.abs(np.asarray(want[0])).max() > 0


@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_fmm_evaluate_with_upward_hook_is_bitwise_without(kernel):
    _, tcfg, _, plan = shared_plan("normal", 1000, seed=5, nlevels=3, p=12,
                                   dtype="f64", kernel=kernel,
                                   strong_cap=32, weak_cap=64)
    hook = get_backend("cuda", CPU).upward
    assert hook is upward_cuda
    plain = F.fmm_evaluate(plan, tcfg)
    assert torch.equal(F.fmm_evaluate(plan, tcfg, upward_impl=hook), plain)
    assert torch.isfinite(plain).all()


def test_degradation_rung_drops_the_upward_hook():
    cuda = get_backend("cuda", CPU)
    assert cuda.phase_impls()["upward_impl"] is upward_cuda
    assert degraded_eval_backend(cuda).upward is None
    assert get_backend("reference", CPU).upward is None


def test_upward_launches_a_pass():
    assert [upward_launches(L) for L in range(9)] == [1, 1, 1] + [2] * 6


def test_nan_upward_is_recovered_by_the_degradation_rung():
    """``nan_coefficients(phase="upward")`` on the "cuda" backend (its
    plain twin on the CPU): the primary rung's phi is non-finite, the
    degrade rung, whose upward pass is the plain sweep, recovers it."""
    from repro_torch.data import particles
    from repro_torch.solver import FmmSolver, GuardedSolver
    from repro_torch.testing import nan_coefficients

    tcfg = FmmConfig(n=1000, nlevels=3, p=12, dtype="f64", strong_cap=32,
                     weak_cap=64)
    z, q = particles("uniform", tcfg.n, 6, device=CPU)
    with nan_coefficients("cuda", "upward"):
        phi, rep = GuardedSolver(tcfg, "cuda", device=CPU).apply_guarded(z, q)
    assert rep.ok and [a.rung for a in rep.attempts] == [
        "primary", "degrade:cuda+ref-eval"]
    ref = FmmSolver.build(tcfg, "reference", CPU).apply(z, q)
    assert rel(phi, ref) <= TOL
