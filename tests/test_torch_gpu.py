"""PyTorch port on the CUDA card: each kernel against its plain version
on the same CUDA tensors, launch counts per apply, and the solver's
cuda-vs-reference parity. Marked ``gpu``: skipped (inside a fixture,
never at import) where no CUDA card is present. On the machine with the
card: ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (the shared conftest imports JAX, which the
port does not need)."""
import pytest
import torch

from repro_torch.core import fmm as F
from repro_torch.core.config import FmmConfig
from repro_torch.data import particles
from repro_torch.kernels import (eval_fused_cuda, eval_fused_plain,
                                 eval_operands, launch_counts,
                                 leaf_classify_cuda, leaf_classify_plain,
                                 m2l_cuda, m2l_operands, m2l_plain, p2l_cuda,
                                 p2l_operands, p2l_plain, reset_launch_counts)
from repro_torch.solver import FmmSolver

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("dtype,kernel", [("f64", "harmonic"),
                                          ("f64", "log"),
                                          ("f32", "harmonic")])
def test_kernels_match_plain_versions(cuda, dtype, kernel):
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype=dtype, kernel=kernel)
    z, q = particles("normal", cfg.n, 0, device=cuda)
    cap = {}

    def rec(cand, valid, centers, radii, c):
        cap["classify"] = (cand, valid, centers, radii)
        return leaf_classify_cuda(cand, valid, centers, radii, c)

    plan = F.fmm_build(z[None], q[None], cfg, leaf_classify_impl=rec)
    a = cap["classify"]
    for x, y in zip(leaf_classify_cuda(*a, cfg), leaf_classify_plain(*a, cfg)):
        assert torch.equal(x, y)
    tol = 1e-10 if dtype == "f64" else 1e-4
    mult = F.upward(plan.tree, cfg)
    rho = F.effective_radii(plan.tree, cfg)
    args, _ = m2l_operands(mult, plan.conn.weak, plan.tree.centers, cfg, rho)
    assert _rel(torch.complex(*m2l_cuda(*args)),
                torch.complex(*m2l_plain(*args))) <= tol
    args, kw = p2l_operands(plan.tree, plan.conn, cfg, rho[-1])
    assert _rel(torch.complex(*p2l_cuda(*args, **kw)),
                torch.complex(*p2l_plain(*args, **kw))) <= tol
    local = F.downward(mult, plan.tree, plan.conn, cfg, rho)
    args, kw = eval_operands(local, mult[-1], plan.tree, plan.conn, cfg)
    assert _rel(torch.complex(*eval_fused_cuda(*args, **kw)),
                torch.complex(*eval_fused_plain(*args, **kw))) <= tol


def test_apply_launches_each_kernel_once_and_matches_reference(cuda):
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f64")
    z, q = particles("layer", cfg.n, 1, device=cuda)
    solver = FmmSolver.build(cfg)
    assert solver.dispatched["apply"] == "cuda"
    reset_launch_counts()
    phi = solver.apply_checked(z, q)
    assert set(launch_counts().values()) == {1}
    ref = FmmSolver.build(cfg, backend="reference").apply(z, q)
    assert _rel(phi, ref) <= 1e-10
    reset_launch_counts()
    zb, qb = torch.stack([z, z.flip(0)]), torch.stack([q, q.flip(0)])
    phib = solver.apply_batched(zb, qb)
    assert set(launch_counts().values()) == {1}
    assert torch.equal(phib[0], phi)
