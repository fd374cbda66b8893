"""PyTorch port, the held-plan matvec: ``FmmSolver.apply_charges``
evaluates new charges on a plan built once (the matvec of an iterative
boundary-integral solve). Its phi is bitwise ``apply``'s on the same
positions and charges (the topology depends on the positions alone),
within 1e-10 relative of the JAX reference's ``apply`` in f64, and its
real part within the p-term truncation of the plain direct log sum of
the benchmark (``bench/reference/direct_log.py``). Its program holds the
plan: ``program.plan_bind`` counts a bind per new plan, not per call. A
plan of other shapes or charges of another shape raise ``ShapeError``.
On the CPU every call runs eagerly."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.solver import FmmSolver as JaxSolver
from repro_torch import trace
from repro_torch.core import fmm as F
from repro_torch.errors import DTypeError, ShapeError
from repro_torch.solver import FmmSolver

from _torch_parity import configs, inputs, rel

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-10


def _direct_log():
    """The benchmark's plain log reference, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        "direct_log", ROOT / "bench" / "reference" / "direct_log.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.direct_log


def _charges(n: int, seed: int) -> np.ndarray:
    """Real N(0, 1) charges as complex128 (a Krylov vector)."""
    return np.random.default_rng([seed, 7]).normal(size=n) + 0j


@pytest.mark.parametrize("dist,n,nlevels", [("layer", 4096, 4),
                                            ("uniform", 2048, 3)])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_apply_charges_is_bitwise_apply(kernel, dtype, dist, n, nlevels):
    """One plan from ``refresh(z, q0)``, three charge vectors and the
    plan's own: each phi bitwise ``apply(z, q)``, in input order."""
    _, cfg = configs(n=n, nlevels=nlevels, p=12, dtype=dtype, kernel=kernel,
                     strong_cap=96, weak_cap=256)
    z, q0 = inputs(dist, n, 3)
    solver = FmmSolver.build(cfg, backend="cuda", device="cpu")
    plan = solver.refresh(z, q0)
    for q in [_charges(n, s) for s in (1, 2, 3)] + [q0]:
        phi = solver.apply_charges(plan, q)
        assert phi.shape == (n,) and phi.dtype == cfg.torch_complex
        assert torch.equal(phi, solver.apply(z, q))


@pytest.mark.parametrize("kernel", ["harmonic", "log"])
@pytest.mark.parametrize("dist", ["layer", "uniform"])
def test_apply_charges_matches_the_reference_apply(dist, kernel):
    """f64: within 1e-10 relative of the JAX reference's ``apply`` on the
    same positions and charges (the reference has no such entry point)."""
    jcfg, cfg = configs(n=1024, nlevels=3, p=12, dtype="f64", kernel=kernel,
                        strong_cap=48, weak_cap=128)
    z, q0 = inputs(dist, cfg.n, 5)
    solver = FmmSolver.build(cfg, backend="cuda", device="cpu")
    plan = solver.refresh(z, q0)
    jsolver = JaxSolver.build(jcfg, "reference")
    for seed in (11, 12):
        q = _charges(cfg.n, seed)
        phi = solver.apply_charges(plan, q)
        assert rel(phi, np.asarray(jsolver.apply(z, q))) <= TOL


@pytest.mark.parametrize("dist", ["layer", "uniform"])
def test_real_part_within_truncation_of_the_direct_log_sum(dist):
    """Re phi of the log kernel at p = 17, f64, against the benchmark's
    direct log sum: normwise relative error under 1e-8 (the p-term
    truncation at theta = 0.5 reads 2e-10 to 7e-10 here; the same path in
    f32 reads ~3e-7). Real parts only: the imaginary part q arg(z - x)
    takes another branch in an expansion than in the direct sum."""
    _, cfg = configs(n=4096, nlevels=4, p=17, dtype="f64", kernel="log",
                     strong_cap=96, weak_cap=256)
    z, q0 = inputs(dist, cfg.n, 6)
    solver = FmmSolver.build(cfg, backend="cuda", device="cpu")
    plan = solver.refresh(z, q0)
    assert int(plan.conn.overflow) == 0
    q = _charges(cfg.n, 13)
    phi = solver.apply_charges(plan, q).real
    zt = torch.as_tensor(z)
    ref = _direct_log()(zt, zt, torch.as_tensor(q))
    assert float((phi - ref).norm() / ref.norm()) < 1e-8


def test_plan_binds_count_plans_not_calls():
    """Several charge vectors on one plan bind it once; a second plan of
    the same shapes binds once more, and going back to the first binds it
    again; a batched plan takes (B, N) charges."""
    _, cfg = configs(n=1024, nlevels=3, p=8, dtype="f64", strong_cap=48,
                     weak_cap=128)
    z, q0 = inputs("uniform", cfg.n, 8)
    solver = FmmSolver(cfg, "cuda", device="cpu")
    first, second = solver.refresh(z, q0), solver.refresh(z, q0)
    trace.reset()
    for seed in (1, 2, 3):
        solver.apply_charges(first, _charges(cfg.n, seed))
    assert trace.snapshot()["counters"]["program.plan_bind"] == 1
    solver.apply_charges(second, q0)
    solver.apply_charges(second, _charges(cfg.n, 4))
    assert trace.snapshot()["counters"]["program.plan_bind"] == 2
    solver.apply_charges(first, q0)
    assert trace.snapshot()["counters"]["program.plan_bind"] == 3
    spans = [s for s in trace.snapshot()["spans"]
             if s.name == "fmm::charges"]
    assert len(spans) == 6
    z2, _ = inputs("layer", cfg.n, 9)
    batch = torch.as_tensor(np.stack([z, z2]))
    qb = torch.as_tensor(np.stack([_charges(cfg.n, 5), _charges(cfg.n, 6)]))
    bplan = F.fmm_build(batch, qb, cfg)
    phib = solver.apply_charges(bplan, qb)
    assert phib.shape == (2, cfg.n)
    assert torch.equal(phib, solver.apply_batched(batch, qb))
    trace.reset()


def test_wrong_shapes_raise_shape_error():
    """Charges of another length, of three axes, or of no or more than
    ``MAX_DENSITIES`` rows (a (K, N) block of 1..16 densities is a shape
    the one-problem plan takes), a plan of other caps, depth or dtype:
    ``ShapeError``; real charges: ``DTypeError``, as ``apply``."""
    _, cfg = configs(n=512, nlevels=2, p=8, dtype="f64", strong_cap=48,
                     weak_cap=128)
    z, q0 = inputs("uniform", cfg.n, 10)
    solver = FmmSolver(cfg, "cuda", device="cpu")
    plan = solver.refresh(z, q0)
    for bad in (q0[:-1], q0[None, None], np.stack([q0, q0])[:, :-1],
                np.zeros((0, cfg.n), np.complex128), np.stack([q0] * 17)):
        with pytest.raises(ShapeError):
            solver.apply_charges(plan, bad)
    with pytest.raises(DTypeError):
        solver.apply_charges(plan, q0.real)
    for other in (dataclasses.replace(cfg, strong_cap=32, weak_cap=128),
                  dataclasses.replace(cfg, weak_cap=96),
                  dataclasses.replace(cfg, nlevels=3),
                  dataclasses.replace(cfg, dtype="f32")):
        foreign = FmmSolver(other, "cuda", device="cpu").refresh(z, q0)
        with pytest.raises(ShapeError):
            solver.apply_charges(foreign, q0)
    assert torch.equal(solver.apply_charges(plan, q0), solver.apply(z, q0))
