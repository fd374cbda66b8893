"""K densities on one held plan (the density axis): ``apply_charges(plan,
q)`` with q of shape (K, N) on a one-problem plan, on the CPU (every
kernel wrapper runs its plain version there).

Each row of a K-density call is that row's single-density call within
rounding, the JAX reference's ``apply`` on the same input within 1e-10,
and the direct sum within the p-term truncation; the shapes the entry
point refuses raise ``ShapeError``; the counter ``fmm.densities`` rises
by K a call and the program's spans carry K; the plan's tree and lists
are the same storage whatever K (never copied K times)."""
import numpy as np
import pytest
import torch

from repro.solver import FmmSolver as JaxSolver
from repro_torch import trace
from repro_torch.core import fmm as F
from repro_torch.core.direct import direct_potential
from repro_torch.data.synthetic import particles_numpy
from repro_torch.errors import ShapeError
from repro_torch.solver import FmmSolver
from repro_torch.solver.solver import MAX_DENSITIES

from _torch_parity import configs, rel

N = 1 << 12
#: Scaled agreement of a K-density row with its single-density call.
ROW_TOL = {"f64": 1e-13, "f32": 1e-5}
#: Normwise relative error against the direct sum at p = 17 (readings,
#: 8 rows: harmonic 8.6e-11-9.7e-11 on the wires, 6.5e-9-1.23e-8 on
#: uniform points; log 1.7e-12-5.2e-12 and 1.1e-10-3.5e-10).
TRUNC = {"harmonic": 1e-7, "log": 1e-8}


def _positions(dist: str, seed: int = 3):
    """2^12 nodes on the eight wire contours, or uniform points."""
    return particles_numpy(dist, N, seed)


def _densities(K: int, seed: int) -> np.ndarray:
    """K real N(0, 1) densities as complex128 (block Krylov vectors)."""
    return np.random.default_rng([seed, 7]).normal(size=(K, N)) + 0j


def _solver(kernel, dtype, dist, p=12):
    caps = dict(strong_cap=32, weak_cap=64) if dist == "wires8" else \
        dict(strong_cap=96, weak_cap=256)
    jcfg, cfg = configs(n=N, nlevels=4, p=p, dtype=dtype, kernel=kernel,
                        **caps)
    solver = FmmSolver.build(cfg, backend="cuda", device="cpu")
    z, q0 = _positions(dist)
    plan = solver.refresh(z, q0)
    assert int(plan.conn.overflow.max()) == 0
    return jcfg, cfg, solver, plan, z


def _scaled(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("dist", ["wires8", "uniform"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("kernel", ["harmonic", "log"])
@pytest.mark.parametrize("K", [1, 3, 8])
def test_each_row_is_its_single_density_call(K, kernel, dtype, dist):
    """phi of (K, N) densities is (K, N), row k within rounding of
    ``apply_charges(plan, q[k])``."""
    _, cfg, solver, plan, _ = _solver(kernel, dtype, dist)
    Q = _densities(K, 10 + K)
    phis = solver.apply_charges(plan, Q)
    assert phis.shape == (K, N) and phis.dtype == cfg.torch_complex
    for k in range(K):
        one = solver.apply_charges(plan, Q[k])
        assert _scaled(phis[k], one) <= ROW_TOL[dtype], k


@pytest.mark.parametrize("dist", ["wires8", "uniform"])
@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_rows_match_the_reference_apply(kernel, dist):
    """f64: each of 3 rows within 1e-10 relative of the JAX reference's
    ``apply`` on the same positions and that row's charges."""
    jcfg, cfg, solver, plan, z = _solver(kernel, "f64", dist)
    Q = _densities(3, 21)
    phis = solver.apply_charges(plan, Q)
    jsolver = JaxSolver.build(jcfg, "reference")
    for k in range(3):
        assert rel(phis[k], np.asarray(jsolver.apply(z, Q[k]))) <= 1e-10, k


@pytest.mark.parametrize("dist", ["wires8", "uniform"])
@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_rows_within_truncation_of_the_direct_sum(kernel, dist):
    """p = 17, f64: each of 8 rows against ``core.direct.
    direct_potential`` (the real part for G = log, whose imaginary part
    takes another branch in an expansion), normwise relative error under
    ``TRUNC``."""
    _, cfg, solver, plan, z = _solver(kernel, "f64", dist, p=17)
    Q = _densities(8, 31)
    phis = solver.apply_charges(plan, Q)
    zt = torch.as_tensor(z)
    for k in range(8):
        ref = direct_potential(zt, zt, torch.as_tensor(Q[k]), kernel=kernel)
        got = phis[k]
        if kernel == "log":
            got, ref = got.real, ref.real
        assert float((got - ref).norm() / ref.norm()) < TRUNC[kernel], k


def test_shapes_it_refuses_raise_shape_error():
    """K = 0, K = MAX_DENSITIES + 1, a 3-D q and K rows on a plan of two
    problems (other than its own two) raise ``ShapeError``; K =
    MAX_DENSITIES runs."""
    _, cfg, solver, plan, z = _solver("log", "f64", "wires8", p=6)
    for bad in (np.zeros((0, N), np.complex128),
                _densities(MAX_DENSITIES + 1, 1), _densities(2, 1)[None]):
        with pytest.raises(ShapeError):
            solver.apply_charges(plan, bad)
    assert solver.apply_charges(
        plan, _densities(MAX_DENSITIES, 2)).shape == (MAX_DENSITIES, N)
    z2, _ = _positions("uniform", 4)
    zb = torch.as_tensor(np.stack([z, z2]))
    qb = torch.as_tensor(_densities(2, 3))
    bplan = F.fmm_build(zb, qb, cfg)
    with pytest.raises(ShapeError):
        solver.apply_charges(bplan, _densities(3, 4))
    assert torch.equal(solver.apply_charges(bplan, qb),
                       solver.apply_batched(zb, qb))


def test_densities_counter_and_program_spans_carry_k():
    """``fmm.densities`` rises by the rows each call evaluates (eager on
    the CPU: every call is a program call); the eager spans of the
    K-density programs carry K, the single-density one 1; one program a
    K, each under the entry ``apply_charges``."""
    _, cfg, solver, plan, _ = _solver("harmonic", "f64", "wires8", p=6)
    trace.reset()
    for K in (3, 8, 3):
        solver.apply_charges(plan, _densities(K, K))
    solver.apply_charges(plan, _densities(1, 9)[0])
    snap = trace.snapshot()
    assert snap["counters"]["fmm.densities"] == 3 + 8 + 3 + 1
    eager = [s for s in snap["spans"] if s.name == "program::eager"]
    assert [(s.tag, s.densities) for s in eager] == [
        ("apply_charges", 3), ("apply_charges", 8), ("apply_charges", 3),
        ("apply_charges", 1)]
    keys = [k for k in solver.programs() if k[0] == "apply_charges"]
    assert sorted(map(str, (k[1] for k in keys))) == ["(1, 3)", "(1, 8)", "1"]
    trace.reset()


def test_the_plan_is_one_copy_whatever_k():
    """The pipeline reads the plan's own tensors for every K: each of the
    tree's and the lists' tensors the programs were given is the very
    storage of the plan (no K-fold copy), and a K-density plan from
    ``with_charges`` holds (K, N) charges beside the plan's single
    rows."""
    _, cfg, solver, plan, _ = _solver("log", "f64", "wires8", p=6)
    seen = []
    real = F.fmm_evaluate

    def spy(p, c, **kw):
        seen.append(p)
        return real(p, c, **kw)

    F_eval, F.fmm_evaluate = F.fmm_evaluate, spy
    import repro_torch.solver.solver as S
    S_eval, S.fmm_evaluate = S.fmm_evaluate, spy
    try:
        for K in (1, 3, 8):
            solver._release_executables()
            solver.apply_charges(plan, _densities(K, K))
    finally:
        F.fmm_evaluate, S.fmm_evaluate = F_eval, S_eval
    assert len(seen) == 3
    geometry = lambda p: ([p.tree.perm, p.tree.z, *p.tree.centers,
                           *p.tree.radii] + [t for t in p.conn
                                             if isinstance(t, torch.Tensor)]
                          + [*p.conn.strong, *p.conn.weak])
    for p, K in zip(seen, (1, 3, 8)):
        assert p.tree.q.shape == (K, N)
        for a, b in zip(geometry(p), geometry(plan)):
            assert a.data_ptr() == b.data_ptr() and a.shape == b.shape


def test_densities_run_as_chunks_of_the_kernels_instantiations():
    """On the card K densities run as launches of the K-density kernels'
    instantiation (8 densities), each density left over as a launch of
    the single-density kernel: rows in order, every row once."""
    from repro_torch.kernels.common import BLOCK_KD, density_chunks
    assert BLOCK_KD == 8
    assert density_chunks(8) == [(0, 8)]
    assert density_chunks(3) == [(0, 1), (1, 1), (2, 1)]
    assert density_chunks(11) == [(0, 8), (8, 1), (9, 1), (10, 1)]
    for K in range(1, MAX_DENSITIES + 1):
        rows = [k0 + i for k0, kd in density_chunks(K) for i in range(kd)]
        assert rows == list(range(K))
