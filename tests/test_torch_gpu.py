"""PyTorch port on the CUDA card: each kernel against its plain version
on the same CUDA tensors (the upward kernel at the cells' 2^20 plans and
the serving buckets, and its NaN fault recovered by the degrade rung),
launch counts per kernel per apply on the main
path and on the per-phase path (a program's first call launches from
the host, its second records the launches into the graph it captures,
a replay launches nothing from the host and runs the recorded kernels,
read from a profiler trace), the solver's cuda-vs-reference parity, the
guard (its fault walk, a failing launch propagating) and tune, the
serving plane (a failing launch leaving ``serve``, the shed walk's
warnings, warm-up, no layout rebuilt on a warm wave), and the compiled
programs (each entry point's first call and replay bitwise its eager
pipeline, fresh outputs, memory back on release, the memory budget, a
capture error raised, the device phase marks a replay reads), the
degenerate layouts against the CPU run, a checkpoint of CUDA tensors
restored bitwise, the prefetcher's device,
the vortex example's re-plans through captured programs on the card, and
the multi-device legs on one NCCL rank (the compressed gradient and its
bytes on the wire, an elastic restore resumed bitwise).
Marked ``gpu``: skipped (inside a fixture, never at import) where no
CUDA card is present. On the machine with the
card: ``PYTHONPATH=src python -m pytest --noconftest -m gpu
tests/test_torch_gpu.py`` (the shared conftest imports JAX, which the
port does not need)."""
import dataclasses
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.core import fmm as F
from repro_torch.core.config import FmmConfig
from repro_torch.data import particles
from repro_torch.kernels import (eval_fused_cuda, eval_fused_plain,
                                 eval_operands, l2p_cuda, l2p_operands,
                                 l2p_plain, launch_counts,
                                 level_classify_cuda,
                                 m2l_cuda, m2l_operands, m2l_plain,
                                 nbody_cuda, nbody_direct, nbody_plain,
                                 nbody_plan,
                                 p2l_cuda, p2l_operands, p2l_plain, p2p_cuda,
                                 p2p_operands, p2p_plain, reset_launch_counts,
                                 upward_cuda, upward_launches, upward_plain)
from repro_torch.kernels.build import recorded_counts
from repro_torch.solver import FmmSolver, get_backend, register_backend

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    """``chip_smoke`` (the repository root's script), for its synthetic
    M2L operands and its particle walk."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _runs(fn):
    """(fn(), host launches, recorded launches) of one call, synchronized:
    what the kernel wrappers counted during it, from the host (a
    program's first call runs eagerly) and into a graph being captured
    (its second call captures, then replays once)."""
    torch.cuda.synchronize()
    reset_launch_counts()
    before = recorded_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts(), {k: v - before[k]
                                  for k, v in recorded_counts().items()}


def _main_counts(nlevels, **kw):
    """Expected launches per kernel: the main path's by default on a tree
    of ``nlevels`` levels (classify once a level, the upward pass in
    ``upward_launches(nlevels)``)."""
    want = {"classify": nlevels, "upward": upward_launches(nlevels),
            "m2l": 1, "p2l": 1, "eval_fused": 1, "l2p": 0, "p2p": 0,
            "nbody": 0}
    want.update(kw)
    return want


@pytest.mark.parametrize("dtype,kernel", [("f64", "harmonic"),
                                          ("f64", "log"),
                                          ("f32", "harmonic")])
def test_kernels_match_plain_versions(cuda, dtype, kernel):
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype=dtype, kernel=kernel)
    z, q = particles("normal", cfg.n, 0, device=cuda)
    plan = F.fmm_build(z[None], q[None], cfg,
                       leaf_classify_impl=level_classify_cuda)
    plain = F.build_connectivity(plan.tree, cfg)

    def lists(c):
        return [*c.strong, *c.weak, *c[2:]]
    assert all(map(torch.equal, lists(plan.conn), lists(plain)))
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
    args, kw = p2p_operands(plan.tree, plan.conn, cfg)
    assert _rel(torch.complex(*p2p_cuda(*args, **kw)),
                torch.complex(*p2p_plain(*args, **kw))) <= tol
    args, kw = l2p_operands(local, plan.tree, cfg)
    got = l2p_cuda(*args, **kw)
    assert _rel(torch.complex(*got), torch.complex(*l2p_plain(*args, **kw))) \
        <= tol
    assert (got[0][:, args[-1] < 0] == 0).all()
    if kernel == "harmonic":
        zr, zi, qr, qi = (x.contiguous() for x in (
            plan.tree.z.real[0], plan.tree.z.imag[0], plan.tree.q.real[0],
            plan.tree.q.imag[0]))
        args = (zr[:2048], zi[:2048], zr, zi, qr, qi)
        assert _rel(torch.complex(*nbody_cuda(*args)),
                    torch.complex(*nbody_plain(*args))) <= \
            (tol if dtype == "f64" else 1e-3)


def test_apply_launches_each_kernel_once_and_matches_reference(cuda):
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f64")
    z, q = particles("layer", cfg.n, 1, device=cuda)
    FmmSolver.cache_clear()          # first calls: launched from the host
    solver = FmmSolver.build(cfg)
    assert solver.dispatched["apply"] == "cuda"
    phi, host, _ = _runs(lambda: solver.apply_checked(z, q))
    assert host == _main_counts(cfg.nlevels)
    ref = FmmSolver.build(cfg, backend="reference").apply(z, q)
    assert _rel(phi, ref) <= 1e-10
    zb, qb = torch.stack([z, z.flip(0)]), torch.stack([q, q.flip(0)])
    phib, host, _ = _runs(lambda: solver.apply_batched(zb, qb))
    assert host == _main_counts(cfg.nlevels)
    assert torch.equal(phib[0], phi)


def test_per_phase_path_launches_and_matches_main_path(cuda):
    """The "cuda" backend without its fused hooks: classify and M2L once
    per level, P2L 1, L2P 1, P2P 1, the fused evaluation 0 — per apply
    and per apply_batched; phi as the main path's."""
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f64")
    z, q = particles("layer", cfg.n, 2, device=cuda)
    register_backend(dataclasses.replace(
        get_backend("cuda", cuda), name="cuda-phases", m2l_fused=None,
        eval_fused=None))
    FmmSolver.cache_clear()          # first calls: launched from the host
    solver = FmmSolver.build(cfg, backend="cuda-phases")
    want = _main_counts(cfg.nlevels, m2l=cfg.nlevels, eval_fused=0, l2p=1,
                        p2p=1)
    phi, host, _ = _runs(lambda: solver.apply_checked(z, q))
    assert host == want
    main = FmmSolver.build(cfg).apply(z, q)
    assert _rel(phi, main) <= 1e-10
    zb, qb = torch.stack([z, z.flip(0)]), torch.stack([q, q.flip(0)])
    phib, host, _ = _runs(lambda: solver.apply_batched(zb, qb))
    assert host == want
    assert torch.equal(phib[0], phi)


def test_nbody_direct_launches_once_and_excludes_by_position(cuda):
    z, q = particles("uniform", 4096, 3, device=cuda)
    z[7] = z[3]
    reset_launch_counts()
    phi = nbody_direct(z, z, q)
    assert launch_counts() == _main_counts(0, upward=0, m2l=0, p2l=0,
                                           eval_fused=0, nbody=1)
    assert torch.isfinite(phi).all()
    from repro_torch.core.direct import direct_potential
    assert _rel(phi, direct_potential(z, z, q)) <= 1e-10


def _bits(x):
    return x.view(torch.int64 if x.element_size() == 8 else torch.int32)


def _upward_against_plain(plan, cfg):
    """The upward kernel on ``plan`` twice and its plain version once:
    the launches (``upward_launches`` a pass), the two launches bitwise
    equal, and the kernel within the smoke's scaled error of the plain
    pass over every box of every level: 1e-10 in f64; in f32 1e-5, or
    ten times the plain pass's own f32 rounding (against the same pass
    on the operands widened to f64) where that is above 1e-6. Returns
    (error, that rounding level or None)."""
    smoke = _smoke()
    rho = F.effective_radii(plan.tree, cfg)
    torch.cuda.synchronize()
    reset_launch_counts()
    first = torch.cat(upward_cuda(plan.tree, cfg, rho), dim=1)
    second = torch.cat(upward_cuda(plan.tree, cfg, rho), dim=1)
    torch.cuda.synchronize()
    assert launch_counts()["upward"] == 2 * upward_launches(cfg.nlevels)
    assert torch.equal(_bits(torch.view_as_real(first)),
                       _bits(torch.view_as_real(second)))
    plain = torch.cat(upward_plain(plan.tree, cfg, rho), dim=1)
    err = smoke.scaled_err(first, plain)
    if cfg.dtype == "f64":
        assert err <= 1e-10, err
        return err, None
    # a box whose charges cancel exactly (the root of the vortex pair)
    # has coefficients that are f32 rounding in either pass
    wide, _ = smoke.upcast((plan.tree, cfg, rho), {}, torch)
    level = smoke.scaled_err(plain.to(torch.complex128),
                             torch.cat(upward_plain(*wide), dim=1))
    assert err <= max(1e-5, 10 * level), (err, level)
    return err, level


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_upward_kernel_matches_plain_at_the_cells_plans(cuda, dtype, kernel):
    """The 2^20 plans of the solve cells (uniform, layer) and of the
    vortex cell (the vortex example's pair), p = 17, seven levels."""
    from repro_torch.configs import fmm_config

    smoke = _smoke()
    cfg = dataclasses.replace(fmm_config(1 << 20, p=17, dtype=dtype),
                              kernel=kernel)
    pair = smoke.load_example("torch_vortex_dynamics").vortex_pair(cfg.n)
    for dist in ("uniform", "layer", "vortex"):
        if dist == "vortex":
            z, q = (torch.from_numpy(a + 0j).to(cuda) for a in pair)
        else:
            z, q = particles(dist, cfg.n, 0, device=cuda)
        plan = F.fmm_build(z[None], q[None], cfg,
                           leaf_classify_impl=level_classify_cuda)
        print(f"upward[{dtype}/{kernel}/{dist}]: scaled_err and the "
              f"plain pass's f32 rounding {_upward_against_plain(plan, cfg)}")
        del plan


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_upward_kernel_matches_plain_at_the_serving_buckets(cuda, dtype,
                                                            kernel):
    """The serving plane's configs (``default_cfg_factory``) at nlevels 0
    to 5, B = 8 problems a bucket, one of them with the charges of its
    last fifth zero, as the plane pads a short request."""
    from repro_torch.serve import default_cfg_factory

    for nlevels, n in enumerate(64 * 4**k for k in range(6)):
        cfg = dataclasses.replace(default_cfg_factory(n, dtype=dtype),
                                  kernel=kernel)
        assert cfg.nlevels == nlevels
        zs, qs = zip(*(particles(("uniform", "normal", "layer")[b % 3], n,
                                 b, device=cuda) for b in range(8)))
        z, q = torch.stack(zs), torch.stack(qs)
        q[7, n - n // 5:] = 0
        plan = F.fmm_build(z, q, cfg, leaf_classify_impl=level_classify_cuda)
        _upward_against_plain(plan, cfg)


def test_nan_upward_is_recovered_by_the_degradation_rung(cuda):
    """``nan_coefficients(phase="upward")``: the primary rung's phi is
    non-finite, the degrade rung (plain upward and evaluation sweeps)
    recovers it, within 1e-10 of the reference backend."""
    from repro_torch.errors import BackendDowngradeWarning
    from repro_torch.solver import GuardedSolver
    from repro_torch.testing import nan_coefficients

    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f64")
    z, q = particles("uniform", cfg.n, 2, device=cuda)
    with nan_coefficients("cuda", "upward"), \
            pytest.warns(BackendDowngradeWarning):
        phi, rep = GuardedSolver(cfg).apply_guarded(z, q)
    assert rep.ok and rep.final_rung == "degrade:cuda+ref-eval"
    ref = FmmSolver.build(cfg, backend="reference").apply(z, q)
    assert _rel(phi, ref) <= 1e-10


def _twice(fn):
    """Two launches; the second must equal the first bitwise (NaNs
    included)."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(first, second))
    return first


def _pair_kernel(which, cfg, cuda, seed=0, zq=None):
    """The operands of the fused evaluation or of the P2P kernel (the
    two kernels share one pair loop) on one uniform problem (or on the
    particles ``zq``): (kernel call, plain call, its zr, zi and rank
    planes), the planes as the calls see them, so a test may edit them
    in place."""
    z, q = zq if zq is not None else particles("uniform", cfg.n, seed,
                                               device=cuda)
    plan = F.fmm_build(z[None], q[None], cfg)
    if which == "p2p":
        args, kw = p2p_operands(plan.tree, plan.conn, cfg)
        kern, plain, (zr, zi, rk) = p2p_cuda, p2p_plain, args[1:3] + args[5:6]
    else:
        mult = F.upward(plan.tree, cfg)
        rho = F.effective_radii(plan.tree, cfg)
        local = F.downward(mult, plan.tree, plan.conn, cfg, rho)
        args, kw = eval_operands(local, mult[-1], plan.tree, plan.conn, cfg)
        kern, plain = eval_fused_cuda, eval_fused_plain
        zr, zi, rk = args[2], args[3], args[6]
    return (lambda: kern(*args, **kw)), (lambda: plain(*args, **kw)), zr, \
        zi, rk


PAIR_KERNELS = ["eval_fused", "p2p"]


@pytest.mark.parametrize("which", PAIR_KERNELS)
@pytest.mark.parametrize("n,nlevels,dtype,kernel", [
    (1 << 14, 4, "f64", "harmonic"),      # n_max 64, full leaves: unrolled
    (1 << 14, 4, "f32", "harmonic"),
    ((1 << 14) - 200, 4, "f64", "harmonic"),   # n_max 64, padded tails
    ((1 << 14) - 200, 4, "f64", "log"),
    (1 << 14, 4, "f64", "log"),           # full leaves: the NF = 64 loop
    (3000, 3, "f64", "harmonic"),         # n_max 47: generic
    (3000, 3, "f64", "log"),
    (6000, 3, "f32", "harmonic"),         # n_max 94: generic, two passes
])
def test_eval_fused_kernel_instantiations(cuda, which, n, nlevels, dtype,
                                          kernel):
    """The shared pair loop's instantiations, in the fused evaluation and
    in the P2P kernel."""
    cfg = FmmConfig(n=n, nlevels=nlevels, p=17, dtype=dtype, kernel=kernel)
    run, plain, _, _, rk = _pair_kernel(which, cfg, cuda)
    assert bool((rk < 0).any()) == (n % 4**nlevels != 0)
    got = _twice(run)
    tol = 1e-10 if dtype == "f64" else 1e-5
    assert _rel(torch.complex(*got), torch.complex(*plain())) <= tol


@pytest.mark.parametrize("which", PAIR_KERNELS)
def test_eval_fused_keeps_a_coincident_pair_non_finite(cuda, which):
    """Two distinct particles of one leaf at one position: both targets'
    phi non-finite in kernel and plain version alike, every other target
    finite and equal."""
    cfg = FmmConfig(n=1 << 12, nlevels=3, p=17, dtype="f64")
    run, plain, zr, zi, _ = _pair_kernel(which, cfg, cuda, seed=4)
    zr[0, 5, 9], zi[0, 5, 9] = zr[0, 5, 2], zi[0, 5, 2]
    got = torch.complex(*_twice(run))
    ref = torch.complex(*plain())
    bad = ~torch.isfinite(got)
    assert torch.equal(bad, ~torch.isfinite(ref))
    assert bad[0, 5, 2] and bad[0, 5, 9] and int(bad.sum()) == 2
    assert _rel(got[~bad], ref[~bad]) <= 1e-10


@pytest.mark.parametrize("which", PAIR_KERNELS)
def test_eval_fused_padded_slot_at_a_target_stays_out(cuda, which):
    """A padded source slot sits at z = 0; a particle moved to 0 must not
    meet it as 0 * inf: the padded slot is never read."""
    cfg = FmmConfig(n=(1 << 12) - 30, nlevels=3, p=17, dtype="f64")
    run, plain, zr, zi, rk = _pair_kernel(which, cfg, cuda, seed=5)
    leaf = int(torch.nonzero((rk < 0).any(-1))[0])
    assert float(zr[0, leaf, -1]) == 0 and float(zi[0, leaf, -1]) == 0
    zr[0, leaf, 0], zi[0, leaf, 0] = 0.0, 0.0
    got = torch.complex(*_twice(run))
    ref = torch.complex(*plain())
    valid = rk[None] >= 0
    assert bool(torch.isfinite(got[valid]).all())
    assert _rel(got[valid], ref[valid]) <= 1e-10


def _lattice(m, cuda, seed):
    """m * m particles on a square lattice of the unit square (rows share
    y, columns share x) with N(0, 1) complex charges."""
    g = (torch.arange(m, dtype=torch.float64) + 0.5) / m
    z = torch.complex(g.repeat(m), g.repeat_interleave(m))
    gen = torch.Generator().manual_seed(seed)
    q = torch.complex(*torch.randn(2, m * m, generator=gen,
                                   dtype=torch.float64))
    return z.to(cuda), q.to(cuda)


@pytest.mark.parametrize("which", PAIR_KERNELS)
@pytest.mark.parametrize("m,nlevels", [(128, 4),    # n 64: the NF = 64 loop
                                       (54, 3)])    # n_max 46: generic n
def test_log_branch_on_a_lattice_matches_plain(cuda, which, m, nlevels):
    """The f64 log branch where particles share coordinates: pairs with
    dy = +-0 on both sides of the target (atan2's branch cut: arg(z - x)
    = -pi where x lies right of z on its row) and dx = +-0; the real and
    the imaginary part each within 1e-10 of the plain version (the other
    side of the cut would be off by 2 pi q)."""
    cfg = FmmConfig(n=m * m, nlevels=nlevels, p=17, dtype="f64",
                    kernel="log")
    run, plain, _, _, _ = _pair_kernel(which, cfg, cuda,
                                       zq=_lattice(m, cuda, 8))
    got, ref = _twice(run), plain()
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        assert _rel(a, b) <= 1e-10


@pytest.mark.parametrize("which", PAIR_KERNELS)
def test_log_branch_keeps_a_coincident_pair_non_finite(cuda, which):
    """As the harmonic test: two distinct particles of one leaf at one
    position give both targets a non-finite phi (log 0), in the kernel
    and in the plain version; every other target finite and equal."""
    cfg = FmmConfig(n=1 << 12, nlevels=3, p=17, dtype="f64", kernel="log")
    run, plain, zr, zi, _ = _pair_kernel(which, cfg, cuda, seed=4)
    zr[0, 5, 9], zi[0, 5, 9] = zr[0, 5, 2], zi[0, 5, 2]
    got = torch.complex(*_twice(run))
    ref = torch.complex(*plain())
    bad = ~torch.isfinite(got)
    assert torch.equal(bad, ~torch.isfinite(ref))
    assert bad[0, 5, 2] and bad[0, 5, 9] and int(bad.sum()) == 2
    assert _rel(got[~bad], ref[~bad]) <= 1e-10


def test_log_branch_replays_bitwise_and_counts_its_launches(cuda):
    """``apply`` of the f64 log config: its program launches the fused
    evaluation (``eval_fused_f64``, the log branch) once in the eager
    first call and records it once in the capture, a replay launches
    nothing, and every call is bitwise the eager one; the f32 log and
    the f64 harmonic solvers leave the log solver's programs as they
    were."""
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f64", kernel="log")
    z, q = particles("layer", cfg.n, 7, device=cuda)
    solver = FmmSolver(cfg, "cuda")

    def state():
        return [(dict(p.launches), dict(p.recorded), p.calls, p.replays)
                for p in solver.programs().values()]

    ref = solver.apply(z, q)
    (prog,) = solver.programs().values()
    assert prog.launches["eval_fused"] == 1 and prog.recorded == {}
    for _ in range(3):                       # capture + replay, 2 replays
        assert torch.equal(solver.apply(z, q), ref)
    assert prog.launches["eval_fused"] == 1
    assert prog.recorded["eval_fused"] == 1
    assert [p.replays for p in solver.programs().values()] == [3]
    before = state()
    for other in (dataclasses.replace(cfg, dtype="f32"),
                  dataclasses.replace(cfg, kernel="harmonic")):
        FmmSolver(other, "cuda").apply(z, q)
    assert state() == before
    solver._release_executables()


@pytest.mark.parametrize("which,cap", [("eval_fused", 256), ("p2p", 512)])
def test_log_branch_opts_in_beside_its_tables(cuda, which, cap):
    """Leaves of 128 particles and wide lists: each f64 log launch gives
    its warps 45,056 bytes of dynamic shared memory, under 48 KB alone
    but not beside the clog tables' 6,208 static bytes, so the launch
    must opt in above 48 KB (without it the launch fails as an invalid
    argument). Against the plain version, twice bitwise equal."""
    from repro_torch.kernels.build import LIBRARIES
    assert LIBRARIES[which].smem_bytes(8, 128, 18, cap) == 45056
    cfg = FmmConfig(n=1 << 15, nlevels=4, p=17, dtype="f64", kernel="log",
                    strong_cap=cap)
    run, plain, _, _, _ = _pair_kernel(which, cfg, cuda, seed=3)
    got = _twice(run)
    assert _rel(torch.complex(*got), torch.complex(*plain())) <= 1e-10


def _clog_cpu():
    """``tests/test_torch_clog.py`` as a module: its draws and ``_ulps``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "clog_cpu", ROOT / "tests" / "test_torch_clog.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pair_logs(dx, dy, cuda):
    """The P2P kernel's f64 log branch over one leaf a pair: a target at 0
    without charge and a source at (dx, dy) with charge 1, each leaf's
    list itself. The target's phi is then exactly the pair's (log|d|,
    arg(-d)), d = source - target, but for the sign of a zero."""
    nb = len(dx)
    zero = np.zeros(nb)

    def plane(a, b):
        return torch.from_numpy(np.stack([a, b], -1)[None]).to(cuda)

    zr, zi, qr = plane(zero, dx), plane(zero, dy), plane(zero, zero + 1)
    lists = torch.arange(nb, dtype=torch.int32, device=cuda).view(1, nb, 1)
    rk = torch.arange(2 * nb, dtype=torch.int32, device=cuda).view(nb, 2)
    out = _twice(lambda: p2p_cuda(lists, zr, zi, qr, torch.zeros_like(zr),
                                  rk, kernel="log"))
    return tuple(o[0, :, 0].cpu().numpy() for o in out)


def test_log_pairs_on_the_card_within_two_ulp_of_numpy(cuda):
    """The compiled pair logarithm, pair by pair, on the CPU test's draws
    (10^6 pairs) and on every pair of {+-0, +-v}: arg(-d) within 2 ulp of
    numpy's arctan2 and equal to it on the exact classes (an axis, the
    branch cut's +-pi included, or |dx| = |dy|), log|d| within 2 ulp of numpy's log(d2) / 2 on pairs whose
    dx and dy are cut to 26 significant bits (both squares exact, so d2
    rounds once whichever product the compiler fuses into the sum and
    equals numpy's) and within 1 ulp on the axes, -inf where d = 0.
    Prints the largest errors."""
    clog = _clog_cpu()
    dx, dy = clog._draw(np.random.default_rng(20261019), 1 << 20)
    keep = ~np.uint64((1 << 27) - 1)

    def cut(x):
        return (x.view(np.uint64) & keep).view(np.float64)

    v = np.array([0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 3.0, -3.0, 1e-30, -1e-30,
                  1e30, -1e30, 0.7071067811865476, -0.7071067811865476])
    ex, ey = np.repeat(v, len(v)), np.tile(v, len(v))
    nd = len(dx)
    re_, im = _pair_logs(np.concatenate([dx, cut(dx), ex]),
                         np.concatenate([dy, cut(dy), ey]), cuda)
    X, Y = np.concatenate([dx, cut(dx)]), np.concatenate([dy, cut(dy)])
    ulp_im = clog._ulps(im[:2 * nd], np.arctan2(-Y, -X))
    cx, cy = X[nd:], Y[nd:]
    ulp_re = clog._ulps(re_[nd:2 * nd], 0.5 * np.log(cx * cx + cy * cy))
    print(f"card clog: arg max {ulp_im.max():.3f} ulp "
          f"(<= 1: {(ulp_im <= 1).mean():.6f}); log max {ulp_re.max():.3f} "
          f"ulp (<= 1: {(ulp_re <= 1).mean():.6f}) over {nd} pairs")
    assert ulp_im.max() <= 2 and ulp_re.max() <= 2
    zero, axis = (ex == 0) & (ey == 0), (ex == 0) != (ey == 0)
    exact = axis | ((np.abs(ex) == np.abs(ey)) & ~zero)
    want = np.arctan2(-ey, -ex)
    assert np.isneginf(re_[2 * nd:][zero]).all()
    assert np.array_equal(im[2 * nd:][exact], want[exact])
    assert clog._ulps(im[2 * nd:][~zero], want[~zero]).max() <= 2
    wre = 0.5 * np.log(ex[axis] ** 2 + ey[axis] ** 2)    # one product
    assert clog._ulps(re_[2 * nd:][axis], wre).max() <= 1


def _p2l_args(cfg, cuda, seed, dists=("uniform", "normal")):
    """The P2L kernel's operands of one problem per distribution (B =
    len(dists))."""
    zs, qs = zip(*(particles(d, cfg.n, seed, device=cuda) for d in dists))
    plan = F.fmm_build(torch.stack(zs), torch.stack(qs), cfg)
    rho = F.effective_radii(plan.tree, cfg)
    return p2l_operands(plan.tree, plan.conn, cfg, rho[-1])


@pytest.mark.parametrize("n,nlevels,p,dtype,kernel", [
    (1 << 14, 4, 17, "f64", "harmonic"),  # n_max 64, P = 18: registers
    (1 << 14, 4, 17, "f32", "harmonic"),
    (1 << 14, 4, 17, "f64", "log"),
    (1 << 14, 4, 17, "f32", "log"),
    ((1 << 14) - 200, 4, 17, "f64", "harmonic"),   # padded tails
    (3000, 3, 17, "f64", "log"),          # n_max 47: generic n
    (6000, 3, 17, "f32", "harmonic"),     # n_max 94: generic n
    (1 << 14, 4, 8, "f64", "harmonic"),   # generic P: shared accumulators
    (1 << 14, 4, 30, "f64", "log"),
    (1 << 14, 4, 30, "f32", "harmonic"),
])
def test_p2l_kernel_instantiations_and_batch(cuda, n, nlevels, p, dtype,
                                             kernel):
    """B = 2 (uniform, normal) against the plain version, the normal
    plan's leaf with the most entries on its own; two launches bitwise
    equal, each row bitwise equal to a launch of that problem alone, and
    every leaf with no entry exactly 0."""
    cfg = FmmConfig(n=n, nlevels=nlevels, p=p, dtype=dtype, kernel=kernel)
    args, kw = _p2l_args(cfg, cuda, seed=8)
    lists = args[0]
    got = _twice(lambda: p2l_cuda(*args, **kw))
    ref = p2l_plain(*args, **kw)
    tol = 1e-10 if dtype == "f64" else 1e-4
    gc, rc = torch.complex(*got), torch.complex(*ref)
    assert _rel(gc, rc) <= tol
    full = int((lists[1] >= 0).sum(-1).argmax())
    assert int((lists[1, full] >= 0).sum()) > 1
    assert _rel(gc[1, full], rc[1, full]) <= tol
    empty = ~(lists >= 0).any(-1)
    assert bool(empty.any()) and bool((~empty).any())
    assert bool((got[0][empty] == 0).all() and (got[1][empty] == 0).all())
    for b in range(2):
        one = [a[b:b + 1].contiguous() for a in args]
        alone = p2l_cuda(*one, **kw)
        assert all(torch.equal(x[b], y[0]) for x, y in zip(got, alone))


def _density_plan(cfg, dist, K, cuda, seed=11):
    """A one-problem plan of ``dist`` with K real N(0, 1) densities in
    place of its charges (``with_charges``: (K, N) charges, one
    geometry), its effective radii, and the plain upward and downward
    passes' (K, ...) multipoles and leaf locals."""
    z, q = particles(dist, cfg.n, seed, device=cuda)
    plan = F.fmm_build(z[None].to(cfg.torch_complex),
                       q[None].to(cfg.torch_complex), cfg)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    Q = torch.randn((K, cfg.n), generator=gen, device=cuda,
                    dtype=torch.float64).to(cfg.torch_complex)
    plan = F.with_charges(plan, Q)
    rho = F.effective_radii(plan.tree, cfg)
    mult = upward_plain(plan.tree, cfg, rho)
    local = F.downward(mult, plan.tree, plan.conn, cfg)
    return plan, rho, mult, local


BLOCK_TOL = {"f64": 1e-10, "f32": 1e-5}


@pytest.mark.parametrize("K", [3, 8, 11])
@pytest.mark.parametrize("dist", ["layer", "wires8"])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_density_kernels_match_their_plain_twins(cuda, K, dist, dtype,
                                                 kernel):
    """K densities on one 2^14 plan (the layer points, with P2L and M2P
    entries; the wire contours; K = 11 runs M2L and the evaluation as a
    launch of 8 and three single-density ones): the upward pass, the
    level-fused M2L, P2L and the fused evaluation each against its plain
    version within 1e-10 (f64) / 1e-5 (f32) scaled, two launches bitwise
    equal, and each density of the grid-axis kernels (upward, P2L) and of
    M2L bitwise that density alone through the K = 1 kernel."""
    from repro_torch.kernels.common import density_chunks

    smoke = _smoke()
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype=dtype, kernel=kernel,
                    strong_cap=96, weak_cap=256)
    plan, rho, mult, local = _density_plan(cfg, dist, K, cuda)
    tree, conn = plan.tree, plan.conn
    tol = BLOCK_TOL[dtype]
    chunks = len(density_chunks(K))

    def single(k):
        return tree._replace(q=tree.q[k:k + 1].contiguous())

    # upward
    reset_launch_counts()
    got = torch.view_as_complex(_twice(lambda: (torch.view_as_real(
        torch.cat(upward_cuda(tree, cfg, rho), dim=1)),))[0])
    assert launch_counts()["upward"] == 2 * upward_launches(cfg.nlevels)
    assert smoke.scaled_err(got, torch.cat(mult, dim=1)) <= tol
    for k in range(K):
        alone = torch.cat(upward_cuda(single(k), cfg, rho), dim=1)
        assert torch.equal(_bits(torch.view_as_real(got[k:k + 1])),
                           _bits(torch.view_as_real(alone))), k
    # level-fused M2L
    args, _ = m2l_operands(mult, conn.weak, tree.centers, cfg, rho)
    reset_launch_counts()
    got = torch.complex(*_twice(lambda: m2l_cuda(*args)))
    assert launch_counts()["m2l"] == 2 * chunks
    assert smoke.scaled_err(got, torch.complex(*m2l_plain(*args))) <= tol
    for k in range(K):
        one = list(args)
        one[1], one[2] = args[1][k:k + 1], args[2][k:k + 1]
        alone = torch.complex(*m2l_cuda(*one))
        assert torch.equal(_bits(torch.view_as_real(got[k:k + 1])),
                           _bits(torch.view_as_real(alone))), k
    # P2L
    args, kw = p2l_operands(tree, conn, cfg, rho[-1])
    reset_launch_counts()
    got = torch.complex(*_twice(lambda: p2l_cuda(*args, **kw)))
    assert launch_counts()["p2l"] == 2
    ref = torch.complex(*p2l_plain(*args, **kw))
    assert smoke.scaled_err(got, ref) <= tol or float(ref.abs().max()) == 0
    for k in range(K):
        alone = p2l_operands(single(k), conn, cfg, rho[-1])[0]
        alone = torch.complex(*p2l_cuda(*alone, **kw))
        assert torch.equal(_bits(torch.view_as_real(got[k:k + 1])),
                           _bits(torch.view_as_real(alone))), k
    # fused evaluation
    args, kw = eval_operands(local, mult[-1], tree, conn, cfg)
    reset_launch_counts()
    got = torch.complex(*_twice(lambda: eval_fused_cuda(*args, **kw)))
    assert launch_counts()["eval_fused"] == 2 * chunks
    ref = torch.complex(*eval_fused_plain(*args, **kw))
    err = smoke.scaled_err(got, ref)
    print(f"density kernels [{kernel}/{dtype}/{dist}/K={K}]: eval {err:.2e}")
    assert err <= tol


@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_p2l_kernel_masks_a_source_on_the_target_center(cuda, kernel):
    """A source particle exactly on its target leaf's center contributes
    0 (the d2 > 0 mask), as in the plain version: the result is finite
    and bitwise that of the same particle with no charge."""
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f64", kernel=kernel)
    args, kw = _p2l_args(cfg, cuda, seed=9, dists=("normal",))
    lists, cr, ci, _, xr, xi, qr, qi = args
    tgt = int(torch.nonzero((lists[0] >= 0).any(-1))[0])
    src = int(lists[0, tgt][lists[0, tgt] >= 0][0])
    xr[0, src, 0], xi[0, src, 0] = cr[0, tgt], ci[0, tgt]
    got = _twice(lambda: p2l_cuda(*args, **kw))
    ref = p2l_plain(*args, **kw)
    assert bool(torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all())
    assert _rel(torch.complex(*got), torch.complex(*ref)) <= 1e-10
    qr[0, src, 0], qi[0, src, 0] = 0.0, 0.0
    without = p2l_cuda(*args, **kw)
    assert all(torch.equal(a[0, tgt], b[0, tgt])
               for a, b in zip(got, without))


@pytest.mark.parametrize("p,kernel,dtype", [(17, "harmonic", "f64"),
                                            (17, "log", "f64"),
                                            (17, "harmonic", "f32"),
                                            (8, "harmonic", "f64")])
def test_m2l_kernel_ragged_tile_and_batch(cuda, p, kernel, dtype):
    """B = 2 on a box axis that the kernel's tiles (128 // (p+1) boxes)
    do not divide: against the plain version, two launches bitwise equal,
    each row bitwise equal to a launch of that problem alone, and the
    boxes with no weak entries (level 1) exactly 0."""
    cfg = FmmConfig(n=1 << 12, nlevels=4, p=p, dtype=dtype, kernel=kernel)
    zs, qs = zip(*(particles(d, cfg.n, 6, device=cuda)
                   for d in ("uniform", "normal")))
    plan = F.fmm_build(torch.stack(zs), torch.stack(qs), cfg)
    mult = F.upward(plan.tree, cfg)
    rho = F.effective_radii(plan.tree, cfg)
    args, _ = m2l_operands(mult, plan.conn.weak, plan.tree.centers, cfg, rho)
    weak = args[0]
    assert weak.shape[:2] == (2, 340) and 340 % (128 // (p + 1)) != 0
    got = _twice(lambda: m2l_cuda(*args))
    ref = m2l_plain(*args)
    tol = 1e-10 if dtype == "f64" else 2e-5
    assert _rel(torch.complex(*got), torch.complex(*ref)) <= tol
    empty = ~(weak >= 0).any(-1)
    assert bool(empty[:, :4].all())
    assert bool((got[0][empty] == 0).all() and (got[1][empty] == 0).all())
    for b in range(2):
        one = [a[b:b + 1].contiguous() if a.dim() >= 2 else a
               for a in args[:6]] + list(args[6:])
        alone = m2l_cuda(*one)
        assert all(torch.equal(x[b], y[0]) for x, y in zip(got, alone))


def test_m2l_kernel_weak_rows_with_gaps(cuda):
    """The occupied slots spread over a twice as wide row, -1 between
    them: the kernel compacts them back into the same order, so the
    result is bitwise that of the packed rows."""
    cfg = FmmConfig(n=1 << 12, nlevels=4, p=17, dtype="f64", kernel="log")
    z, q = particles("layer", cfg.n, 7, device=cuda)
    plan = F.fmm_build(z[None], q[None], cfg)
    mult = F.upward(plan.tree, cfg)
    rho = F.effective_radii(plan.tree, cfg)
    args, _ = m2l_operands(mult, plan.conn.weak, plan.tree.centers, cfg, rho)
    weak = args[0]
    gapped = torch.full(weak.shape[:2] + (2 * weak.shape[2],), -1,
                        dtype=weak.dtype, device=cuda)
    gapped[..., 1::2] = weak
    spread = (gapped,) + tuple(args[1:])
    got = _twice(lambda: m2l_cuda(*spread))
    packed = m2l_cuda(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, packed))
    ref = m2l_plain(*spread)
    assert _rel(torch.complex(*got), torch.complex(*ref)) <= 1e-10


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("W", [7680, 12288])
def test_m2l_kernel_takes_any_weak_width(cuda, dtype, W):
    """Weak rows wider than one tile's shared memory could hold whole
    (7,008 slots in f64 and 7,654 in f32 at p = 17 before the rows were
    staged in chunks): against the plain version, twice bitwise equal,
    empty boxes exactly 0, shared memory as at any W above a chunk."""
    from repro_torch.kernels.build import LIBRARIES
    smoke = _smoke()
    args = smoke.wide_m2l_operands(W, dtype, torch)
    got = _twice(lambda: m2l_cuda(*args))
    ref = m2l_plain(*args)
    tol = 1e-10 if dtype == "f64" else 2e-5
    assert smoke.scaled_err(torch.complex(*got), torch.complex(*ref)) <= tol
    empty = ~(args[0] >= 0).any(-1)
    assert bool(empty.any())
    assert bool((got[0][empty] == 0).all() and (got[1][empty] == 0).all())
    sz = 8 if dtype == "f64" else 4
    lib = LIBRARIES["m2l"]
    assert lib.smem_bytes(sz, 64, 18, W) == lib.smem_bytes(sz, 64, 18, 1024)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_m2l_rows_spread_over_a_wide_row_are_bitwise_the_packed(cuda, dtype):
    """128-wide rows spread over 12,288 slots (in slot order, -1
    between): the chunks cut the rows but not the order of any sum."""
    smoke = _smoke()
    args = smoke.wide_m2l_operands(128, dtype, torch)
    packed = m2l_cuda(*args)
    spread = (smoke.spread_rows(args[0], 12288),) + tuple(args[1:])
    got = _twice(lambda: m2l_cuda(*spread))
    assert all(torch.equal(a, b) for a, b in zip(got, packed))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_refresh_apply_plan_launches_and_is_bitwise_apply(cuda, dtype):
    """Three steps on moved particles: refresh launches classify once a
    level, apply_plan the upward pass (two launches at four levels) and
    M2L, P2L and the fused evaluation once each (from
    the host at a program's first call, recorded into its graph at the
    second, replayed after; ``stats`` calls ``refresh`` too, so the
    refresh program captures in the first step); phi bitwise apply's;
    prepared once per half; no overflow."""
    smoke = _smoke()
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype=dtype)
    z, q = particles("uniform", cfg.n, 11, device=cuda)
    solver = FmmSolver(cfg)
    none = _main_counts(0, upward=0, m2l=0, p2l=0, eval_fused=0)
    for step in range(3):
        zk = smoke.perturbed(z, step)
        want = dict(none, classify=cfg.nlevels)
        plan, host, rec = _runs(lambda: solver.refresh(zk, q))
        assert (host, rec) == [(want, none), (none, none),
                               (none, none)][step]
        want = dict(none, upward=upward_launches(cfg.nlevels), m2l=1,
                    p2l=1, eval_fused=1)
        phi, host, rec = _runs(lambda: solver.apply_plan(plan))
        assert (host, rec) == [(want, none), (none, want),
                               (none, none)][step]
        assert torch.equal(phi, solver.apply(zk, q))
        assert solver.stats(zk, q)["overflow"] == 0
    assert solver.trace_counts == {"build": 1, "evaluate": 1}


def _nbody_planes(n, m, dtype, cuda, seed):
    """Real planes (tzr, tzi, szr, szi, qr, qi) on the card: m sources in
    the unit square, n targets of which a third (at most m) sit on
    source positions (dropped from their sums by the d2 > 0
    exclusion)."""
    rng = np.random.default_rng(seed)
    zs = rng.uniform(0, 1, m) + 1j * rng.uniform(0, 1, m)
    q = rng.normal(size=m) + 1j * rng.normal(size=m)
    zt = rng.uniform(0, 1, n) + 1j * rng.uniform(0, 1, n)
    k = min(n // 3, m)
    zt[:k] = zs[rng.choice(m, k, replace=False)]
    rdt = torch.float32 if dtype == "f32" else torch.float64
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda, rdt)
                 for z in (zt, zs, q) for a in (z.real, z.imag))


def _magnitude_sum(tzr, tzi, szr, szi, qr, qi):
    """S_i = sum_{x_j != y_i} |q_j| / |x_j - y_i| in f64: the scale of an
    f32 all-pairs sum's rounding error (as chip_smoke.py gates it)."""
    qa = torch.hypot(qr.double(), qi.double())
    out = torch.zeros_like(tzr, dtype=torch.float64)
    step = max(1, (1 << 24) // tzr.numel())
    for s in range(0, szr.numel(), step):
        r = torch.hypot(szr[None, s:s + step].double() - tzr[:, None].double(),
                        szi[None, s:s + step].double() - tzi[:, None].double())
        out += torch.where(r > 0, qa[None, s:s + step] / r.clamp_min(1e-300),
                           torch.zeros_like(r)).sum(-1)
    return out


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", ["split", "split-4096", "unsplit"])
def test_nbody_kernel_with_and_without_the_source_split(cuda, dtype, shape):
    """The N-body kernel against its plain version at a ragged N and M
    with coincident positions: 37 x 5000 and 4133 x 20011 (split sources,
    the partials reduced in the launch) and enough targets that the tiles
    fill the card alone (one split). One launch a call, finite, two
    launches bitwise equal; f64 within 1e-10, f32 within 1e-4 of
    sum |q| / |x - y| per target."""
    from repro_torch.kernels.nbody.nbody import (BLOCKS_PER_SM, THREADS,
                                                 TARGETS_PER_THREAD)
    elem = 4 if dtype == "f32" else 8
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    n, m = {"split": (37, 5000), "split-4096": (4133, 20011),
            "unsplit": (BLOCKS_PER_SM * sms * THREADS
                        * TARGETS_PER_THREAD[elem] + 37, 1001)}[shape]
    _, splits, _ = nbody_plan(n, m, elem, sms)
    assert (splits > 1) == shape.startswith("split")
    args = _nbody_planes(n, m, dtype, cuda, seed=n + m)
    reset_launch_counts()
    got = _twice(lambda: nbody_cuda(*args))
    assert launch_counts()["nbody"] == 2
    ref = nbody_plain(*args)
    diff = (torch.complex(*got) - torch.complex(*ref)).abs()
    assert bool(torch.isfinite(diff).all())
    if dtype == "f64":
        assert float(diff.max()) <= 1e-10 * float(torch.complex(*ref).abs()
                                                  .max())
    else:
        assert float((diff.double() / _magnitude_sum(*args)).max()) <= 1e-4


def _l2p_synthetic(B, nb, n, p, dtype, cuda, seed, offset=0):
    """Seeded L2P operands: (B, nb, p+1) coefficients, (B, nb, n)
    positions |t| < 1, (nb, n) ranks with every third leaf's tail padded
    (-1). ``offset`` > 0 cuts the position planes from a longer buffer,
    so they start off the 16-byte grid."""
    rng = np.random.default_rng(seed)
    rdt = torch.float32 if dtype == "f32" else torch.float64

    def plane(*shape, scale=1.0):
        a = torch.from_numpy(scale * rng.uniform(-1, 1, shape)).to(rdt)
        if offset:
            buf = torch.zeros(a.numel() + offset, dtype=rdt)
            buf[offset:] = a.reshape(-1)
            return buf.to(cuda)[offset:].view(shape)
        return a.to(cuda)

    br, bi = plane(B, nb, p + 1), plane(B, nb, p + 1)
    tr, ti = plane(B, nb, n, scale=0.7), plane(B, nb, n, scale=0.7)
    rk = torch.arange(nb * n, dtype=torch.int32).view(nb, n)
    for box in range(0, nb, 3):
        rk[box, n - 1 - box % n:] = -1
    return br, bi, tr, ti, rk.to(cuda)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("n,p,offset", [(40, 17, 0), (64, 17, 0),
                                        (33, 17, 0), (94, 17, 0),
                                        (40, 70, 0), (64, 17, 1)])
def test_l2p_kernel_leaf_widths_and_batch(cuda, dtype, n, p, offset):
    """B = 2 over 37 leaves (no multiple of a block's 16): n = 40 and 64
    (paired 8/16-byte loads), 33 (odd: one slot a load), 94 (two passes
    of 64 slots), P = 71 (more coefficients than lanes), planes off the
    16-byte grid (one slot a load). Against the plain
    version, padded slots exactly 0, two launches bitwise equal."""
    args = _l2p_synthetic(2, 37, n, p, dtype, cuda, seed=n + p, offset=offset)
    assert args[2].is_contiguous()
    got = _twice(lambda: l2p_cuda(*args, p=p))
    ref = l2p_plain(*args, p=p)
    pad = args[-1] < 0
    assert bool(pad.any())
    assert bool((got[0][:, pad] == 0).all() and (got[1][:, pad] == 0).all())
    tol = 1e-10 if dtype == "f64" else 1e-5
    assert _rel(torch.complex(*got), torch.complex(*ref)) <= tol


def test_fault_walk_on_the_card(cuda, monkeypatch):
    """``chip_smoke``'s fault walk (the five cases of
    ``repro_torch.testing.faults``) at N = 2^14, f64, "cuda": each case's
    rungs and final backend as the CPU parity tests hold them, the four
    kernels once a FMM rung, classify and M2L only in the degrade rung,
    none in the direct rung (counted through the guard's ``rung_hook``),
    one ``BackendDowngradeWarning`` for each of those two rungs, a
    poisoned input refused."""
    from repro_torch.solver.program import Program

    smoke = _smoke()
    monkeypatch.setattr(smoke, "FAULT_N", 1 << 14)
    monkeypatch.setattr(Program, "__call__", Program.__call__)
    smoke.observe_programs()           # the walk's gates read program calls
    smoke.fault_walk(torch)


@pytest.mark.parametrize("case", ["nan", "overflow"])
def test_plain_rungs_warn_on_the_card(cuda, case):
    """On the card a rung that serves the answer from plain torch (the
    degrade rung, the direct rung) warns, naming the rung that failed
    and why; the report names the rung too."""
    from repro_torch.errors import BackendDowngradeWarning
    from repro_torch.solver import GuardedSolver
    from repro_torch.testing import force_cap_overflow, nan_coefficients

    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f64")
    z, q = particles("uniform", cfg.n, 2, device=cuda)
    if case == "nan":
        fault = nan_coefficients("cuda", "eval_fused")
        rung = "degrade:cuda+ref-eval"
        why = r"rung 'primary' on 'cuda' failed \(non-finite output\)"
    else:
        fault = force_cap_overflow(strong=1, weak=1)
        rung = "direct"
        why = r"rung 'caps\*\d+/\d+' on 'cuda' failed \(overflow \d+\)"
    with fault, pytest.warns(BackendDowngradeWarning, match=why) as rec:
        g = GuardedSolver(cfg, max_cap_doublings=1)
        phi, rep = g.apply_guarded(z, q)
    assert rep.ok and rep.final_rung == rung and rep.degradations == (rung,)
    msgs = [str(w.message) for w in rec
            if issubclass(w.category, BackendDowngradeWarning)]
    assert len(msgs) == 1 and f"serving from {rung!r}" in msgs[0]
    assert phi.device.type == "cuda" and bool(torch.isfinite(phi).all())


@pytest.mark.parametrize("name", ["classify", "upward", "m2l", "p2l",
                                  "eval_fused"])
def test_kernel_launch_error_propagates_out_of_apply_guarded(cuda,
                                                              monkeypatch,
                                                              name):
    """A kernel whose launch fails is not a rung: the error leaves
    ``apply_guarded`` as it leaves ``apply``, with no walk to the plain
    sweeps or to the direct sum."""
    from repro_torch.errors import FmmError
    from repro_torch.kernels.build import LIBRARIES
    from repro_torch.solver import GuardedSolver

    def failing(symbol, *args):
        raise RuntimeError(f"{name}:{symbol} launch failed: injected "
                           "(cudaError 700)")

    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f64")
    z, q = particles("normal", cfg.n, 2, device=cuda)
    FmmSolver.cache_clear()        # a fresh solver launches from the host
    g = GuardedSolver(cfg)
    assert g.device.type == "cuda" and g.solver.dispatched["apply"] == "cuda"
    monkeypatch.setattr(LIBRARIES[name], "launch", failing)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="launch failed") as ei:
        g.apply_guarded(z, q)
    assert not isinstance(ei.value, FmmError)
    assert launch_counts()["nbody"] == 0


@pytest.mark.parametrize("dist", ["uniform", "normal"])
def test_tune_and_guard_on_the_card(cuda, dist):
    """``tune`` probes with one classify launch a level each; the tuned
    solver and the guard's escalated one launch the four kernels once an apply
    and match the reference backend's phi within 1e-10 (f64)."""
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f64")
    z, q = particles(dist, cfg.n, 4, device=cuda)
    solver = FmmSolver.build(cfg)
    reset_launch_counts()
    tuned = solver.tune(z, q)
    probes = len(tuned.tune_result.trials)
    assert launch_counts() == _main_counts(probes * cfg.nlevels, upward=0,
                                           m2l=0, p2l=0, eval_fused=0)
    # its first call (from the host) or, where the other distribution
    # tuned to the same caps, its second (recorded into the capture)
    phi, host, rec = _runs(lambda: tuned.apply_checked(z, q))
    assert {k: host[k] + rec[k] for k in host} == _main_counts(cfg.nlevels)
    ref = FmmSolver.build(tuned.cfg, backend="reference").apply(z, q)
    assert _rel(phi, ref) <= 1e-10
    (gphi, rep), host, rec = _runs(
        lambda: solver.guarded().apply_guarded(z, q))
    assert rep.ok and rep.degradations == ()
    n = len(rep.attempts)
    # each rung's solver runs its health program for the first time
    # (eagerly) or the second (a capture): one launch a kernel a rung
    assert {k: host[k] + rec[k] for k in host} == \
        {k: v * n for k, v in _main_counts(cfg.nlevels).items()}
    gref = FmmSolver.build(dataclasses.replace(
        cfg, strong_cap=rep.attempts[-1].strong_cap,
        weak_cap=rep.attempts[-1].weak_cap), backend="reference").apply(z, q)
    assert _rel(gphi, gref) <= 1e-10


# ---------------------------------------------------------------------------
# the serving plane on the card
# ---------------------------------------------------------------------------

def _serve_plane(**kw):
    """A plane on the card on the lattice 1024 / 2048 (two levels and
    more: every main-path kernel launches), default config (f32, p = 17,
    caps 48/128)."""
    from repro_torch.serve import BucketLattice, ServePlane
    kw.setdefault("direct_max", 4096)
    return ServePlane(BucketLattice(sizes=(1024, 2048)), max_batch=4, **kw)


def _request(n, seed):
    from repro_torch.data import particles_numpy
    return particles_numpy("uniform", n, seed)


@pytest.mark.parametrize("name", ["classify", "upward", "m2l", "p2l",
                                  "eval_fused"])
def test_kernel_launch_error_propagates_out_of_serve(cuda, monkeypatch,
                                                     name):
    """A kernel whose launch fails is not shed: the error leaves
    ``ServePlane.serve`` (no walk to the next bucket, the reference
    backend or the direct sum)."""
    from repro_torch.errors import FmmError
    from repro_torch.kernels.build import LIBRARIES
    from repro_torch.serve import Request

    def failing(symbol, *args):
        raise RuntimeError(f"{name}:{symbol} launch failed: injected "
                           "(cudaError 700)")

    FmmSolver.cache_clear()        # a fresh solver launches from the host
    plane = _serve_plane()
    monkeypatch.setattr(LIBRARIES[name], "launch", failing)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="launch failed") as ei:
        plane.serve([Request(*_request(1000, 1))])
    assert not isinstance(ei.value, FmmError)
    assert plane.counters["shed_walks"] == 0
    assert launch_counts()["nbody"] == 0


@pytest.mark.parametrize("walk", ["bucket", "reference", "oversize"])
def test_shed_walk_on_the_card(cuda, monkeypatch, walk):
    """``shed:bucket`` serves from the kernels of the next bucket without
    a warning; ``shed:reference`` (plain torch, after both buckets fail)
    and ``oversize->direct`` warn once each, naming the step."""
    from repro_torch.errors import (BackendDowngradeWarning,
                                    RecoveryExhaustedError)
    from repro_torch.serve import Request
    from repro_torch.solver import GuardedSolver

    plane = _serve_plane()
    failing = {"bucket": {1024}, "reference": {1024, 2048},
               "oversize": set()}[walk]
    for entry in ("apply_batched_guarded", "apply_guarded"):
        real = getattr(GuardedSolver, entry)

        def fail(g, z, q, real=real):
            if g.cfg.n in failing and g.backend_name == "auto":
                raise RecoveryExhaustedError("injected")
            return real(g, z, q)
        monkeypatch.setattr(GuardedSolver, entry, fail)
    n = 3000 if walk == "oversize" else 1000
    z, q = _request(n, 2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (phi, rep), = plane.serve([Request(z, q)])
    said = [str(w.message) for w in caught
            if issubclass(w.category, BackendDowngradeWarning)]
    step, backend = {"bucket": (None, "cuda"),
                     "reference": ("shed:reference", "reference"),
                     "oversize": ("oversize->direct", "direct")}[walk]
    assert rep.status == "degraded" and rep.backend == backend
    if step is None:
        assert said == [] and "shed:bucket:2048" in rep.path
    else:
        assert len(said) == 1 and f"step {step!r}" in said[0]
        assert step in rep.path
    from repro_torch.core import direct_potential_numpy
    ref = direct_potential_numpy(z, z, q)
    assert phi.shape == (n,)
    assert np.abs(phi - ref).max() <= 5e-4 * np.abs(ref).max()


def test_plan_cache_warm_on_the_card(cuda):
    """``PlanCache.warm`` launches each main-path kernel once and leaves
    the entry's ``trace_counts`` at 1 / 1."""
    from repro_torch.serve import PlanCache, default_cfg_factory

    FmmSolver.cache_clear()
    cache = PlanCache(default_cfg_factory)
    reset_launch_counts()
    guarded = cache.warm(2048, 2)
    assert launch_counts() == _main_counts(guarded.cfg.nlevels)
    assert guarded.trace_counts == {"build": 1, "evaluate": 1}
    assert guarded.device.type == "cuda"


def test_nine_bucket_wave_rebuilds_no_layout(cuda):
    """The default plane's 9 sizes served twice: the second wave is all
    cache hits, prepares nothing and builds no leaf layout."""
    from repro_torch.core.topology import layout_builds
    from repro_torch.serve import Request, ServePlane

    plane = ServePlane()
    reqs = [Request(*_request(n, i))
            for i, n in enumerate(plane.lattice.sizes)]
    first = plane.serve(reqs)
    assert all(r.report.status in ("ok", "recovered")
               and r.report.backend == "cuda" for r in first)
    traces = {k: dict(g.trace_counts) for k, g in plane.cache._entries.items()}
    builds = layout_builds()
    second = plane.serve(reqs)
    assert layout_builds() == builds
    assert all(r.report.cache == "hit" for r in second)
    assert traces == {k: dict(g.trace_counts)
                      for k, g in plane.cache._entries.items()}
    for a, b in zip(first, second):
        assert np.array_equal(a.phi, b.phi)


# ---------------------------------------------------------------------------
# compiled programs (CUDA graphs) on the card
# ---------------------------------------------------------------------------

def _phases_backend(cuda):
    register_backend(dataclasses.replace(
        get_backend("cuda", cuda), name="cuda-phases", m2l_fused=None,
        eval_fused=None))
    return "cuda-phases"


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("backend", ["cuda", "cuda-phases"])
def test_each_entry_point_replays_its_eager_pipeline_bitwise(cuda, dtype,
                                                             backend):
    """Each of the six entry points (``apply``, ``apply_with_health``,
    ``apply_batched`` at B = 4, ``refresh``, ``apply_plan``,
    ``apply_charges``, and its program of 8 densities on the plan): the
    first
    call launches one run's kernels from the host (the main path's, or
    the per-phase path's), the second records them into its capture and
    launches nothing from the host, a replay launches nothing from the
    host and runs exactly those kernels on the card (a profiler trace),
    and every call's output is bitwise the eager pipeline's."""
    smoke = _smoke()
    if backend != "cuda":
        _phases_backend(cuda)
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype=dtype)
    probs = [particles(d, cfg.n, 5, device=cuda)
             for d in ("uniform", "normal", "layer", "uniform")]
    z, q = probs[0]
    zb = torch.stack([p[0] for p in probs])
    qb = torch.stack([p[1] for p in probs])
    solver = FmmSolver(cfg, backend)
    plan = smoke.eager_entry(solver, "refresh", *(
        a.to(cfg.torch_complex)[None] for a in (z, q)))
    none = _main_counts(0, upward=0, m2l=0, p2l=0, eval_fused=0)
    for entry, (call, eager, want) in smoke.entry_calls(
            solver, z, q, zb, qb, plan).items():
        ref = eager()
        for n, expect in enumerate([(want, none), (none, want)]):
            got, host, rec = _runs(call)
            assert (host, rec) == expect, (entry, n)
            assert all(torch.equal(a, b) for a, b in
                       zip(smoke.leaves(got), smoke.leaves(ref))), entry
        prog = smoke.program_of(solver, entry)
        assert prog.launches == want and prog.recorded == want
        (got, ran), host, rec = _runs(lambda: smoke.replay_kernels(call,
                                                                   torch))
        assert host == none and rec == none and ran == want, (entry, ran)
        assert len(smoke.leaves(got)) == len(smoke.leaves(ref))
        assert all(torch.equal(a, b) for a, b in
                   zip(smoke.leaves(got), smoke.leaves(ref))), entry
        assert (prog.calls, prog.replays) == (3, 2)
    assert solver._compiled_program_count() == 7


def test_replay_phase_marks_read_positive_device_times(cuda):
    """A captured ``apply`` at 2^14 carries a device mark at each phase:
    every replay reads each phase's device time and the launch gap as
    positive, together at most the replay's span timed by events around
    the call, with no replay left unread; every call bitwise the eager
    first one, and the counters count one eager call, one capture and
    three replays, and the levels the eager call and the capture
    classified with the kernel."""
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f64")
    z, q = particles("uniform", cfg.n, 0, device=cuda)
    solver = FmmSolver(cfg, "cuda")
    trace.reset()
    ref = solver.apply(z, q)
    spans = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        phi = solver.apply(z, q)
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
        assert torch.equal(phi, ref)
    snap = trace.snapshot()
    # the eager call and the capture each built through the kernel
    assert snap["counters"] == {"program.eager": 1, "program.capture": 1,
                                "program.replay": 3,
                                "connectivity.kernel_levels": 2 * cfg.nlevels,
                                "connectivity.plain_levels": 0}
    readings = snap["phases"]["apply"]
    assert len(readings) == 3
    for reading, span in zip(readings, spans):
        assert set(reading) == {"launch_gap", "tree", "connectivity",
                                "upward", "downward", "evaluation",
                                "unsort"}
        assert all(v > 0 for v in reading.values()), reading
        assert sum(reading.values()) <= span, (reading, span)
    solver._release_executables()
    trace.reset()


def test_log_matvec_at_2_20_replays_its_plan_without_topology(cuda):
    """The held-plan log matvec at the benchmark's shapes (2^20 layer
    particles, f64, G = log, caps 256/1024): ``apply_charges`` on one
    plan for three charge vectors and back, every call bitwise the eager
    pipeline and the first bitwise ``apply``; the replays' device marks
    hold the charge gather and the evaluate half and no tree or
    connectivity, and the plan was bound once."""
    from repro_torch.core.config import num_levels_for
    smoke = _smoke()
    n = 1 << 20
    cfg = FmmConfig(n=n, nlevels=num_levels_for(n, 45), p=17, dtype="f64",
                    kernel="log", strong_cap=256, weak_cap=1024)
    z, q0 = particles("layer", n, 3, device=cuda)
    charges = [particles("layer", n, s, device=cuda)[1].real + 0j
               for s in (4, 5, 6)]
    solver = FmmSolver(cfg, "cuda")
    plan = solver.refresh(z, q0)
    trace.reset()
    for k, q in enumerate(charges + charges[:1]):
        got = solver.apply_charges(plan, q)
        ref = smoke.eager_entry(solver, "apply_charges", plan,
                                q.to(cfg.torch_complex)[None])[0]
        assert torch.equal(got, ref), k
        assert bool(torch.isfinite(got).all())
    snap = trace.snapshot()
    assert snap["counters"]["program.plan_bind"] == 1
    assert (snap["counters"]["program.eager"],
            snap["counters"]["program.capture"],
            snap["counters"]["program.replay"]) == (1, 1, 3)
    readings = snap["phases"]["apply_charges"]
    assert len(readings) == 3
    for reading in readings:
        assert set(reading) == {"launch_gap", "charges", "upward",
                                "downward", "evaluation", "unsort"}
        assert all(v > 0 for v in reading.values()), reading
    assert torch.equal(solver.apply(z, charges[0]), got)
    solver._release_executables()
    trace.reset()


def test_a_returned_result_is_not_overwritten_by_the_next_call(cuda):
    """Outputs are fresh tensors: a phi, a health plane and a plan taken
    from one replay keep their values through later replays at the same
    shape on other inputs."""
    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f32")
    (z1, q1), (z2, q2) = (particles(d, cfg.n, 6, device=cuda)
                          for d in ("uniform", "layer"))
    solver = FmmSolver(cfg)
    for _ in range(2):                         # eager, then the capture
        solver.apply_with_health(z2, q2)
        solver.refresh(z2, q2)
    phi1, health1 = solver.apply_with_health(z1, q1)
    plan1 = solver.refresh(z1, q1)
    kept = [t.clone() for t in (phi1, *health1, plan1.tree.perm,
                                plan1.conn.p2p)]
    phi2, health2 = solver.apply_with_health(z2, q2)
    plan2 = solver.refresh(z2, q2)
    assert all(p.replays == 3 for p in solver.programs().values())
    assert not torch.equal(phi1, phi2)
    assert not torch.equal(plan1.tree.perm, plan2.tree.perm)
    now = (phi1, *health1, plan1.tree.perm, plan1.conn.p2p)
    assert all(torch.equal(a, b) for a, b in zip(kept, now))
    assert phi1.data_ptr() != phi2.data_ptr()


def test_release_returns_the_reserved_memory(cuda):
    """A solver's programs hold their pool until ``_release_executables``;
    after it and ``empty_cache`` the reserved memory is back where it
    was before the captures."""
    cfg = FmmConfig(n=1 << 16, nlevels=5, p=17, dtype="f64")
    z, q = particles("normal", cfg.n, 7, device=cuda)
    solver = FmmSolver(cfg)
    solver.apply(z, q)                 # constants built outside the window
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    for _ in range(2):
        solver.apply(z, q)
        solver.apply_with_health(z, q)
        solver.apply_plan(solver.refresh(z, q))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved()
    assert solver._compiled_program_count() == 4 and held > before
    assert all(p.captured for p in solver.programs().values())
    solver._release_executables()
    torch.cuda.empty_cache()
    assert solver._compiled_program_count() == 0
    assert torch.cuda.memory_reserved() == before


def test_memory_budget_releases_the_least_recently_run_solver(cuda):
    """With a budget smaller than one solver's programs, a second
    solver's capture releases the first solver's programs (never its
    own), and the released solver answers bitwise as before: eagerly at
    its next call, from a new capture at the one after."""
    from repro_torch.solver import program_memory, set_program_budget

    cfg = FmmConfig(n=1 << 14, nlevels=4, p=17, dtype="f64")
    z, q = particles("normal", cfg.n, 9, device=cuda)
    a, b = FmmSolver(cfg), FmmSolver(dataclasses.replace(cfg, p=16))
    FmmSolver.cache_clear()
    released = program_memory(cuda)["released_bytes"]
    set_program_budget(1, cuda)
    try:
        phi = [a.apply(z, q), a.apply(z, q)]
        a_bytes = a._programs.bytes
        assert a._compiled_program_count() == 1 and a_bytes > 0
        b.apply(z, q)
        b.apply(z, q)
        assert a._compiled_program_count() == 0
        assert b._compiled_program_count() == 1
        # a's pool went (and any other solver's still held)
        assert program_memory(cuda)["released_bytes"] >= \
            released + a_bytes
        phi += [a.apply(z, q), a.apply(z, q)]
        assert all(torch.equal(p, phi[0]) for p in phi)
        assert b._compiled_program_count() == 0
    finally:
        set_program_budget(None, cuda)


def test_a_capture_error_raises_and_never_falls_back_to_eager(cuda):
    """A hook that reads a value back to the host (``.item()``) runs in
    the first, eager call but cannot be captured: the second call
    raises, and so does the third — no eager fallback, no graph kept. A
    solver without it still captures afterwards."""
    cuda_be = get_backend("cuda", cuda)

    def syncing(*args, **kwargs):
        out = cuda_be.m2l_fused(*args, **kwargs)
        float(out[0].real.sum().item())          # a host read
        return out

    register_backend(dataclasses.replace(cuda_be, name="cuda-host-read",
                                         m2l_fused=syncing))
    cfg = FmmConfig(n=1 << 12, nlevels=3, p=12, dtype="f64")
    z, q = particles("uniform", cfg.n, 8, device=cuda)
    solver = FmmSolver(cfg, "cuda-host-read")
    plain = FmmSolver(cfg)
    assert torch.equal(solver.apply(z, q), plain.apply(z, q))
    for _ in range(2):
        with pytest.raises(RuntimeError):
            solver.apply(z, q)
        prog, = solver.programs().values()
        assert not prog.captured and prog.calls == 1
    torch.cuda.synchronize()
    phi = plain.apply(z, q)
    plain.apply(z, q)
    assert plain.programs()[next(iter(plain.programs()))].captured
    assert bool(torch.isfinite(phi).all())


# ---------------------------------------------------------------------------
# degenerate layouts, checkpoints and the prefetcher on the card
# ---------------------------------------------------------------------------

DEGENERATE = ["all-coincident", "one-distinct-in-a-cluster", "collinear",
              "empty-quadrants", "zero-charges", "scale-1e-9", "scale-1e-3",
              "scale-1e6"]


def _bits(t):
    return _smoke().bits(t)


@pytest.mark.parametrize("layout", DEGENERATE)
def test_degenerate_layouts_on_the_card_match_the_cpu_run(cuda, layout):
    """Each layout of ``tests/test_torch_helpers.py`` through
    ``apply_with_health`` on a fresh "cuda" solver: the first call
    (eager) and the third (a replay) against the port's run on the CPU,
    which the CPU test holds to the reference: the same ``host_health``,
    the same finite and NaN pattern, phi within 1e-10 where finite; the
    replay bitwise the eager call."""
    from repro_torch.solver import host_health

    cfg = FmmConfig(n=256, nlevels=2, p=12, dtype="f64", strong_cap=32,
                    weak_cap=64)
    z, q = _smoke().degenerate_layouts(cfg.n)[layout]
    ref, h_ref = FmmSolver(cfg, "cuda", "cpu").apply_with_health(z, q)
    solver = FmmSolver(cfg, "cuda", cuda)
    (phi, health), host, _ = _runs(lambda: solver.apply_with_health(z, q))
    assert host == _main_counts(cfg.nlevels)
    solver.apply_with_health(z, q)
    phi_r, health_r = solver.apply_with_health(z, q)
    prog, = solver.programs().values()
    assert prog.captured and prog.replays == 2
    assert host_health(health) == host_health(h_ref)
    got = phi.cpu()
    assert torch.equal(got.isfinite(), ref.isfinite())
    assert torch.equal(got.isnan(), ref.isnan())
    ok = ref.isfinite()
    if ok.any() and ref[ok].abs().max() > 0:
        assert _rel(got[ok], ref[ok]) <= 1e-10
    else:
        assert torch.equal(got[ok], ref[ok])
    assert torch.equal(_bits(phi_r), _bits(phi))
    for a, b in zip(health_r, health):
        assert torch.equal(_bits(a), _bits(b))


def test_checkpoint_of_cuda_tensors_restores_on_the_card_bitwise(cuda,
                                                                 tmp_path):
    """A tree of CUDA tensors saved asynchronously, then changed in place
    before the write: ``restore_latest`` returns the saved values on the
    card, bit for bit, dtypes kept."""
    from repro_torch.checkpoint import CheckpointManager

    gen = torch.Generator(device=cuda).manual_seed(0)
    z = torch.randn(1 << 20, dtype=torch.complex64, device=cuda,
                    generator=gen)
    tree = {"z": z, "caps": [torch.tensor(48, device=cuda)],
            "w": torch.randn(3, 4, dtype=torch.float64, device=cuda,
                             generator=gen)}
    want = {"z": z.clone(), "w": tree["w"].clone()}
    cm = CheckpointManager(str(tmp_path))
    cm.save(3, tree)
    z.mul_(2)
    tree["w"].zero_()
    got, step = cm.restore_latest()
    assert step == 3 and got["caps"]["0"].item() == 48
    for k in ("z", "w"):
        assert got[k].device == z.device and got[k].dtype == want[k].dtype
        assert torch.equal(_bits(got[k]), _bits(want[k]))


def test_prefetcher_makes_tensors_on_the_current_card(cuda):
    from repro_torch.data import DataConfig, Prefetcher, lm_batch

    dc = DataConfig(vocab=512, batch=2, seq=8, seed=1)
    pf = Prefetcher(lambda s: lm_batch(dc, s), start_step=0, depth=2)
    got = [pf.get() for _ in range(3)]
    pf.close()
    for s, batch in got:
        assert batch["tokens"].device == torch.device(
            "cuda", torch.cuda.current_device())
        assert torch.equal(batch["tokens"].cpu(),
                           lm_batch(dc, s, device="cpu")["tokens"])


def test_vortex_replans_through_captured_programs(cuda):
    """The vortex twin's RK2 steps on the card from caps too small for
    the layout: the first refresh re-plans (grown caps, a new solver
    whose programs run eagerly, capture, then replay), every report on
    "cuda" without degradation, and the positions within 1e-10 of the
    same steps on the CPU (f64), with the same re-plans."""
    import importlib.util

    from repro_torch.configs import fmm_config
    from repro_torch.solver import GuardedSolver

    spec = importlib.util.spec_from_file_location(
        "torch_vortex_dynamics", ROOT / "examples" / "torch_vortex_dynamics.py")
    vortex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(vortex)
    n = 8192
    cfg = dataclasses.replace(fmm_config(n, p=12, dtype="f64"),
                              strong_cap=8, weak_cap=16)
    z0, gamma = vortex.vortex_pair(n)
    out = []
    for dev in (cuda, torch.device("cpu")):
        z = torch.from_numpy(z0).to(dev)
        g = torch.from_numpy(gamma + 0j).to(dev)
        guard = GuardedSolver(cfg, "cuda", max_cap_doublings=5, device=dev)
        reports = []
        for _ in range(4):
            z, reps = vortex.rk2_step(z, g, guard, 2e-4)
            reports += reps
        out.append((z.cpu() - torch.from_numpy(z0),
                    [r.retries for r in reports], guard))
    (moved, retries, guard), (moved_cpu, retries_cpu, _) = out
    assert retries == retries_cpu and retries[0] > 0 and not any(retries[1:])
    assert _rel(moved, moved_cpu) <= 1e-10
    progs = guard.solver.programs()
    assert {k[0] for k in progs} == {"refresh", "apply_plan"}
    for p in progs.values():
        assert p.captured and p.replays == p.calls - 1 and p.calls >= 7


@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """A one-rank NCCL process group and its (1, 1, 1) ("pod", "data",
    "model") mesh on the card, torn down after the test."""
    import torch.distributed as dist

    from repro_torch.launch import make_test_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_test_mesh((1, 1, 1), ("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


def test_compressed_gradient_and_wire_bytes_on_one_nccl_rank(nccl_mesh,
                                                             monkeypatch):
    """The smoke's parallel leg (a) at 256 x 256: the compressed gradient
    within half a quantum of the exact one, the loss exact, the errors the
    residual (its own gates); the bytes NCCL's collectives put on the wire,
    read from a profiler trace: the int32 codes and the f32 scale against
    a plain f32 all_reduce."""
    smoke = _smoke()
    monkeypatch.setattr(smoke, "PAR_SIDE", 256)
    monkeypatch.setattr(smoke, "PAR_REPS", 3)
    out = smoke.nccl_leg(nccl_mesh, torch)
    n = 256 * 256
    assert out["ef_bytes"] == {"all-reduce": 4 * n + 4, "total": 4 * n + 4}
    assert out["plain_bytes"] == {"all-reduce": 4 * n, "total": 4 * n}


def test_elastic_restore_resumes_bitwise_on_the_card(nccl_mesh):
    """The smoke's parallel leg (c) at n = 8192: the vortex state saved,
    restored with ``shardings=`` as replicated DTensors on the one-rank
    mesh (bitwise), resumed through the replayed programs bitwise the
    uninterrupted run, running the four main-path kernels."""
    smoke = _smoke()
    smoke.observe_programs()
    out = smoke.resume_leg(nccl_mesh, smoke.load_example(
        "torch_vortex_dynamics"), 8192, torch)
    smoke.main_kernels_ran(out["runs"], "resume")
    assert out["kinds"]["replay"] == 4 * smoke.RESUME_STEPS
