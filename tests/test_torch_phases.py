"""PyTorch port, the per-phase FMM path and the direct N-body baseline:
each new kernel wrapper on CPU tensors (its plain version) against the
reference's Pallas wrapper in interpret mode on one shared topology —
the per-level M2L, L2P, P2P (both G-kernels) and ``nbody_direct`` — and
the whole per-phase ``fmm_evaluate`` against the reference's with its
"pallas" backend's p2p/m2l/l2p/p2l hooks. f64 within 1e-10 relative;
f32 within F32_TOL. The same numpy-seeded inputs go to both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fmm as JF
from repro.core.fmm import fmm_evaluate as jax_fmm_evaluate
from repro.kernels import l2p_apply as jax_l2p
from repro.kernels import m2l_level_apply as jax_m2l_level
from repro.kernels import nbody_direct as jax_nbody
from repro.kernels import p2p_apply as jax_p2p
from repro.solver.backends import get_backend as jax_get_backend
from repro_torch.core import fmm as F
from repro_torch.core.direct import direct_potential
from repro_torch.core.topology import leaf_particle_index
from repro_torch.kernels.common import scatter_from_leaves
from repro_torch.kernels import (l2p_apply, l2p_cuda, l2p_operands,
                                 l2p_plain, m2l_level_apply, nbody_cuda,
                                 nbody_direct, nbody_plain, p2p_apply,
                                 p2p_cuda, p2p_operands, p2p_plain)
from repro_torch.solver import FmmSolver, get_backend, register_backend

from _torch_parity import configs, inputs, jax_plan, rel, shared_plan, t

TOL = 1e-10
# f32: both packages round every operation to f32 (eps 6e-8) but sum the
# up to S * n_max terms of a target in different orders; their
# difference stays near 1e-6 of the largest output, and a dropped or
# wrong term moves it by far more.
F32_TOL = 1e-5
SMALL = dict(nlevels=2, p=8, dtype="f64", strong_cap=16, weak_cap=64)
CPU = torch.device("cpu")


def per_phase_backend(name="cuda-phases", **hooks):
    """The "cuda" backend with its fused hooks removed (so the per-phase
    hooks run), registered under ``name``, as a user derives one."""
    base = get_backend("cuda", CPU)
    return register_backend(dataclasses.replace(
        base, name=name, m2l_fused=None, eval_fused=None, **hooks))


def _jax_expansions(jp, jcfg):
    return JF.upward(jp.tree, jcfg), JF.effective_radii(jp.tree, jcfg)


@pytest.mark.parametrize("kernel,p,dist,levels", [
    ("harmonic", 8, "normal", 2), ("log", 8, "uniform", 2),
    ("harmonic", 17, "layer", 3)])
def test_m2l_level_matches_pallas(kernel, p, dist, levels):
    jcfg, tcfg, jp, plan = shared_plan(
        dist, 2048, seed=2, **(SMALL | dict(kernel=kernel, p=p,
                                            nlevels=levels)))
    mult, rho = _jax_expansions(jp, jcfg)
    for l in range(1, levels + 1):
        ref = jax_m2l_level(mult[l], jp.conn.weak[l], jp.tree.centers[l],
                            jcfg, rho[l])
        got = m2l_level_apply(t(mult[l]), plan.conn.weak[l],
                              plan.tree.centers[l], tcfg, t(rho[l]))
        assert got.shape == (1,) + ref.shape
        assert rel(got[0], ref) <= TOL
    assert np.abs(np.asarray(ref)).max() > 0


@pytest.mark.parametrize("kernel,dtype", [("harmonic", "f64"),
                                          ("log", "f64"),
                                          ("harmonic", "f32")])
def test_l2p_matches_pallas(kernel, dtype):
    jcfg, tcfg, jp, plan = shared_plan(
        "normal", 1024, seed=3, **(SMALL | dict(kernel=kernel, dtype=dtype)))
    mult, rho = _jax_expansions(jp, jcfg)
    local = JF.downward(mult, jp.tree, jp.conn, jcfg, rho)
    ref = jax_l2p(local, jp.tree, jcfg, leaf_particle_index(tcfg))
    got = l2p_apply(t(local), plan.tree, tcfg)
    assert got.shape == (1, tcfg.n) and got.dtype == tcfg.torch_complex
    assert rel(got[0], ref) <= (TOL if dtype == "f64" else F32_TOL)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_l2p_matches_pallas_at_batch_two_with_ragged_leaves(dtype):
    """The L2P wrapper (its plain version on these CPU tensors) on two
    problems in one call, at N = 630 over 16 leaves: n_max = 40, which is
    no multiple of 32 or 64, and padded slots. Each row against the
    reference's Pallas L2P of that problem with the same seeded local
    expansions; the padded slots exactly 0."""
    cfg = SMALL | dict(dtype=dtype, p=17)
    probs = [shared_plan(d, 630, seed=s, **cfg)
             for d, s in (("normal", 17), ("layer", 18))]
    jcfg, tcfg = probs[0][:2]
    idx = leaf_particle_index(tcfg)
    assert idx.shape == (16, 40) and bool((idx < 0).any())
    rng = np.random.default_rng(19)
    staged, want = [], []
    for _, _, jp, plan in probs:
        local = (rng.normal(size=(16, 18)) + 1j * rng.normal(size=(16, 18)))
        want.append(np.asarray(jax_l2p(jnp.asarray(local), jp.tree, jcfg,
                                       idx)))
        args, kw = l2p_operands(t(local), plan.tree, tcfg)
        staged.append(args)
    args = [torch.cat(parts) if a.dim() == 3 else parts[0]
            for a, parts in zip(staged[0], zip(*staged))]
    assert args[2].shape == (2, 16, 40)
    outr, outi = l2p_cuda(*args, **kw)
    pad = args[-1] < 0
    assert bool((outr[:, pad] == 0).all() and (outi[:, pad] == 0).all())
    got = scatter_from_leaves(torch.complex(outr, outi), tcfg)
    for b in range(2):
        assert rel(got[b], want[b]) <= (TOL if dtype == "f64" else F32_TOL)


@pytest.mark.parametrize("kernel,dtype,dist", [("harmonic", "f64", "layer"),
                                               ("log", "f64", "normal"),
                                               ("harmonic", "f32", "normal")])
def test_p2p_matches_pallas(kernel, dtype, dist):
    jcfg, tcfg, jp, plan = shared_plan(
        dist, 1024, seed=4, **(SMALL | dict(kernel=kernel, dtype=dtype)))
    ref = jax_p2p(jp.tree, jp.conn, jcfg, leaf_particle_index(tcfg))
    got = p2p_apply(plan.tree, plan.conn, tcfg)
    assert got.shape == (1, tcfg.n) and got.dtype == tcfg.torch_complex
    assert rel(got[0], ref) <= (TOL if dtype == "f64" else F32_TOL)


@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_p2p_matches_pallas_at_batch_two_with_gapped_rows(kernel):
    """The P2P wrapper (its plain version on these CPU tensors) on two
    problems in one call, their p2p rows spread with -1 between the
    occupied slots and one leaf's row masked whole: each row of the batch
    against the reference's Pallas P2P of that problem with the same
    lists; the masked leaf's near field exactly 0 in both."""
    cfg = SMALL | dict(kernel=kernel, nlevels=3)
    probs = [shared_plan(d, 2048, seed=s, **cfg)
             for d, s in (("uniform", 15), ("normal", 16))]
    jcfg, tcfg = probs[0][:2]
    idx = leaf_particle_index(tcfg)
    staged, want = [], []
    for _, _, jp, plan in probs:
        rows = np.asarray(jp.conn.p2p)
        gapped = np.full(rows.shape[:-1] + (2 * rows.shape[-1],), -1,
                         np.int32)
        gapped[:, 1::2] = rows
        gapped[5] = -1
        want.append(np.asarray(jax_p2p(
            jp.tree, jp.conn._replace(p2p=jnp.asarray(gapped)), jcfg, idx)))
        args, kw = p2p_operands(plan.tree, plan.conn._replace(
            p2p=torch.from_numpy(gapped)[None]), tcfg)
        staged.append(args)
    args = [torch.cat(parts) if a.dim() == 3 else parts[0]
            for a, parts in zip(staged[0], zip(*staged))]
    lists = args[0]
    assert lists.shape == (2, 4**3, 2 * tcfg.strong_cap)
    assert bool((lists[..., 0::2] < 0).all())
    outr, outi = p2p_cuda(*args, **kw)
    got = scatter_from_leaves(torch.complex(outr, outi), tcfg)
    leaf5 = idx[5][idx[5] >= 0]
    for b in range(2):
        assert rel(got[b], want[b]) <= TOL
        assert bool((outr[b, 5] == 0).all() and (outi[b, 5] == 0).all())
        assert np.all(want[b][leaf5] == 0)


@pytest.mark.parametrize("n,m,dtype", [(256, 256, "f32"), (512, 512, "f64"),
                                       (300, 700, "f64"), (700, 700, "f32")])
def test_nbody_direct_matches_pallas(n, m, dtype):
    rng = np.random.default_rng(n + m)
    cdt = np.complex64 if dtype == "f32" else np.complex128
    zs = (rng.uniform(0, 1, m) + 1j * rng.uniform(0, 1, m)).astype(cdt)
    q = (rng.normal(size=m) + 1j * rng.normal(size=m)).astype(cdt)
    zt = zs[:n] if n <= m else zs
    ref = np.asarray(jax_nbody(jnp.asarray(zt), jnp.asarray(zs),
                               jnp.asarray(q), t_tile=128, s_tile=256,
                               interpret=True))
    got = nbody_direct(torch.from_numpy(zt), torch.from_numpy(zs),
                       torch.from_numpy(q))
    assert got.shape == (n,) and got.dtype == torch.from_numpy(zs).dtype
    assert rel(got, ref) <= (TOL if dtype == "f64" else F32_TOL)


def _jax_per_phase(jcfg, z, q):
    """The reference's per-phase pipeline — its "pallas" backend's
    p2p/m2l/l2p/p2l hooks (interpret mode on the CPU), no fused hook —
    in input order."""
    pallas = jax_get_backend("pallas")
    jp = jax.tree.map(jnp.asarray, jax_plan(jcfg, z, q))
    phi = jax_fmm_evaluate(jp, jcfg, p2p_impl=pallas.p2p,
                           m2l_impl=pallas.m2l, l2p_impl=pallas.l2p,
                           p2l_impl=pallas.p2l)
    return np.asarray(jnp.zeros_like(phi).at[jp.tree.perm].set(phi))


@pytest.mark.parametrize("dist,n,levels,p,kernel,use_p2l_m2p", [
    ("normal", 1024, 2, 8, "harmonic", True),
    ("layer", 1024, 2, 8, "log", True),
    ("uniform", 1024, 2, 17, "harmonic", False),
    ("uniform", 40, 0, 8, "harmonic", True)])
def test_per_phase_solver_matches_pallas_hooks(dist, n, levels, p, kernel,
                                               use_p2l_m2p):
    jcfg, tcfg = configs(n=n, nlevels=levels, p=p, dtype="f64",
                         kernel=kernel, use_p2l_m2p=use_p2l_m2p,
                         strong_cap=32, weak_cap=64)
    z, q = inputs(dist, n, seed=levels + 5)
    ref = _jax_per_phase(jcfg, z, q)
    calls = {"m2l": 0, "l2p": 0, "p2p": 0}

    def counted(name, fn):
        def hook(*a):
            calls[name] += 1
            return fn(*a)
        return hook

    phases = per_phase_backend(
        name=f"cuda-phases-counted-{n}-{levels}",
        m2l=counted("m2l", m2l_level_apply), l2p=counted("l2p", l2p_apply),
        p2p=counted("p2p", p2p_apply))
    solver = FmmSolver.build(tcfg, backend=phases.name, device="cpu")
    got = solver.apply_checked(z, q)
    assert calls == {"m2l": max(levels, 1), "l2p": 1, "p2p": 1}
    assert got.shape == (n,)
    assert rel(got, ref) <= TOL
    fused = FmmSolver.build(tcfg, backend="cuda", device="cpu").apply(z, q)
    assert rel(got, fused) <= TOL


@pytest.mark.parametrize("levels", [0, 2])
def test_per_level_m2l_hook_fold_matches_downward(levels):
    """``fmm_evaluate`` with the per-level M2L hook (one call a level,
    folded by its one L2L loop) hands the evaluation the plain
    ``downward``'s leaf locals."""
    _, cfg = configs(n=256 if levels else 40, nlevels=levels, p=8,
                     dtype="f64", strong_cap=32, weak_cap=64)
    z, q = inputs("normal", cfg.n, seed=9)
    plan = F.fmm_build(torch.from_numpy(z)[None], torch.from_numpy(q)[None],
                       cfg)
    ref = F.downward(F.upward(plan.tree, cfg), plan.tree, plan.conn, cfg)
    seen = {}

    def keep_local(local, mult_leaf, tree, conn, c):
        seen["local"] = local
        return torch.zeros_like(tree.z)

    F.fmm_evaluate(plan, cfg, m2l_impl=m2l_level_apply,
                   eval_fused_impl=keep_local)
    got = seen["local"]
    assert got.shape == ref.shape == (1, 4**levels, cfg.p + 1)
    assert rel(got, ref) <= TOL


def test_cuda_backend_main_path_ignores_per_phase_hooks():
    """The fused hooks take precedence: a "cuda" backend whose per-phase
    hooks raise gives bitwise the same phi as "cuda" itself."""
    _, cfg = configs(n=1024, nlevels=2, p=12, dtype="f64")
    z, q = inputs("layer", cfg.n, seed=1)

    def boom(*a):
        raise AssertionError("per-phase hook ran on the main path")

    base = get_backend("cuda", CPU)
    assert base.p2p is p2p_apply and base.l2p is l2p_apply
    assert base.m2l is m2l_level_apply
    register_backend(dataclasses.replace(base, name="cuda-no-phases",
                                         p2p=boom, m2l=boom, l2p=boom))
    phi = FmmSolver.build(cfg, backend="cuda", device="cpu").apply(z, q)
    got = FmmSolver.build(cfg, backend="cuda-no-phases",
                          device="cpu").apply(z, q)
    assert torch.equal(got, phi)


def test_nbody_excludes_coincident_positions_p2p_keeps_them():
    """N-body excludes self by position: a source at a target's position
    drops out. P2P excludes by rank: two distinct particles at one
    position keep their (singular) mutual term."""
    _, cfg = configs(n=256, nlevels=1, p=8, dtype="f64", strong_cap=32,
                     weak_cap=64)
    z, q = inputs("uniform", cfg.n, seed=3)
    z[7] = z[3]                                   # a coincident pair
    zt, qt = torch.from_numpy(z), torch.from_numpy(q)
    phi = nbody_direct(zt, zt, qt)
    assert torch.isfinite(phi).all()
    want = np.array([sum(q[j] / (z[j] - z[i]) for j in range(cfg.n)
                         if z[j] != z[i]) for i in (3, 7, 11)])
    assert rel(phi[[3, 7, 11]], want) <= TOL
    assert rel(phi, direct_potential(zt, zt, qt)) <= TOL
    per_phase_backend()
    near = FmmSolver.build(cfg, backend="cuda-phases",
                           device="cpu").apply(z, q)
    bad = ~torch.isfinite(near)
    assert bad[3] and bad[7] and int(bad.sum()) == 2


def test_new_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors each new wrapper returns exactly its plain version."""
    _, cfg, _, plan = shared_plan("normal", 1000, seed=5, **SMALL)
    args, kw = p2p_operands(plan.tree, plan.conn, cfg)
    for a, b in zip(p2p_cuda(*args, **kw), p2p_plain(*args, **kw)):
        assert torch.equal(a, b)
    mult = F.upward(plan.tree, cfg)
    local = F.downward(mult, plan.tree, plan.conn, cfg)
    args, kw = l2p_operands(local, plan.tree, cfg)
    outs = l2p_cuda(*args, **kw)
    for a, b in zip(outs, l2p_plain(*args, **kw)):
        assert torch.equal(a, b)
    pad = args[-1] < 0                            # padded slots are zero
    assert pad.any() and (outs[0][:, pad] == 0).all()
    zr, zi = plan.tree.z.real[0], plan.tree.z.imag[0]
    qr, qi = plan.tree.q.real[0], plan.tree.q.imag[0]
    for a, b in zip(nbody_cuda(zr, zi, zr, zi, qr, qi),
                    nbody_plain(zr, zi, zr, zi, qr, qi)):
        assert torch.equal(a, b)
