"""PyTorch port, kernel modules: each kernel wrapper on CPU tensors (its
plain version) matches the reference's Pallas wrapper (interpret mode)
on one shared topology, in f64, within 1e-10 relative — both G-kernels,
and the fused evaluation with and without its M2P region. The same
inputs (the reference's plan and expansions, as numpy) go to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fmm as JF
from repro.kernels.eval import eval_fused_apply as jax_eval_fused
from repro.kernels.eval import p2l_apply as jax_p2l
from repro.kernels.m2l import m2l_fused_apply as jax_m2l_fused
from repro_torch.core import fmm as F
from repro_torch.core.topology import leaf_particle_index
from repro_torch.kernels import (eval_fused_apply, eval_fused_plain,
                                 eval_operands, m2l_cuda, m2l_fused_apply,
                                 m2l_operands, m2l_plain, p2l_apply,
                                 p2l_cuda, p2l_operands, p2l_plain)

from _torch_parity import rel, shared_plan, t

TOL = 1e-10
SMALL = dict(nlevels=2, p=8, dtype="f64", strong_cap=16, weak_cap=64)


def _jax_expansions(jp, jcfg):
    mult = JF.upward(jp.tree, jcfg)
    rho = JF.effective_radii(jp.tree, jcfg)
    return mult, rho


@pytest.mark.parametrize("kernel,p,dist", [("harmonic", 8, "normal"),
                                           ("log", 8, "uniform"),
                                           ("harmonic", 17, "layer")])
def test_m2l_fused_matches_pallas(kernel, p, dist):
    jcfg, tcfg, jp, plan = shared_plan(dist, 1024, seed=2,
                                       **(SMALL | dict(kernel=kernel, p=p)))
    mult, rho = _jax_expansions(jp, jcfg)
    ref = jax_m2l_fused(mult, jp.conn.weak, jp.tree.centers, jcfg, rho)
    got = m2l_fused_apply([t(m) for m in mult], plan.conn.weak,
                          plan.tree.centers, tcfg, [t(r) for r in rho])
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        assert g.shape == (1,) + r.shape
        assert rel(g[0], r) <= TOL


@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_p2l_matches_pallas(kernel):
    jcfg, tcfg, jp, plan = shared_plan("normal", 1024, seed=3,
                                       **(SMALL | dict(kernel=kernel)))
    _, rho = _jax_expansions(jp, jcfg)
    idx = leaf_particle_index(tcfg)
    assert (np.asarray(jp.conn.p2l) >= 0).any()
    ref = jax_p2l(jp.tree, jp.conn, jcfg, idx, rho[jcfg.nlevels])
    got = p2l_apply(plan.tree, plan.conn, tcfg, t(rho[jcfg.nlevels]))
    assert rel(got[0], ref) <= TOL


@pytest.mark.parametrize("kernel,use_p2l_m2p", [("harmonic", True),
                                                ("log", True),
                                                ("harmonic", False),
                                                ("log", False)])
def test_eval_fused_matches_pallas(kernel, use_p2l_m2p):
    jcfg, tcfg, jp, plan = shared_plan(
        "layer", 1024, seed=4,
        **(SMALL | dict(kernel=kernel, use_p2l_m2p=use_p2l_m2p)))
    mult, rho = _jax_expansions(jp, jcfg)
    local = JF.downward(mult, jp.tree, jp.conn, jcfg, rho)
    idx = leaf_particle_index(tcfg)
    if use_p2l_m2p:
        assert (np.asarray(jp.conn.m2p) >= 0).any()
    ref = jax_eval_fused(local, mult[jcfg.nlevels], jp.tree, jp.conn, jcfg,
                         idx)
    got = eval_fused_apply(t(local), t(mult[jcfg.nlevels]), plan.tree,
                           plan.conn, tcfg)
    assert got.shape == (1, tcfg.n)
    assert rel(got[0], ref) <= TOL


def _gapped(rows):
    """A (..., S) list spread over (..., 2S): each slot at an odd
    position, -1 between them."""
    out = np.full(rows.shape[:-1] + (2 * rows.shape[-1],), -1, np.int32)
    out[..., 1::2] = rows
    return out


@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_p2l_matches_pallas_at_batch_two_with_gapped_rows(kernel):
    """The P2L wrapper (its plain version on these CPU tensors) on two
    problems in one call, their p2l rows spread with -1 between the
    occupied slots: each row of the batch against the reference's Pallas
    P2L of that problem with the same gapped lists; leaves with no entry
    exactly 0 in both."""
    cfg = SMALL | dict(kernel=kernel, nlevels=3)
    probs = [shared_plan(d, 2048, seed=s, **cfg)
             for d, s in (("normal", 13), ("layer", 14))]
    jcfg, tcfg = probs[0][:2]
    idx = leaf_particle_index(tcfg)
    staged, want = [], []
    for _, _, jp, plan in probs:
        gapped = _gapped(np.asarray(jp.conn.p2l))
        rho = JF.effective_radii(jp.tree, jcfg)[jcfg.nlevels]
        want.append(np.asarray(jax_p2l(
            jp.tree, jp.conn._replace(p2l=jnp.asarray(gapped)), jcfg, idx,
            rho)))
        args, kw = p2l_operands(plan.tree, plan.conn._replace(
            p2l=torch.from_numpy(gapped)[None]), tcfg, t(rho))
        staged.append(args)
    args = [torch.cat(parts) for parts in zip(*staged)]
    lists = args[0]
    assert lists.shape == (2, 4**3, 2 * tcfg.strong_cap)
    assert bool((lists[..., 0::2] < 0).all()) and bool((lists >= 0).any())
    empty = ~(lists >= 0).any(-1)
    assert bool(empty.any()) and bool((~empty).any())
    got = torch.complex(*p2l_cuda(*args, **kw))
    for b in range(2):
        assert rel(got[b], want[b]) <= TOL
        assert bool((got[b][empty[b]] == 0).all())
        assert np.all(want[b][empty[b].numpy()] == 0)


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors each wrapper returns exactly its plain version."""
    jcfg, tcfg, jp, plan = shared_plan("normal", 1024, seed=5, **SMALL)
    cfg = tcfg
    mult = F.upward(plan.tree, cfg)
    rho = F.effective_radii(plan.tree, cfg)
    args, _ = m2l_operands(mult, plan.conn.weak, plan.tree.centers, cfg, rho)
    for a, b in zip(m2l_cuda(*args), m2l_plain(*args)):
        assert torch.equal(a, b)
    args, kw = p2l_operands(plan.tree, plan.conn, cfg, rho[-1])
    for a, b in zip(p2l_cuda(*args, **kw), p2l_plain(*args, **kw)):
        assert torch.equal(a, b)
    local = F.downward(mult, plan.tree, plan.conn, cfg, rho)
    args, kw = eval_operands(local, mult[-1], plan.tree, plan.conn, cfg)
    out = eval_fused_plain(*args, **kw)
    phi = eval_fused_apply(local, mult[-1], plan.tree, plan.conn, cfg)
    assert phi.shape == (1, cfg.n) and torch.isfinite(phi).all()
    assert out[0].shape == (1, cfg.nboxes, 64)


def test_p2l_plain_masks_a_particle_on_the_target_center():
    """The kernel's d2 > 0 mask: a source particle exactly at the target
    box center contributes 0 (where the plain sweep goes singular); every
    other particle contributes as in ``core.fmm.p2l_sweep``."""
    _, cfg, _, plan = shared_plan("normal", 1024, seed=6, **SMALL)
    idx = leaf_particle_index(cfg)
    rho = F.effective_radii(plan.tree, cfg)[-1]
    zero = torch.zeros((1, cfg.nboxes, cfg.p + 1), dtype=torch.complex128)
    sweep = F.p2l_sweep(zero, plan.tree, plan.conn, cfg, rho)
    got = p2l_apply(plan.tree, plan.conn, cfg, rho)
    assert rel(got, sweep) <= TOL
    p2l = plan.conn.p2l[0]
    tgt = int(torch.nonzero((p2l >= 0).any(-1))[0])
    src = int(p2l[tgt][p2l[tgt] >= 0][0])
    rank = int(idx[src][0])
    z = plan.tree.z.clone()
    z[0, rank] = plan.tree.centers[-1][0, tgt]
    moved = plan.tree._replace(z=z)
    got2 = p2l_apply(moved, plan.conn, cfg, rho)
    assert torch.isfinite(got2).all()
    q0 = plan.tree.q.clone()
    q0[0, rank] = 0
    without = p2l_apply(moved._replace(q=q0), plan.conn, cfg, rho)
    assert torch.equal(got2[0, tgt], without[0, tgt])
