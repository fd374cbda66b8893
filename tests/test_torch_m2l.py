"""PyTorch port, the M2L operands: the hooks ``m2l_fused_apply`` and
``m2l_level_apply`` take (B, NB) centers and radii and leave the
per-slot ratios to the kernel (and to its plain version, which runs on
these CPU tensors). Held against the reference's Pallas wrappers
(interpret mode) on the same numpy-seeded plans, f64 within 1e-10
relative: both G-kernels at B = 2, a box whose slots are all masked
(exactly 0), weak rows with gaps between their occupied slots, and the
root-only case (nlevels = 0)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fmm as JF
from repro.kernels.m2l import m2l_fused_apply as jax_m2l_fused
from repro.kernels.m2l import m2l_level_apply as jax_m2l_level
from repro_torch.kernels import m2l_fused_apply, m2l_level_apply, m2l_operands

from _torch_parity import rel, shared_plan, t

TOL = 1e-10
SMALL = dict(nlevels=3, p=8, dtype="f64", strong_cap=16, weak_cap=64)


def _problem(dist, n, seed, **kw):
    """One plan in both packages: (jax config, torch config, the
    reference's per-level expansions, radii, weak lists and centers, and
    the same as torch lists with a leading B = 1 axis)."""
    jcfg, tcfg, jp, plan = shared_plan(dist, n, seed=seed, **(SMALL | kw))
    mult = JF.upward(jp.tree, jcfg)
    rho = JF.effective_radii(jp.tree, jcfg)
    ref = dict(mult=mult, rho=rho, weak=list(jp.conn.weak),
               centers=list(jp.tree.centers))
    got = dict(mult=[t(m) for m in mult], rho=[t(r) for r in rho],
               weak=list(plan.conn.weak), centers=list(plan.tree.centers))
    return jcfg, tcfg, ref, got


def _stack(*problems):
    """Per-level torch lists of several problems along the B axis."""
    return {k: [torch.cat(parts) for parts in zip(*(p[k] for p in problems))]
            for k in problems[0]}


def _fused(cfg, d, apply):
    return apply(d["mult"], d["weak"], d["centers"], cfg, d["rho"])


@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_m2l_hooks_match_pallas_at_batch_two(kernel):
    probs = [_problem("normal", 2048, seed, kernel=kernel) for seed in (7, 8)]
    jcfg, tcfg = probs[0][:2]
    both = _stack(probs[0][3], probs[1][3])
    got = _fused(tcfg, both, m2l_fused_apply)
    for b, (_, _, ref, _) in enumerate(probs):
        want = _fused(jcfg, ref, jax_m2l_fused)
        assert len(got) == len(want) == jcfg.nlevels
        for g, w in zip(got, want):
            assert g.shape == (2,) + w.shape
            assert rel(g[b], w) <= TOL
        for l in range(1, jcfg.nlevels + 1):
            lv = m2l_level_apply(both["mult"][l], both["weak"][l],
                                 both["centers"][l], tcfg, both["rho"][l])
            w = jax_m2l_level(ref["mult"][l], ref["weak"][l],
                              ref["centers"][l], jcfg, ref["rho"][l])
            assert rel(lv[b], w) <= TOL
    # each row of the batch is that problem's own result
    alone = _fused(tcfg, probs[1][3], m2l_fused_apply)
    for g, a in zip(got, alone):
        assert rel(g[1], a[0]) <= TOL


def test_m2l_box_with_every_slot_masked_is_exactly_zero():
    jcfg, tcfg, ref, got = _problem("uniform", 2048, 9)
    l = jcfg.nlevels
    weak = np.array(ref["weak"][l])
    box = int(np.argmax((weak >= 0).sum(axis=1)))
    assert (weak[box] >= 0).sum() > 0
    weak[box] = -1
    ref["weak"][l] = jnp.asarray(weak)
    got["weak"][l] = torch.from_numpy(weak)[None]
    out = _fused(tcfg, got, m2l_fused_apply)
    want = _fused(jcfg, ref, jax_m2l_fused)
    assert bool((out[-1][0, box] == 0).all())
    assert np.all(np.asarray(want[-1])[box] == 0)
    for g, w in zip(out, want):
        assert rel(g[0], w) <= TOL
    # level 1: four boxes that are all neighbours, no weak entries at all
    assert not (got["weak"][1] >= 0).any()
    assert bool((out[0] == 0).all())


def test_m2l_weak_rows_with_gaps():
    """The occupied slots spread over a twice as wide row, -1 between
    them: the same sum, in the same order."""
    jcfg, tcfg, ref, got = _problem("layer", 2048, 10, kernel="log")
    packed = _fused(tcfg, got, m2l_fused_apply)
    for l in range(1, jcfg.nlevels + 1):
        weak = np.array(ref["weak"][l])
        gapped = np.full((weak.shape[0], 2 * weak.shape[1]), -1, np.int32)
        gapped[:, 1::2] = weak
        ref["weak"][l] = jnp.asarray(gapped)
        got["weak"][l] = torch.from_numpy(gapped)[None]
    spread = _fused(tcfg, got, m2l_fused_apply)
    want = _fused(jcfg, ref, jax_m2l_fused)
    for s, p, w in zip(spread, packed, want):
        assert rel(s[0], w) <= TOL
        assert rel(s[0], p[0]) <= TOL
    args, _ = m2l_operands(got["mult"], got["weak"], got["centers"], tcfg,
                           got["rho"])
    assert args[0].shape[-1] == 2 * tcfg.weak_cap


@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_m2l_root_only(kernel):
    """nlevels = 0: one box, no weak entries; the fused hook covers the
    root alone and gives exactly 0, as the reference does."""
    jcfg, tcfg, ref, got = _problem("uniform", 40, 11, nlevels=0,
                                    kernel=kernel)
    out = _fused(tcfg, got, m2l_fused_apply)
    want = _fused(jcfg, ref, jax_m2l_fused)
    assert len(out) == len(want) == 1
    assert out[0].shape == (1, 1, tcfg.p + 1)
    assert bool((out[0] == 0).all())
    assert np.all(np.asarray(want[0]) == 0)
    lv = m2l_level_apply(got["mult"][0], got["weak"][0], got["centers"][0],
                         tcfg, got["rho"][0])
    assert bool((lv == 0).all())


def test_m2l_operands_carry_no_per_slot_planes():
    """The staged operands: the weak lists (B, NB, W) and nothing else
    per slot — multipoles (B, NB, P), centers and radii (B, NB), H."""
    jcfg, tcfg, _, got = _problem("normal", 2048, 12, kernel="log")
    args, offs = m2l_operands(got["mult"], got["weak"], got["centers"], tcfg,
                              got["rho"])
    weak, ar, ai, cr, ci, rho, h, kernel = args
    NB = int(offs[-1])
    assert weak.shape == (1, NB, tcfg.weak_cap) and weak.dtype == torch.int32
    assert ar.shape == ai.shape == (1, NB, tcfg.p + 1)
    assert cr.shape == ci.shape == rho.shape == (1, NB)
    assert h.shape == (tcfg.p + 1, tcfg.p + 1) and kernel == "log"
    assert all(a.dtype == torch.float64 and a.is_contiguous()
               for a in (ar, ai, cr, ci, rho, h))
