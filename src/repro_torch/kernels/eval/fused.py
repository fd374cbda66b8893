"""The whole evaluation phase in one launch: CUDA kernel + plain version.

The kernel (``csrc/eval_fused.cu``) replaces the reference's Pallas
kernel ``repro/kernels/eval/fused.py:_eval_fused_pallas``: L2P Horner
seed, P2P over the strong (p2p) list with rank self-exclusion, M2P over
the m2p list, phi written once. Operands, with a leading problem axis B:

  p2p_lists       (B, nb, S) int32 (-1 masked)
  m2p_lists       (B, nb, Sm) int32, or None (``use_p2l_m2p=False``: no
                  M2P region)
  zr, zi, qr, qi  (B, nb, n) dense leaf particle planes — targets and
                  sources are the same planes
  rk              (nb, n) int32 global particle ranks (-1 padded), shared
                  by the batch
  tr, ti          (B, nb, n) pre-centered normalized target positions
  br, bi          (B, nb, P) local coefficients, P = p + 1
  ar, ai          (B, nb, P) leaf multipoles (M2P sources)
  mcr, mci, mrho  (B, nb) leaf centers and effective radii (M2P sources)

Result: (outr, outi), (B, nb, n) — the evaluation-phase potential at the
dense leaf slots.

K densities on one plan (B = 1): qr, qi, br, bi, ar, ai and the result
carry K rows, every other operand one. The kernel is then
``eval_block_kernel<T, LOG, KD>`` (the entry ``eval_block_<dtype>``):
each pair's geometry and logarithm or reciprocal once for its KD
charges, in launches of KD = 8 densities; the rest of K runs one
density a launch on ``eval_fused_kernel`` (``common.density_chunks``).
"""
from __future__ import annotations

import torch

from ...core.fmm import rows
from ..build import CudaLibrary, I, P, check_tensors, on_cpu
from ..common import density_chunks, geometry_rows, l2p_horner, p2p_slots

LIB = CudaLibrary("eval_fused", {
    f"eval_{k}_{s}": [P, I, P, I] + [P] * 14 + [I] * 5 + [P, P, P]
    for k in ("fused", "block") for s in ("f32", "f64")})


def eval_fused_plain(p2p_lists, m2p_lists, zr, zi, qr, qi, rk, tr, ti, br,
                     bi, ar=None, ai=None, mcr=None, mci=None, mrho=None, *,
                     p: int, kernel: str = "harmonic"):
    """Plain torch version of the kernel (same operands and result)."""
    dt = zr.dtype
    zero = torch.zeros((), dtype=dt, device=zr.device)
    one = zero + 1
    accr, acci = l2p_horner(p, br, bi, tr, ti)            # L2P seed
    accr, acci = p2p_slots(accr, acci, p2p_lists, zr, zi, qr, qi, rk,
                           kernel)                        # P2P
    # M2P
    if m2p_lists is not None:
        for s in range(m2p_lists.shape[-1]):
            src = m2p_lists[..., s].long()
            srcc = torch.where(src >= 0, src, torch.zeros_like(src))
            a_r, a_i = rows(ar, srcc), rows(ai, srcc)       # (B, nb, P)
            rh = torch.where(src >= 0, rows(mrho, srcc), zero)[..., None]
            dxr = zr - rows(mcr, srcc)[..., None]
            dxi = zi - rows(mci, srcc)[..., None]
            d2 = dxr * dxr + dxi * dxi
            ok = rh > 0
            k = torch.where(ok, 1.0 / torch.where(ok, d2, one), zero)
            wr, wi = rh * dxr * k, -rh * dxi * k
            hr = torch.zeros_like(wr) + a_r[..., p:p + 1]
            hi = torch.zeros_like(wi) + a_i[..., p:p + 1]
            for j in range(p - 1, 0, -1):
                hr, hi = (hr * wr - hi * wi + a_r[..., j:j + 1],
                          hr * wi + hi * wr + a_i[..., j:j + 1])
            fr, fi = hr * wr - hi * wi, hr * wi + hi * wr
            if kernel == "log":
                lr = torch.where(ok, 0.5 * torch.log(torch.where(ok, d2, one)),
                                 zero)
                li = torch.where(ok, torch.atan2(dxi, dxr), zero)
                fr = fr + a_r[..., 0:1] * lr - a_i[..., 0:1] * li
                fi = fi + a_r[..., 0:1] * li + a_i[..., 0:1] * lr
            accr = accr + torch.where(ok, fr, zero)
            acci = acci + torch.where(ok, fi, zero)
    return accr, acci


def eval_fused_cuda(p2p_lists, m2p_lists, zr, zi, qr, qi, rk, tr, ti, br,
                    bi, ar=None, ai=None, mcr=None, mci=None, mrho=None, *,
                    p: int, kernel: str = "harmonic"):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    with_m2p = m2p_lists is not None
    if with_m2p and (ar is None or mcr is None):
        raise ValueError("m2p region needs multipole and source planes")
    if on_cpu(p2p_lists):
        return eval_fused_plain(p2p_lists, m2p_lists, zr, zi, qr, qi, rk,
                                tr, ti, br, bi, ar, ai, mcr, mci, mrho, p=p,
                                kernel=kernel)
    B, nb, S = p2p_lists.shape
    n = zr.shape[-1]
    dt = zr.dtype
    dev = p2p_lists.device
    check_tensors(p2p_lists, m2p_lists, rk, dtype=torch.int32, device=dev)
    check_tensors(zr, zi, qr, qi, tr, ti, br, bi, ar, ai, mcr, mci, mrho,
                  dtype=dt, device=dev)
    Sm = m2p_lists.shape[-1] if with_m2p else 0
    K = qr.shape[0]
    outr = torch.empty((K, nb, n), dtype=dt, device=dev)
    outi = torch.empty_like(outr)
    sfx = "f64" if dt == torch.float64 else "f32"
    if not geometry_rows(p2p_lists, qr):
        LIB.launch(f"eval_fused_{sfx}", p2p_lists, S, m2p_lists, Sm, zr, zi,
                   qr, qi, rk, tr, ti, br, bi, ar, ai, mcr, mci, mrho, B, nb,
                   n, p + 1, int(kernel == "log"), outr, outi)
        return outr, outi
    for k0, kd in density_chunks(K):
        rows_ = slice(k0, k0 + kd)
        a_r, a_i = ((ar[rows_], ai[rows_]) if with_m2p else (None, None))
        LIB.launch(f"eval_{'fused' if kd == 1 else 'block'}_{sfx}",
                   p2p_lists, S, m2p_lists, Sm, zr, zi, qr[rows_],
                   qi[rows_], rk, tr, ti, br[rows_], bi[rows_], a_r, a_i,
                   mcr, mci, mrho, kd, nb, n, p + 1, int(kernel == "log"),
                   outr[rows_], outi[rows_])
    return outr, outi
