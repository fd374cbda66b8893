"""Level-fused M2L translation: CUDA kernel + its plain torch version.

The kernel (``csrc/m2l.cu``) replaces the reference's Pallas kernel
``repro/kernels/m2l/m2l.py:_m2l_pallas``. Operands are real/imaginary
planes with a leading problem axis B, over a level-agnostic box axis NB
(all levels flattened, see ``ops.m2l_fused_apply``):

  weak        (B, NB, W) int32 weak lists (-1 masked), already offset
              onto the flat box axis
  ar, ai      (B, NB, P) radius-normalized multipoles, P = p + 1
  cr, ci      (B, NB) box centers
  rho         (B, NB) effective box radii
  h           (P, P) the constant Hankel matrix H[l, k]
  kernel      "harmonic" or "log" (adds a_0 log r to l = 0)

and the result is (outr, outi), (B, NB, P): the summed normalized local
contributions per target box. K densities on one plan (B = 1): ar, ai
and the result carry K rows, the lists, centres and radii one; the
kernel is then ``m2l_block_kernel<T, LOG, PF, KD>`` (entry
``m2l_block_<dtype>``), each occupied entry's ratio powers taken once
for its KD rows, in launches of KD = 8 densities; the rest of K runs
one density a launch on ``m2l_kernel`` (``common.density_chunks``).
Both versions compute each occupied slot's
ratios from the centers and radii — r = c_t - c_s, rho_s / r and
-rho_t / r — with the same roundings, then the power recurrences, the
product with H and the post-scale.
"""
from __future__ import annotations

import torch

from ..build import CudaLibrary, I, P, check_tensors, on_cpu
from ..common import density_chunks, geometry_rows

LIB = CudaLibrary("m2l", {
    f"m2l{k}_{s}": [P] * 7 + [I] * 5 + [P, P, P]
    for k in ("", "_block") for s in ("f32", "f64")})

#: Weak-list slots per step of the plain version (bounds its working set).
PLAIN_CHUNK = 16


def _pows(x: torch.Tensor, n: int) -> torch.Tensor:
    out = [torch.ones_like(x)]
    for _ in range(n - 1):
        out.append(out[-1] * x)
    return torch.stack(out, dim=-1)


def _ratio(sc, rr, ri, k):
    """sc / r for r = rr + i ri, k = 1 / |r|^2 (the kernel's roundings)."""
    return torch.complex(sc * rr * k, -sc * ri * k)


def m2l_plain(weak, ar, ai, cr, ci, rho, h, kernel: str = "harmonic"):
    """Plain torch version of the kernel (same operands and result)."""
    B, NB, W = weak.shape
    Pn = ar.shape[-1]
    a_all = torch.complex(ar, ai)
    ht = h.to(a_all.dtype).T
    out = torch.zeros_like(a_all)
    zero = torch.zeros((), dtype=a_all.dtype, device=a_all.device)
    bidx = torch.arange(B, device=weak.device).view(B, 1, 1)
    # the multipoles' rows: B problems, or K densities on one geometry
    kidx = torch.arange(a_all.shape[0], device=weak.device).view(-1, 1, 1)
    for s in range(0, W, PLAIN_CHUNK):
        wk = weak[..., s:s + PLAIN_CHUNK].long()
        mask = wk >= 0
        src = torch.where(mask, wk, torch.zeros_like(wk))
        a = a_all[kidx, src]
        rr = cr[..., None] - cr[bidx, src]            # r = c_t - c_s
        ri = ci[..., None] - ci[bidx, src]
        k = 1 / (rr * rr + ri * ri)                   # masked: any value
        pre = _pows(_ratio(rho[bidx, src], rr, ri, k), Pn)
        post = _pows(_ratio(-rho[..., None], rr, ri, k), Pn)
        contrib = ((a * pre) @ ht) * post
        if kernel == "log":
            lg = torch.complex(0.5 * torch.log(rr * rr + ri * ri),
                               torch.atan2(ri, rr))
            contrib[..., 0] = contrib[..., 0] + a[..., 0] * lg
        out = out + torch.where(mask[..., None], contrib, zero).sum(dim=2)
    return out.real.contiguous(), out.imag.contiguous()


def m2l_cuda(weak, ar, ai, cr, ci, rho, h, kernel: str = "harmonic"):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(weak):
        return m2l_plain(weak, ar, ai, cr, ci, rho, h, kernel)
    B, NB, W = weak.shape
    Pn = ar.shape[-1]
    dt = ar.dtype
    check_tensors(weak, dtype=torch.int32)
    check_tensors(ar, ai, cr, ci, rho, h, dtype=dt, device=weak.device)
    outr = torch.empty(ar.shape, dtype=dt, device=weak.device)
    outi = torch.empty_like(outr)
    sfx = "f64" if dt == torch.float64 else "f32"
    if not geometry_rows(weak, ar):
        LIB.launch(f"m2l_{sfx}", weak, ar, ai, cr, ci, rho, h, B, NB, W, Pn,
                   int(kernel == "log"), outr, outi)
        return outr, outi
    for k0, kd in density_chunks(ar.shape[0]):
        rows_ = slice(k0, k0 + kd)
        LIB.launch(f"m2l{'' if kd == 1 else '_block'}_{sfx}", weak,
                   ar[rows_], ai[rows_], cr, ci, rho, h, kd, NB, W, Pn,
                   int(kernel == "log"), outr[rows_], outi[rows_])
    return outr, outi
