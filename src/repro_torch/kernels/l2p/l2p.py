"""Local-expansion evaluation (L2P) at the leaf particles: CUDA kernel +
its plain version.

The kernel (``csrc/l2p.cu``) replaces the reference's Pallas kernel
``repro/kernels/l2p/l2p.py:_l2p_pallas``. Operands, with a leading
problem axis B:

  br, bi  (B, nb, P) local coefficient planes, P = p + 1
  tr, ti  (B, nb, n) pre-centered, radius-normalized particle planes
  rk      (nb, n) int32 global particle ranks (-1 padded)

Result: (outr, outi), (B, nb, n) — the p-term Horner of each box's local
expansion at its particles, 0 in the padded slots.

K densities on one plan (the per-phase path of ``core.fmm``'s density
axis): the coefficient planes and the result carry K rows over the one
geometry, one launch a density.
"""
from __future__ import annotations

import torch

from ..build import CudaLibrary, I, P, check_tensors, on_cpu
from ..common import geometry_rows, l2p_horner

LIB = CudaLibrary("l2p", {
    f"l2p_{s}": [P] * 5 + [I] * 4 + [P, P, P] for s in ("f32", "f64")})


def l2p_plain(br, bi, tr, ti, rk, *, p: int):
    """Plain torch version of the kernel (same operands and result)."""
    outr, outi = l2p_horner(p, br, bi, tr, ti)
    zero = torch.zeros((), dtype=outr.dtype, device=outr.device)
    valid = rk >= 0
    return torch.where(valid, outr, zero), torch.where(valid, outi, zero)


def l2p_cuda(br, bi, tr, ti, rk, *, p: int):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(br):
        return l2p_plain(br, bi, tr, ti, rk, p=p)
    B, nb, Pn = br.shape
    if Pn != p + 1:
        raise ValueError(f"coefficient planes hold {Pn} terms, not p+1="
                         f"{p + 1}")
    n = tr.shape[-1]
    dt = br.dtype
    dev = br.device
    check_tensors(rk, dtype=torch.int32, device=dev)
    check_tensors(br, bi, tr, ti, dtype=dt, device=dev)
    outr = torch.empty((B, nb, n), dtype=dt, device=dev)
    outi = torch.empty_like(outr)
    if outr.numel() == 0:
        return outr, outi
    sfx = "f64" if dt == torch.float64 else "f32"
    if not geometry_rows(tr, br):
        LIB.launch(f"l2p_{sfx}", br, bi, tr, ti, rk, B, nb, n, Pn, outr,
                   outi)
        return outr, outi
    for k in range(B):               # densities on one plan: one at a time
        LIB.launch(f"l2p_{sfx}", br[k], bi[k], tr, ti, rk, 1, nb, n, Pn,
                   outr[k], outi[k])
    return outr, outi
