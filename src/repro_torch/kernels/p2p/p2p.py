"""Near-field P2P over the leaf lists: CUDA kernel + its plain version.

The kernel (``csrc/p2p.cu``) replaces the reference's Pallas kernel
``repro/kernels/p2p/p2p.py:_p2p_pallas``. Operands, with a leading
problem axis B:

  lists           (B, nb, S) int32 P2P lists (-1 masked)
  zr, zi, qr, qi  (B, nb, n) dense leaf particle planes — targets and
                  sources are the same planes
  rk              (nb, n) int32 global particle ranks (-1 padded), shared
                  by the batch

Result: (outr, outi), (B, nb, n) — the near-field potential at the dense
leaf slots, self excluded by rank.

K densities on one plan (the per-phase path of ``core.fmm``'s density
axis): the charge planes and the result carry K rows over the one
geometry, one launch a density.
"""
from __future__ import annotations

import torch

from ..build import CudaLibrary, I, P, check_tensors, on_cpu
from ..common import geometry_rows, p2p_slots

LIB = CudaLibrary("p2p", {
    f"p2p_{s}": [P, I] + [P] * 5 + [I] * 4 + [P, P, P]
    for s in ("f32", "f64")})


def p2p_plain(lists, zr, zi, qr, qi, rk, *, kernel: str = "harmonic"):
    """Plain torch version of the kernel (same operands and result)."""
    zero = torch.zeros_like(zr)
    return p2p_slots(zero, zero, lists, zr, zi, qr, qi, rk, kernel)


def p2p_cuda(lists, zr, zi, qr, qi, rk, *, kernel: str = "harmonic"):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(lists):
        return p2p_plain(lists, zr, zi, qr, qi, rk, kernel=kernel)
    B, nb, S = lists.shape
    n = zr.shape[-1]
    dt = zr.dtype
    dev = lists.device
    check_tensors(lists, rk, dtype=torch.int32, device=dev)
    check_tensors(zr, zi, qr, qi, dtype=dt, device=dev)
    outr = torch.empty(qr.shape, dtype=dt, device=dev)
    outi = torch.empty_like(outr)
    sfx = "f64" if dt == torch.float64 else "f32"
    if not geometry_rows(lists, qr):
        LIB.launch(f"p2p_{sfx}", lists, S, zr, zi, qr, qi, rk, B, nb, n,
                   int(kernel == "log"), outr, outi)
        return outr, outi
    for k in range(qr.shape[0]):     # densities on one plan: one at a time
        LIB.launch(f"p2p_{sfx}", lists, S, zr, zi, qr[k], qi[k], rk, 1, nb,
                   n, int(kernel == "log"), outr[k], outi[k])
    return outr, outi
