"""Direct all-pairs N-body sum (the FMM's O(N^2) baseline): CUDA kernel
+ its plain version.

The kernel (``csrc/nbody.cu``) replaces the reference's Pallas kernel
``repro/kernels/nbody/nbody.py:_nbody_pallas``. Operands are 1-D real
planes of one dtype: targets (tzr, tzi) of length N, sources (szr, szi)
and charges (sqr, sqi) of length M. Result: (outr, outi) of length N,

    phi(y_i) = sum_{j : x_j != y_i} q_j / (x_j - y_i)     (harmonic only)

with self-interaction excluded by position (|x_j - y_i|^2 > 0), not by
rank: every source at a target's position drops out.
"""
from __future__ import annotations

import torch

from ..build import CudaLibrary, I, P, check_tensors, on_cpu

LIB = CudaLibrary("nbody", {
    f"nbody_{s}": [P, P, I, P, P, P, P, I, P, P, P] for s in ("f32", "f64")})

#: Elements of one (targets, sources) pairwise block of the plain version.
PLAIN_BLOCK = 1 << 24


def nbody_plain(tzr, tzi, szr, szi, sqr, sqi):
    """Plain torch version of the kernel (same operands and result),
    chunked over the sources to bound its working set."""
    n = tzr.shape[0]
    chunk = max(1, PLAIN_BLOCK // max(1, n))
    outr, outi = torch.zeros_like(tzr), torch.zeros_like(tzi)
    zero = torch.zeros((), dtype=tzr.dtype, device=tzr.device)
    for s in range(0, szr.shape[0], chunk):
        dx = szr[None, s:s + chunk] - tzr[:, None]        # x_j - y_i
        dy = szi[None, s:s + chunk] - tzi[:, None]
        d2 = dx * dx + dy * dy
        ok = d2 > 0
        inv = torch.where(ok, 1.0 / torch.where(ok, d2, zero + 1), zero)
        qr, qi = sqr[None, s:s + chunk], sqi[None, s:s + chunk]
        outr = outr + ((qr * dx + qi * dy) * inv).sum(dim=-1)
        outi = outi + ((qi * dx - qr * dy) * inv).sum(dim=-1)
    return outr, outi


def nbody_cuda(tzr, tzi, szr, szi, sqr, sqi):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(tzr):
        return nbody_plain(tzr, tzi, szr, szi, sqr, sqi)
    n, m = tzr.shape[0], szr.shape[0]
    dt = tzr.dtype
    check_tensors(tzr, tzi, szr, szi, sqr, sqi, dtype=dt, device=tzr.device)
    if tzi.shape != (n,) or any(a.shape != (m,) for a in (szi, sqr, sqi)):
        raise ValueError("nbody wants 1-D target and source planes")
    outr = torch.empty_like(tzr)
    outi = torch.empty_like(tzi)
    if n == 0:
        return outr, outi
    sfx = "f64" if dt == torch.float64 else "f32"
    LIB.launch(f"nbody_{sfx}", tzr, tzi, n, szr, szi, sqr, sqi, m, outr,
               outi)
    return outr, outi
