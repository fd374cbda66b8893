"""Direct all-pairs N-body sum (the FMM's O(N^2) baseline): CUDA kernel
+ its plain version.

The kernel (``csrc/nbody.cu``) replaces the reference's Pallas kernel
``repro/kernels/nbody/nbody.py:_nbody_pallas``. Operands are 1-D real
planes of one dtype: targets (tzr, tzi) of length N, sources (szr, szi)
and charges (sqr, sqi) of length M. Result: (outr, outi) of length N,

    phi(y_i) = sum_{j : x_j != y_i} q_j / (x_j - y_i)     (harmonic only)

with self-interaction excluded by position (|x_j - y_i|^2 > 0), not by
rank: every source at a target's position drops out.

The launch geometry is ``nbody_plan``'s: target tiles of
``THREADS * K`` targets (K a thread, by the real's size), and, where
those tiles alone cannot fill the card, source splits whose partial sums
the kernel adds in split order inside the same launch.
"""
from __future__ import annotations

import torch

from ..build import CudaLibrary, I, P, check_tensors, on_cpu

LIB = CudaLibrary("nbody", {
    f"nbody_{s}": [P, P, I, P, P, P, P, I, I, I, I, P, P, P, P, P, P]
    for s in ("f32", "f64")})

#: Threads of a block (NB_THREADS in csrc/nbody.cu).
THREADS = 128
#: Targets a thread, by the real's size in bytes (Nb<T>::K in the kernel).
TARGETS_PER_THREAD = {4: 4, 8: 2}
#: Blocks a launch wants, per SM: four 128-thread blocks (16 warps).
BLOCKS_PER_SM = 4
#: Fewest sources in one split.
MIN_CHUNK = 2
#: SMs of an H100 SXM, the default card.
H100_SMS = 132

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


def nbody_plan(n: int, m: int, elem: int,
               sms: int = H100_SMS) -> tuple[int, int, int]:
    """Launch geometry of ``n`` targets and ``m`` sources of ``elem``-byte
    reals on a card of ``sms`` SMs: (target tiles, source splits,
    sources a split). One split when the target tiles fill the card
    (BLOCKS_PER_SM blocks an SM); otherwise enough splits to fill it, none
    of fewer than MIN_CHUNK sources. Split s covers sources
    [s * chunk, min(m, (s + 1) * chunk)): every split is non-empty and
    together they cover the m sources exactly."""
    tiles = -(-n // (THREADS * TARGETS_PER_THREAD[elem]))
    want = BLOCKS_PER_SM * sms
    if m == 0 or tiles >= want:
        return tiles, 1, m
    splits = min(-(-want // tiles), -(-m // MIN_CHUNK))
    chunk = -(-m // splits)
    return tiles, -(-m // chunk), chunk


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
    sms = torch.cuda.get_device_properties(tzr.device).multi_processor_count
    tiles, splits, chunk = nbody_plan(n, m, tzr.element_size(), sms)
    wsr = wsi = tickets = None
    if splits > 1:
        wsr, wsi = torch.empty((2, splits, n), dtype=dt,
                               device=tzr.device).unbind()
        tickets = torch.zeros(tiles, dtype=torch.int32, device=tzr.device)
    sfx = "f64" if dt == torch.float64 else "f32"
    LIB.launch(f"nbody_{sfx}", tzr, tzi, n, szr, szi, sqr, sqi, m, tiles,
               splits, chunk, outr, outi, wsr, wsi, tickets)
    return outr, outi
