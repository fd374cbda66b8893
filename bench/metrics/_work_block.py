"""Operations and bytes of the K-density kernels (K densities on one
plan: the fused evaluation, the level-fused M2L, P2L and the upward
pass), for their roofline shares.

A term that depends on the geometry alone is counted once a launch, a
term of a density K times, and every byte once: the point of the
density axis is that the geometry is computed and read once for K
densities. Operations are counted as the plain formula computes each
term, a division, a log or an atan2 one operation each (a stated lower
bound, independent of how the kernel computes them):

  near-field pair  G = log: d = x - z (2) and log d (6) once (the 8 of
                   ``_work_log``'s 16 that are geometry), q log d (6) and
                   its accumulation (2) a density; harmonic: d, |d|^2 and
                   its reciprocal (6) once, q conj(d) / |d|^2 and its
                   accumulation (8) a density (``_work``'s 14 split)
  L2P target       the p-term Horner (8 p) a density
  M2P target       w = rho / (z - z0) (14) once, with log(z - z0) (6) for
                   G = log; the Horner (8 p) and, for G = log, a_0 log
                   (8) a density
  M2L entry        r, the two ratios and their powers (12 p + 14) once;
                   the pre-scaling (6 P), the H product (4 P^2, dense)
                   and the post-scaling and sum (8 P) a density
  P2L particle     1 / (x - z0) and w (10) once, with log (6) for G =
                   log; the power recurrence and sum (8 P) a density
  upward           a particle's w (4) once, its P2M terms (8 p) a
                   density; a box's ratio and u (6) once, its M2M (4 p^2
                   + 16 p) a density

``work`` is ``bench/traffic/block_matvec.py:block_work``: the plan's
occupied ``weak``, ``p2p``, ``m2p`` and ``p2l`` entries, the sizes, the
G ``kernel`` and ``densities``, the K one launch evaluates.
"""
from __future__ import annotations

from ._work import _boxes, _leaf_width, _size, bound_s


def _log(work: dict) -> bool:
    return work.get("kernel", "log") == "log"


def eval_block(work: dict) -> tuple[float, float, float]:
    """(operations, of them dense, bytes) of one K-density fused
    evaluation launch."""
    K, p = work["densities"], work["p"]
    P = p + 1
    sz = _size(work)
    leaves = 4 ** work["nlevels"]
    n = _leaf_width(work)
    plane = leaves * n
    pairs = work["p2p"] * n * n
    lg = _log(work)
    flops = pairs * ((8 if lg else 6) + 8 * K) + K * plane * 8 * p
    lists = leaves * work["strong_cap"]
    # p2p lists, positions, targets and ranks once; K charge planes, K
    # local planes and K results
    nbytes = (lists * 4 + 4 * plane * sz + plane * 4
              + K * (2 * plane * sz + 2 * leaves * P * sz + 2 * plane * sz))
    if work["m2p_lists"]:
        flops += work["m2p"] * n * (14 + K * 8 * p
                                    + (6 + 8 * K if lg else 0))
        nbytes += (lists * 4 + 3 * leaves * sz + K * 2 * leaves * P * sz)
    return float(flops), 0.0, float(nbytes)


def m2l_block(work: dict) -> tuple[float, float, float]:
    """(operations, of them dense, bytes) of one K-density fused M2L
    launch."""
    K, p = work["densities"], work["p"]
    P = p + 1
    sz = _size(work)
    boxes = _boxes(work)
    entries = work["weak"]
    flops = entries * (12 * p + 14 + K * (6 * P + 4 * P * P + 8 * P))
    dense = entries * K * 4.0 * P * P
    # weak lists, centres and radii, H once; K multipole planes and K
    # results
    nbytes = (boxes * work["weak_cap"] * 4 + 3 * boxes * sz + P * P * sz
              + K * 4 * boxes * P * sz)
    return float(flops), dense, float(nbytes)


def p2l_block(work: dict) -> tuple[float, float, float]:
    """(operations, of them dense, bytes) of one K-density P2L launch
    (only the referenced source leaves are read)."""
    K, p = work["densities"], work["p"]
    P = p + 1
    sz = _size(work)
    leaves = 4 ** work["nlevels"]
    n = _leaf_width(work)
    particles = work["p2l"] * n
    flops = particles * (16 if _log(work) else 10) + particles * K * 8 * P
    # p2l lists (as wide as the m2p lists), leaf centres and radii, the
    # referenced leaves' positions once; their K charges, K results
    nbytes = (leaves * work["strong_cap"] * 4 + 3 * leaves * sz
              + 2 * particles * sz
              + K * (2 * particles * sz + 2 * leaves * P * sz))
    return float(flops), 0.0, float(nbytes)


def upward_block(work: dict) -> tuple[float, float, float]:
    """(operations, of them dense, bytes) of one K-density upward pass
    (both launches)."""
    K, p = work["densities"], work["p"]
    P = p + 1
    sz = _size(work)
    N = work["n"]
    boxes = sum(4 ** l for l in range(work["nlevels"] + 1))
    flops = N * (4 + K * 8 * p) + boxes * (6 + K * (4 * p * p + 16 * p))
    # positions, leaf bounds, centres and radii once; K charges, K
    # multipole planes
    nbytes = (2 * N * sz + (4 ** work["nlevels"] + 1) * 4 + 3 * boxes * sz
              + K * (2 * N * sz + 2 * boxes * P * sz))
    return float(flops), 0.0, float(nbytes)


def block_roofline(run, kernel: str, count, launches: int = 1):
    """The share (%) of its bound that ``kernel`` (a part of its device
    name) reached over the traced calls: their mean bound over the
    kernel's mean device time a call (``launches`` launches a call).
    None without a trace, without a launch or without the calls' work."""
    works = run.readings.get("traced_work")
    if run.digest is None or not works:
        return None
    n, seconds = run.digest.kernel(kernel)
    if not n or seconds <= 0:
        return None
    bound = sum(bound_s(count(w), w["dtype"]) for w in works) / len(works)
    return 100.0 * bound / (seconds * launches / n)
