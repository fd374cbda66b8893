"""Operations and bytes of the main path's M2L and fused evaluation
kernels, and the least time the card could take for them.

Frozen from the bound of the port's kernel table (``PERF.md``, "Every
TPU kernel of the repo"): operations counted on the list entries that
are actually occupied (a division or a transcendental one operation
each), each input read once and each output written once. ``work`` is a
solve's list occupancy as ``bench/traffic/solve.py:list_work`` reads it
from a plan: occupied ``weak`` entries over the fused levels, ``p2p`` and
``m2p`` entries, and the sizes the bytes need.

Peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W limit): vector
f32 67 and f64 34 TFLOP/s outside the tensor cores, a dense f64 matrix
product 67 TFLOP/s on the FP64 tensor cores (the M2L product with its
constant matrix H; f32 stays at the vector rate), HBM3 3.35 TB/s.
"""
from __future__ import annotations

import math

PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
PEAK_DENSE = {"f32": 67e12, "f64": 67e12}
PEAK_BYTES = 3.35e12


def _size(work: dict) -> int:
    return 8 if work["dtype"] == "f64" else 4


def _boxes(work: dict) -> int:
    """Boxes of the fused M2L's flat axis: levels 1..L (the root alone
    at L = 0)."""
    L = work["nlevels"]
    return sum(4 ** l for l in range(1, L + 1)) if L else 1


def _leaf_width(work: dict) -> int:
    """Particles of the fullest leaf (exact median splits)."""
    return math.ceil(work["n"] / 4 ** work["nlevels"])


def m2l(work: dict, batch: int = 1) -> tuple[float, float, float]:
    """(operations, of them dense, bytes) of one fused M2L launch."""
    P = work["p"] + 1
    p = work["p"]
    sz = _size(work)
    boxes = batch * _boxes(work)
    entries = work["weak"]
    per = 4 * P * P + 6 * P + 12 * p + 8 * P
    # weak lists, multipole planes, centers and radii, H; the result
    nbytes = (boxes * work["weak_cap"] * 4 + 2 * boxes * P * sz
              + 3 * boxes * sz + P * P * sz + 2 * boxes * P * sz)
    return float(per * entries), 4.0 * P * P * entries, float(nbytes)


def eval_fused(work: dict, batch: int = 1) -> tuple[float, float, float]:
    """(operations, of them dense, bytes) of one fused evaluation launch
    (L2P at every particle slot, P2P over the strong lists, M2P over the
    swapped lists)."""
    p = work["p"]
    P = p + 1
    sz = _size(work)
    leaves = 4 ** work["nlevels"]
    n = _leaf_width(work)
    plane = batch * leaves * n
    flops = plane * 8 * p + work["p2p"] * n * n * 14
    lists = batch * leaves * work["strong_cap"]
    # p2p lists, particle planes (z, q; rank-ordered targets), rank
    # planes, local coefficients; the result
    nbytes = (lists * 4 + 6 * plane * sz + leaves * n * 4
              + 2 * batch * leaves * P * sz + 2 * plane * sz)
    if work["m2p_lists"]:
        flops += work["m2p"] * n * (8 * p + 14)
        # m2p lists, multipole planes, their centers and radii
        nbytes += (lists * 4 + 2 * batch * leaves * P * sz
                   + 3 * batch * leaves * sz)
    return float(flops), 0.0, float(nbytes)


def bound_s(work: tuple[float, float, float], dtype: str) -> float:
    """The least time of ``(operations, dense, bytes)``: the larger of
    the operations at their peaks and the bytes at the bandwidth."""
    flops, dense, nbytes = work
    ops = (flops - dense) / PEAK_FLOPS[dtype] + dense / PEAK_DENSE[dtype]
    return max(ops, nbytes / PEAK_BYTES)


def roofline(run, kernel: str, count) -> float | None:
    """The share (%) of its bound that ``kernel`` (a part of its device
    name) reached over the traced solves: their mean bound over the
    kernel's mean device time a launch (the main path launches it once a
    solve). Means, because the profiler can lose a few of a slice's
    ~10^5 device records under load: a lost launch changes neither. None
    without a trace, without a launch or without the solves' list
    occupancy."""
    works = run.readings.get("traced_work")
    if run.digest is None or not works:
        return None
    launches, seconds = run.digest.kernel(kernel)
    if not launches or seconds <= 0:
        return None
    bound = sum(bound_s(count(w), w["dtype"]) for w in works) / len(works)
    return 100.0 * bound / (seconds / launches)
