"""Configuration for the adaptive FMM (Goude & Engblom 2012).

Everything here is *static*: FmmConfig is a frozen, hashable dataclass,
so tree offsets, level sizes and list caps are fixed before any data is
seen — the static-memory-layout property of the paper's asymmetric
adaptivity. The fields and validation are those of the JAX reference
(``repro.core.config``), so a config is carried across by its fields.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

import numpy as np
import torch

Kernel = Literal["harmonic", "log"]


def num_levels_for(n: int, n_d: int) -> int:
    """Paper eq. (5.2): N_l = ceil(0.5*log2(5/8 * N/N_d)).

    ``n_d`` is the desired number of sources per finest-level box (the
    paper's calibration finds n_d≈45 on GPU, ≈35 on CPU).
    """
    if n <= max(n_d, 1):
        return 0
    return max(0, math.ceil(0.5 * math.log2(5.0 / 8.0 * n / n_d)))


@dataclasses.dataclass(frozen=True)
class FmmConfig:
    """Static FMM problem description.

    Attributes:
      n: number of source points (== evaluation points in the kernel path).
      nlevels: tree depth; level l has 4**l boxes; leaves at ``nlevels``.
      p: number of expansion terms (paper's p; p=17 -> TOL ~ 1e-6 at theta=1/2).
      theta: separation parameter of the theta-criterion (2.1).
      kernel: "harmonic" (paper eq. (5.1), a0=0) or "log".
      strong_cap / weak_cap: padded per-box list capacities (checked at build).
      dtype: "f32" or "f64" (the served default is f32).
      m2l_chunk: pair-chunk size for the level M2L sweep (memory knob).
      translations: "mxu" (scaled constant-matrix product form) or
        "horner" (the paper's Algorithms 3.4b/3.5/3.6, kept as the faithful
        baseline).
      use_p2l_m2p: enable the leaf-level swapped-theta reclassification
        (paper §2: Carrier-Greengard optimization). Off -> plain P2P.
      tile_boxes / stage_width: the reference's TPU tiling knobs (target
        boxes per block, list slots staged per grid step). Kept so a
        config round-trips between the two packages field for field and
        validates the same way; the CUDA kernels of this package own one
        leaf (or one box) per block and do not read them.
    """

    n: int
    nlevels: int
    p: int = 17
    theta: float = 0.5
    kernel: Kernel = "harmonic"
    strong_cap: int = 48
    weak_cap: int = 0   # 0 -> 4*strong_cap (structural bound: weak
    #                     candidates are children of the parent's strong set)
    dtype: str = "f32"
    m2l_chunk: int = 16
    translations: str = "mxu"
    use_p2l_m2p: bool = True
    tile_boxes: int = 8
    stage_width: int = 1

    # -- derived static properties ------------------------------------------
    @property
    def nboxes(self) -> int:
        return 4**self.nlevels

    @property
    def real_dtype(self):
        return np.float64 if self.dtype == "f64" else np.float32

    @property
    def complex_dtype(self):
        return np.complex128 if self.dtype == "f64" else np.complex64

    @property
    def torch_real(self) -> torch.dtype:
        return torch.float64 if self.dtype == "f64" else torch.float32

    @property
    def torch_complex(self) -> torch.dtype:
        return torch.complex128 if self.dtype == "f64" else torch.complex64

    def level_size(self, l: int) -> int:
        return 4**l

    def __post_init__(self):
        if self.weak_cap == 0:
            object.__setattr__(self, "weak_cap", 4 * self.strong_cap)
        if self.nlevels < 0:
            raise ValueError("nlevels must be >= 0")
        if self.p < 1:
            raise ValueError("p must be >= 1")
        if not (0.0 < self.theta < 1.0):
            raise ValueError("theta in (0,1)")
        if self.tile_boxes < 1 or self.stage_width < 1:
            raise ValueError("tile_boxes and stage_width must be >= 1")
        if self.tile_boxes * self.stage_width > 128:
            raise ValueError(
                "tile_boxes * stage_width > 128: each staged source row is "
                "one kernel operand; this tiling would not fit VMEM")
        if self.n < 4**self.nlevels:
            raise ValueError(
                f"n={self.n} < 4**nlevels={4**self.nlevels}: every leaf needs "
                "at least one particle (pick fewer levels)"
            )


def split_bounds(n: int, nsplits: int) -> list[np.ndarray]:
    """Static rank boundaries after each binary split.

    Returns a list of length ``nsplits+1``; entry ``s`` is an int64 array of
    ``2**s + 1`` rank boundaries. A segment ``[a, b)`` splits at
    ``a + ceil((b-a)/2)`` — the median split of the paper, but at exact,
    deterministic ranks (see DESIGN.md §7.2).
    """
    out = [np.array([0, n], dtype=np.int64)]
    cur = out[0]
    for _ in range(nsplits):
        mids = cur[:-1] + (cur[1:] - cur[:-1] + 1) // 2
        nxt = np.empty(2 * len(cur) - 1, dtype=np.int64)
        nxt[0::2] = cur
        nxt[1::2] = mids
        out.append(nxt)
        cur = nxt
    return out


def segment_ids(bounds: np.ndarray) -> np.ndarray:
    """(n,) int32 mapping a particle rank to its segment index."""
    sizes = np.diff(bounds)
    return np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)


def level_bounds(cfg: FmmConfig) -> list[np.ndarray]:
    """Rank boundaries of the 4**l boxes at every level l=0..nlevels."""
    sb = split_bounds(cfg.n, 2 * cfg.nlevels)
    return [sb[2 * l] for l in range(cfg.nlevels + 1)]


def leaf_sizes(cfg: FmmConfig) -> np.ndarray:
    lb = level_bounds(cfg)[-1]
    return np.diff(lb).astype(np.int32)


def max_leaf_size(cfg: FmmConfig) -> int:
    return int(leaf_sizes(cfg).max())
