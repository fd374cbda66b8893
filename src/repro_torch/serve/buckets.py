"""Shape bucketing: ragged N onto a small lattice of padded shape classes.

The twin of ``repro.serve.buckets`` (numpy only: the port keeps its own
copy, and pads bit for bit as the reference does). Every solver is
specialized on ``FmmConfig.n`` (the static-shape property the paper's
padded interaction lists buy us: device constants such as the leaf
layout are built per N), so heterogeneous traffic would naively prepare
one solver per distinct request size. The serving plane instead rounds
each request up to the nearest size in a small geometric ``BucketLattice``
and pads the tail with **zero-charge particles**, which is *mathematically
exact* for the real rows:

  - every expansion coefficient is a q-weighted sum, so a q=0 particle
    contributes exactly nothing to P2M/P2L/M2L/L2P;
  - the near-field P2P term of a q=0 source is 0/r = 0 for any target it
    doesn't coincide with — and padding positions are drawn *rejected
    against exact coincidence* with the real points (and each other), so
    the 0/0 singular case cannot occur (coincidence with a q=0 source
    would make the harmonic P2P term NaN);
  - padded rows receive garbage potentials, which ``unpad`` slices away.

What padding *does* change is the tree: the rank-median splits see the
extra particles, so box geometry shifts and the result differs from the
unpadded evaluation by the p-term truncation error only — the
bucket-boundary parity tests pin this at <= 1e-10 (f64, p=30), and the
tail-masking property (zero charges in, zeros out) holds at any p.

Padding positions are drawn inside the bounding box of the real points
(deterministic in (seed, size, n)), so the root box and the particle
density the caps were tuned for barely move; a degenerate bounding box
(all-coincident or collinear input) is widened by a relative epsilon so
rejection sampling terminates.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..errors import ShapeError


@dataclasses.dataclass(frozen=True)
class BucketLattice:
    """Ascending tuple of padded problem sizes (shape classes).

    ``bucket_for(n)`` rounds a request up to its shape class;
    ``None`` means the request is oversized for the lattice and must
    take the degradation ladder (direct O(N^2) for small N, typed
    rejection otherwise — see ``repro_torch.serve.plane``).
    """

    sizes: tuple[int, ...]

    def __post_init__(self):
        if not self.sizes:
            raise ValueError("BucketLattice needs at least one size")
        if list(self.sizes) != sorted(set(self.sizes)):
            raise ValueError(f"sizes must be strictly ascending: {self.sizes}")
        if self.sizes[0] < 4:
            raise ValueError("smallest bucket must be >= 4")

    @classmethod
    def geometric(cls, n_min: int = 64, n_max: int = 1 << 16,
                  factor: float = 2.0) -> "BucketLattice":
        """Geometric lattice from ``n_min`` up to (at least) ``n_max``.

        A factor-F lattice wastes at most (F-1)x padding per request and
        needs only log_F(n_max/n_min) shape classes — the standard
        padding/shape-class-count trade (factor 2 by default).
        """
        if factor <= 1.0:
            raise ValueError("factor must be > 1")
        sizes = [n_min]
        while sizes[-1] < n_max:
            sizes.append(max(sizes[-1] + 1,
                             int(math.ceil(sizes[-1] * factor))))
        return cls(sizes=tuple(sizes))

    @property
    def max_size(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n: int) -> int | None:
        """Smallest lattice size >= n; None when n overflows the lattice."""
        if n <= 0:
            raise ValueError(f"request size must be positive; got {n}")
        for s in self.sizes:
            if n <= s:
                return s
        return None

    def next_larger(self, size: int) -> int | None:
        """The lattice neighbor above ``size`` (the overload-shedding
        "next-larger bucket" rung), or None at the top."""
        for s in self.sizes:
            if s > size:
                return s
        return None


def pad_problem(z, q, size: int, *, seed: int = 0, dtype=None):
    """Pad (z, q) to ``size`` rows with zero-charge tail particles.

    Returns numpy ``(z_pad, q_pad)`` of length ``size``; the first
    ``len(z)`` rows are the caller's, bit-identical. Tail positions are
    uniform in the bounding box of the real points, deterministic in
    ``(seed, size, n)``, and **rejected against exact coincidence** with
    any real point or each other (module docstring: a coincident q=0
    source would 0/0 the harmonic P2P term). Tail charges are exactly 0.

    ``dtype`` is the complex dtype the solver will *compute* in
    (``FmmConfig.complex_dtype``, the numpy dtype, not the torch one):
    the coincidence rejection compares positions after casting to it, so
    a tail point distinct in f64 but colliding after an f32-config
    narrows cannot slip through.
    """
    z = np.asarray(z)
    q = np.asarray(q)
    cmp_dtype = np.dtype(dtype) if dtype is not None else z.dtype
    if z.ndim != 1 or z.shape != q.shape:
        raise ShapeError(
            f"pad_problem wants matching 1-D z/q; got z{z.shape} q{q.shape}")
    n = z.size
    if n > size:
        raise ShapeError(f"cannot pad n={n} down into a size-{size} bucket")
    if n == size:
        return z, q
    extra = size - n
    rng = np.random.default_rng(np.random.PCG64((seed, size, n)))
    xmn, xmx = float(z.real.min()), float(z.real.max())
    ymn, ymx = float(z.imag.min()), float(z.imag.max())
    # degenerate spans (all-coincident / axis-collinear input) widen to
    # a relative-epsilon box so rejection sampling terminates
    wx = xmx - xmn
    wy = ymx - ymn
    floor = 1e-6 * max(abs(xmn), abs(xmx), abs(ymn), abs(ymx), 1.0)
    wx = wx if wx > 0 else floor
    wy = wy if wy > 0 else floor
    tail = np.empty(0, dtype=np.complex128)
    z_cmp = z.astype(cmp_dtype)
    while tail.size < extra:
        m = extra - tail.size + 8
        cand = ((xmn + rng.uniform(0.0, 1.0, m) * wx)
                + 1j * (ymn + rng.uniform(0.0, 1.0, m) * wy))
        c_cmp = cand.astype(cmp_dtype)
        keep = (~np.isin(c_cmp, z_cmp)
                & ~np.isin(c_cmp, tail.astype(cmp_dtype)))
        # drop intra-candidate duplicates after the narrowing cast too
        _, first = np.unique(c_cmp, return_index=True)
        uniq = np.zeros(cand.size, dtype=bool)
        uniq[first] = True
        tail = np.concatenate([tail, cand[keep & uniq]])
    qdt = q.dtype if np.issubdtype(q.dtype, np.complexfloating) \
        else np.complex128
    z_pad = np.concatenate([z, tail[:extra].astype(z.dtype)])
    q_pad = np.concatenate([q.astype(qdt), np.zeros(extra, dtype=qdt)])
    return z_pad, q_pad


def unpad(phi, n: int):
    """Slice the real rows back out of a padded result."""
    return np.asarray(phi)[..., :n]
