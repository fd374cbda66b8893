"""Exactly rounded elementwise helpers for the topology's bit parity.

The interaction lists depend on comparisons of the theta-criterion
(``R + theta r <= theta d``) and on box radii from ``hypot``. To match the
reference's lists bit for bit, the port has to round these exactly where
the reference does. The reference (``jnp.hypot`` under XLA's CPU
compiler) computes

    hypot(a, b) = max * sqrt(fma(r, r, 1)),   r = min / max

and contracts the theta test's ``big + theta * small`` into one fused
multiply-add as well (both contractions read off the compiled x86 code:
``vfmadd`` for exactly these two sums and for nothing else on the path).
Two more obstacles on the torch side:

* torch has no fused multiply-add. ``fma_rn`` emulates it exactly: for
  f32, the product is exact in f64 and the f64 sum is rounded to odd
  before the final rounding to f32 (round-to-odd with two or more spare
  bits makes the double rounding innocuous); for f64, the algorithm of
  Boldo & Melquiond ("Emulation of FMA and correctly rounded sums: proved
  algorithms using rounding to odd", IEEE TC 2008): an exact product
  (Dekker/Veltkamp), an exact sum (Knuth's TwoSum), one round-to-odd
  addition of the two error terms and a final round-to-nearest.
* torch's CPU ``sqrt`` is not correctly rounded (about 0.7% of f32 and
  f64 results are one ulp off). ``sqrt_rn`` corrects it exactly with a
  midpoint test whose sign comes from an exact expansion sum (Shewchuk's
  Grow-Expansion), valid on [1, 4) — the range of ``fma(r, r, 1)``.

Every helper is a sequence of single torch elementwise ops (no op fuses a
product into a sum), so it runs unchanged on CPU and CUDA tensors. The
CUDA classify kernel writes the same roundings directly with ``fma()``,
``__fsqrt_rn``/``__dsqrt_rn`` and the ``_rn`` arithmetic intrinsics.
Valid away from overflow and underflow, which the geometry of a box tree
in double or single precision never reaches.
"""
from __future__ import annotations

import torch

_SPLITTER = 134217729.0          # 2**27 + 1 (Veltkamp split of a double)


def two_sum(a: torch.Tensor, b: torch.Tensor):
    """(s, t) with s = RN(a + b) and s + t == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    t = (a - (s - bb)) + (b - bb)
    return s, t


def two_prod(a: torch.Tensor, b: torch.Tensor):
    """(p, e) with p = RN(a * b) and p + e == a * b exactly (f64 only;
    Dekker's product on Veltkamp halves)."""
    def split(x):
        c = _SPLITTER * x
        hi = c - (c - x)
        return hi, x - hi

    ah, al = split(a)
    bh, bl = split(b)
    p = a * b
    e = (((ah * bh - p) + ah * bl) + al * bh) + al * bl
    return p, e


def _round_to_odd_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b rounded to odd: the exact sum if representable, else the
    neighbouring float of the two around it whose last bit is 1."""
    s, t = two_sum(a, b)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(t > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where((t != 0) & even, torch.nextafter(s, toward), s)


def fma_rn(a, b, c) -> torch.Tensor:
    """RN(a * b + c) with a single rounding, in the dtype of the tensor
    arguments (float32 or float64); Python floats broadcast."""
    dt = next(x.dtype for x in (a, b, c) if isinstance(x, torch.Tensor))
    dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))

    def as64(x):
        # a Python float is filled on the device (no host copy)
        t = (x.to(dt) if isinstance(x, torch.Tensor)
             else torch.full((), x, dtype=dt, device=dev))
        return t.to(torch.float64)

    a64, b64, c64 = as64(a), as64(b), as64(c)
    if dt == torch.float32:
        # 24 + 24 bit product is exact in f64; round the sum to odd in
        # f64, then to nearest in f32 — correctly rounded.
        return _round_to_odd_add(a64 * b64, c64).to(torch.float32)
    if dt != torch.float64:
        raise TypeError(f"fma_rn wants float32/float64, got {dt}")
    uh, ul = two_prod(a64, b64)
    th, tl = two_sum(c64, uh)
    return th + _round_to_odd_add(tl, ul)


def _expansion_sign(terms) -> torch.Tensor:
    """Sign of the exact sum of the float64 ``terms`` (Shewchuk's
    Grow-Expansion: the most significant nonzero component decides)."""
    comps = [terms[0]]
    for b in terms[1:]:
        q, new = b, []
        for e in comps:
            q, h = two_sum(q, e)
            new.append(h)
        new.append(q)
        comps = new
    sign = torch.zeros_like(comps[0])
    for comp in comps:                   # ascending significance
        sign = torch.where(comp != 0, torch.sign(comp), sign)
    return sign


def _sqrt_rn64(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt of float64 ``x`` in [1, 4)."""
    c = torch.sqrt(x)
    inf = torch.full_like(x, float("inf"))
    for _ in range(2):                   # each pass moves at most one ulp
        nxt = torch.nextafter(c, inf)
        prv = torch.nextafter(c, -inf)
        h_up = (nxt - c) * 0.5           # half-ulp gaps: powers of two
        h_dn = (c - prv) * 0.5
        p, e = two_prod(c, c)
        d = x - p                        # exact (Sterbenz: p ~ x)
        # sign(x - (c + h)^2) and sign(x - (c - h)^2), exactly
        up = _expansion_sign([d, -e, -2.0 * c * h_up, -(h_up * h_up)])
        dn = _expansion_sign([d, -e, 2.0 * c * h_dn, -(h_dn * h_dn)])
        c = torch.where(up > 0, nxt, torch.where(dn < 0, prv, c))
    return c


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded sqrt for ``x`` in [1, 4) (float32 or float64)."""
    if x.dtype == torch.float32:
        # sqrt of a 24-bit float never lies within 2^-50 (relative) of an
        # f32 midpoint, so the correctly rounded f64 root rounds right
        return _sqrt_rn64(x.to(torch.float64)).to(torch.float32)
    return _sqrt_rn64(x)


def hypot_xla(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.hypot`` as XLA's CPU build computes it, bit for bit:
    max * sqrt(fma(r, r, 1)) with r = min / max (inf if either leg is
    +-inf, 0 if both are 0)."""
    a, b = a.abs(), b.abs()
    inf = torch.isposinf(a) | torch.isposinf(b)
    x1, x2 = torch.maximum(a, b), torch.minimum(a, b)
    zero = x1 == 0
    r = x2 / torch.where(zero, torch.ones_like(x1), x1)
    # fma(r, r, 1) is in [1, 2] here (NaN legs pass through)
    x = torch.where(zero, x1, x1 * sqrt_rn(fma_rn(r, r, 1.0)))
    return torch.where(inf, torch.full_like(x, float("inf")), x)
