#!/usr/bin/env python3
"""Write the tables of the f64 pair logarithm (``csrc/clog.cuh``).

    python3 scripts/clog_tables.py

Computes, with mpmath at 160 bits, the two tables that ``clog_pair``
reads and rewrites the block between the ``clog tables`` markers of the
header (``tests/test_torch_clog.py`` checks that the header holds the
block ``block()`` returns):

* ``log`` (CLOG_NLOG rows ``{1/c / 2, log(c) / 2}``): row j serves the
  reduced argument z in [c_lo, 2 c_lo) whose bit pattern lies in the
  j-th of CLOG_NLOG equal slices above CLOG_OFF_HI; 1/c is a double
  within 2^-22 of the reciprocal of the slice's mid-point, searched so
  that log(c) / 2 lies within 2^-12 ulp of a double (the stored value);
  the slice around z = 1 (row 75) has c = 1 exactly, so
  log|d| keeps its relative accuracy as |d| -> 1.
* ``atan`` (4 x 65 rows ``{hi, lo}``): hi + lo = Q + sign atan(k/64),
  k = 0..64, for the four reductions (Q, sign) = (0, +), (pi/2, -),
  (pi/2, +), (pi, -), hi the double nearest and lo the double nearest
  the remainder.
"""
from __future__ import annotations

import argparse
import random
import struct
import sys
from pathlib import Path

import mpmath

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "clog.cuh"
BEGIN, END = "// ---- clog tables", "// ---- end of clog tables"

NLOG = 128
OFF_HI = 0x3FE69000          # slice J is [1 - 2^-9, 1 + 2^-8)
J = 75
NATAN = 65
ULP_FRACTION = 2.0 ** -12    # largest error of a stored log(c) / 2, in ulp


def as_double(bits: int) -> float:
    return struct.unpack("<d", struct.pack("<Q", bits))[0]


def bits_of(x: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", x))[0]


def ulp(x: float) -> float:
    b = bits_of(abs(x))
    return as_double(b + 1) - as_double(b)


def log_row(j: int) -> tuple[float, float]:
    """(1/c / 2, log(c) / 2) of slice j."""
    if j == J:
        return 0.5, 0.0
    lo = (OFF_HI << 32) + (j << 45)
    za, zb = mpmath.mpf(as_double(lo)), mpmath.mpf(as_double(lo + (1 << 45)))
    invc = bits_of(float(2 / (za + zb)))
    rng = random.Random(j)
    for _ in range(1 << 20):
        # within 2^-22 of the mid-point's reciprocal (a short dyadic
        # fraction, so neighbouring doubles repeat the same few errors)
        cand = as_double(invc + rng.randint(-(1 << 30), 1 << 30))
        half = -mpmath.log(mpmath.mpf(cand)) / 2
        stored = float(half)
        if abs(half - stored) <= ULP_FRACTION * ulp(stored):
            return cand / 2, stored
    raise RuntimeError(f"no 1/c found for slice {j}")


def atan_rows() -> list[tuple[float, float]]:
    rows = []
    half_pi, pi = mpmath.pi / 2, mpmath.pi
    for q, sign in ((0, 1), (half_pi, -1), (half_pi, 1), (pi, -1)):
        for k in range(NATAN):
            v = q + sign * mpmath.atan(mpmath.mpf(k) / 64)
            hi = float(v)
            rows.append((hi, float(v - hi)))
    return rows


def fmt(x: float) -> str:
    return "0x0p+0" if x == 0 else x.hex()


def block() -> str:
    """The header's table block, computed at 160 bits."""
    with mpmath.workprec(160):
        return _block()


def _block() -> str:
    lines = [f"{BEGIN} (scripts/clog_tables.py writes this block) ----",
             "__device__ const double2 CLOG_TAB[CLOG_NLOG + CLOG_NATAN] = {",
             "    // log: {1/c / 2, log(c) / 2}, one row a slice j"]
    for j in range(NLOG):
        a, b = log_row(j)
        lines.append(f"    {{{fmt(a)}, {fmt(b)}}},")
    names = ("Q = 0, +", "Q = pi/2, -", "Q = pi/2, +", "Q = pi, -")
    for r, (hi, lo) in enumerate(atan_rows()):
        if r % NATAN == 0:
            lines.append(f"    // atan: Q + sign atan(k/64), {names[r // NATAN]}")
        lines.append(f"    {{{fmt(hi)}, {fmt(lo)}}},")
    lines += ["};", END]
    return "\n".join(lines)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    text = HEADER.read_text()
    head, rest = text.split(BEGIN, 1)
    tail = rest.split(END, 1)[1]
    HEADER.write_text(head + block() + tail)
    print(f"clog tables: wrote {HEADER}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
