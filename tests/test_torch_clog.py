"""PyTorch port, the f64 pair logarithm of the log kernel
(``kernels/csrc/clog.cuh``: ``clog_pair(dx, dy, d2) = (log|d|,
atan2(-dy, -dx))``), checked on the CPU: its tables and constants are
read from the header the kernel compiles, its reductions are evaluated
step for step in float64 (numpy for the integer and plain float steps,
the port's exact fused multiply-add ``fma_rn`` for each ``fma``, the
hardware reciprocal estimate as the reciprocal cut to its high word)
over 10^6 drawn pairs and the exact classes, and compared with numpy's
``log`` and ``arctan2``: within 2 ulp, and bit for bit (signed zeros,
infinities, the branch cut) on the exact classes. The table block is
checked against the one ``scripts/clog_tables.py`` derives with mpmath.
On the card (``tests/test_torch_gpu.py``): the compiled pair logarithm
pair by pair on the same draws, and the kernel against its plain twin."""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.topology.rounding import fma_rn

ROOT = Path(__file__).resolve().parents[1]
HEADER = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "clog.cuh"
SCRIPT = ROOT / "scripts" / "clog_tables.py"
HEX = r"-?0x[0-9a-f]+(?:\.[0-9a-f]*)?p[+-]?\d+"
SIGN = np.uint64(1 << 63)


def _header():
    """(constants by name, the table as a (rows, 2) float64 array)."""
    text = HEADER.read_text()
    consts = {}
    for kind, name, expr in re.findall(
            r"constexpr (int|double) (CLOG_\w+) = ([^;]+);", text):
        expr = re.sub(HEX, lambda m: repr(float.fromhex(m.group())), expr)
        consts[name] = (int if kind == "int" else float)(
            eval(expr, {}, dict(consts)))
    body = text.split("CLOG_TAB[CLOG_NLOG + CLOG_NATAN] = {", 1)[1]
    vals = [float.fromhex(v) for v in re.findall(HEX, body.split("};", 1)[0])]
    tab = np.array(vals, np.float64).reshape(-1, 2)
    assert len(tab) == consts["CLOG_NLOG"] + consts["CLOG_NATAN"]
    return consts, tab


C, TAB = _header()


def _fma(a, b, c):
    """RN(a * b + c) on float64 arrays (scalars broadcast). ``fma_rn``
    splits its factors, which overflows above 2^996: such a factor (the
    reciprocal estimate where d = 0) is scaled by 2^-128 first, exactly."""
    a, b, c = np.broadcast_arrays(*(np.asarray(x, np.float64)
                                    for x in (a, b, c)))
    sa, sb = (np.where(np.abs(x) > 2.0 ** 900, 2.0 ** -128, 1.0)
              for x in (a, b))
    return fma_rn(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        a * sa, b * sb, c * sa * sb))).numpy() / (sa * sb)


def _bits(x):
    return x.view(np.uint64)


def _dbl(b):
    return np.asarray(b, np.uint64).view(np.float64)


def _rcp(x):
    """A reciprocal estimate of the hardware's accuracy (~2^-20): 1/x
    with its low word cleared."""
    with np.errstate(divide="ignore"):
        return _dbl(_bits(1.0 / x) & np.uint64(0xFFFFFFFF00000000))


def clog_pair(dx, dy, d2):
    """``clog_pair`` of clog.cuh, step for step: (log|d|, arg(-d))."""
    off = C["CLOG_OFF_HI"]
    h0 = (_bits(d2) >> np.uint64(32)).astype(np.int64)
    sub = h0 < 0x00100000
    with np.errstate(invalid="ignore"):
        x = np.where(sub, _dbl(_bits(d2) | np.uint64(0x3FF0000000000000))
                     - 1.0, d2)
    hx = (_bits(x) >> np.uint64(32)).astype(np.int64)
    top = (hx - off) >> 20
    k = top - np.where(sub, 1022, 0)
    row = TAB[((hx - off) >> 13) & (C["CLOG_NLOG"] - 1)]
    z = _dbl(((hx - (top << 20)).astype(np.uint64) << np.uint64(32))
             | (_bits(x) & np.uint64(0xFFFFFFFF)))
    hs = _fma(z, row[:, 0], -0.5)
    kd = _dbl((np.uint64(0x43300000) << np.uint64(32))
              | (k + 2048).astype(np.uint64)) - C["CLOG_KBIAS"]
    w = _fma(kd, C["CLOG_LN2H"], row[:, 1])
    q = _fma(C["CLOG_Q5"], hs, C["CLOG_Q4"])
    for name in ("CLOG_Q3", "CLOG_Q2", "CLOG_Q1", "CLOG_Q0"):
        q = _fma(q, hs, C[name])
    re_ = w + (hs + _fma(hs * hs, q, kd * C["CLOG_LN2L"]))
    re_ = np.where((_bits(d2) & ~SIGN) == 0, -np.inf, re_)
    re_ = np.where(h0 >= 0x7FF00000, d2, re_)

    ax, ay = _bits(dx) & ~SIGN, _bits(dy) & ~SIGN
    hi = np.uint64(32)
    swap = (ay >> hi) > (ax >> hi)
    neg = (_bits(dx) & SIGN) == 0
    flipped = swap != neg
    octant = 2 * neg + flipped
    flip = np.where(flipped, SIGN, np.uint64(0))
    bmn, bmx = np.where(swap, ax, ay), np.where(swap, ay, ax)
    low = np.uint64(0xFFFFFFFF)
    mx = _dbl((np.maximum(bmx >> hi, np.uint64(0x00100000)) << hi)
              | (bmx & low))
    mn = _dbl(bmn)
    t = _fma(mn, _rcp(mx), C["CLOG_ROUND"])
    c = t - C["CLOG_ROUND"]
    num = _fma(-_dbl(_bits(c) ^ flip), mx, _dbl(bmn ^ flip))
    den = _fma(c, mn, mx)
    r0 = _rcp(den)
    e = _fma(-den, r0, 1.0)
    q0 = num * r0
    qd = _fma(q0, _fma(e, e, e), q0)
    u = _fma(_fma(-qd, den, num), r0, qd)
    u2 = u * u
    p = _fma(_fma(C["CLOG_A7"], u2, C["CLOG_A5"]), u2, C["CLOG_A3"])
    ang = TAB[C["CLOG_NLOG"] + 65 * octant
              + (_bits(t) & np.uint64(0xFFFFFFFF)).astype(np.int64)]
    th = ang[:, 0] + (u + _fma(u * u2, p, ang[:, 1]))
    im = _dbl(_bits(th) | (~_bits(dy) & SIGN))
    return re_, im


def _ulps(got, want):
    """|got - want| in ulp of want (0 where both are equal)."""
    err = np.abs(got - want)
    return np.where(got == want, 0.0, err / np.spacing(np.abs(want)))


def _draw(rng, n):
    """n pairs (dx, dy): every octant, |dy| << |dx| and the reverse, the
    diagonal (also where |dx| and |dy| share their high words), d2 from
    1e-300 to 1e300, |d| near 1, and near-field differences of points in
    the unit square."""
    ang = rng.uniform(-np.pi, np.pi, n)
    mag = 10.0 ** rng.uniform(-150, 150, n)
    dx, dy = mag * np.cos(ang), mag * np.sin(ang)
    m = n // 8
    ratio = 10.0 ** -rng.uniform(0, 20, m)            # |dy| << |dx|
    base = rng.choice([-1.0, 1.0], m) * 10.0 ** rng.uniform(-20, 20, m)
    dx[:m], dy[:m] = base, base * ratio * rng.choice([-1.0, 1.0], m)
    dx[m:2 * m], dy[m:2 * m] = dy[:m] * 1.5, dx[:m] * 0.75   # the reverse
    diag = rng.choice([-1.0, 1.0], (2, m)) * rng.uniform(0.5, 2, m)
    dx[2 * m:3 * m] = diag[0]
    tie = rng.choice([1e-3, 1e-9], m)      # 1e-9: high words tie
    dy[2 * m:3 * m] = diag[1] * np.abs(diag[0]) * (1 + tie * rng.normal(size=m))
    r = 1 + rng.choice([1e-3, 1e-8, 1e-13], m) * rng.uniform(-1, 1, m)
    dx[3 * m:4 * m], dy[3 * m:4 * m] = r * np.cos(ang[:m]), r * np.sin(ang[:m])
    a, b = rng.uniform(0, 1, (2, 2, m))
    dx[4 * m:5 * m], dy[4 * m:5 * m] = a[0] - b[0], a[1] - b[1]
    return dx, dy


def test_log_and_arg_within_two_ulp_of_numpy():
    rng = np.random.default_rng(20261018)
    dx, dy = _draw(rng, 1 << 20)
    d2 = dx * dx + dy * dy
    assert d2.min() < 1e-290 and d2.max() > 1e290
    re_, im = clog_pair(dx, dy, d2)
    ulp_re = _ulps(re_, 0.5 * np.log(d2))
    ulp_im = _ulps(im, np.arctan2(-dy, -dx))
    assert ulp_re.max() <= 2, (ulp_re.max(), dx[ulp_re.argmax()],
                               dy[ulp_re.argmax()])
    assert ulp_im.max() <= 2, (ulp_im.max(), dx[ulp_im.argmax()],
                               dy[ulp_im.argmax()])
    # nearly all results are the correctly rounded ones' neighbours
    assert (ulp_re <= 1).mean() > 0.999 and (ulp_im <= 1).mean() > 0.999


def test_subnormal_and_tiny_distances():
    """d2 below 2^-1022 takes the scaled path; max(|dx|, |dy|) stays in
    the documented range."""
    rng = np.random.default_rng(7)
    mag = 10.0 ** rng.uniform(-160, -150, 4096)
    ang = rng.uniform(-np.pi, np.pi, 4096)
    dx, dy = mag * np.cos(ang), mag * np.sin(ang)
    d2 = dx * dx + dy * dy
    assert (d2 < np.finfo(np.float64).tiny).mean() > 0.4 and (d2 > 0).all()
    re_, im = clog_pair(dx, dy, d2)
    assert _ulps(re_, 0.5 * np.log(d2)).max() <= 2
    assert _ulps(im, np.arctan2(-dy, -dx)).max() <= 2


@pytest.mark.parametrize("case", ["dx_zero", "dy_zero", "branch_cut",
                                  "coincident", "axes"])
def test_exact_classes_are_bitwise_numpy(case):
    """Signed zeros and the branch cut: arg(-d) equal to numpy's bit for
    bit; d = 0 gives log|d| = -inf (a non-finite phi)."""
    z = np.array([0.0, -0.0])
    v = np.array([0.5, 1.0, 3.0, 1e-30, 1e30, 0.7071067811865476])
    if case == "dx_zero":            # -d on the imaginary axis: +-pi/2
        dx, dy = np.repeat(z, 12), np.tile(np.concatenate([v, -v]), 2)
    elif case == "dy_zero":          # dx < 0: -d on the positive real axis
        dx, dy = np.repeat(-v, 2), np.tile(z, len(v))
    elif case == "branch_cut":       # dx > 0 and dy = +-0: arg(-d) = +-pi
        dx, dy = np.repeat(v, 2), np.tile(z, len(v))
    elif case == "coincident":       # d = 0 in every sign combination
        dx, dy = np.repeat(z, 2), np.tile(z, 2)
    else:                            # |dx| = |dy| and both axes
        dx = np.array([1.0, -1.0, 1.0, -1.0, 2.0, -2.0])
        dy = np.array([1.0, 1.0, -1.0, -1.0, 0.0, -0.0])
    d2 = dx * dx + dy * dy
    re_, im = clog_pair(dx, dy, d2)
    want = np.arctan2(-dy, -dx)
    assert np.array_equal(_bits(im), _bits(want)), (im, want)
    with np.errstate(divide="ignore"):
        wre = 0.5 * np.log(d2)
    if case == "coincident":
        assert np.array_equal(re_, wre) and np.isneginf(re_).all()
    else:
        assert _ulps(re_, wre).max() <= 1


def test_non_finite_d2_propagates():
    d2 = np.array([np.inf, np.nan, 0.0])
    dx = np.array([1.0, 1.0, 0.0])
    re_, _ = clog_pair(dx, dx, d2)
    assert np.isposinf(re_[0]) and np.isnan(re_[1]) and np.isneginf(re_[2])


def test_tables_against_mpmath():
    """The header's table block is the one ``scripts/clog_tables.py``
    derives with mpmath at 160 bits (its docstring states what each row
    holds and the bounds it meets)."""
    spec = importlib.util.spec_from_file_location("clog_tables", SCRIPT)
    tables = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tables)
    assert tables.block() in HEADER.read_text()
