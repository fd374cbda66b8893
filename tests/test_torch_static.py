"""PyTorch port, static layer: config and static layout, configs, data,
direct oracle, expansions, the exact-rounding helpers, the error
taxonomy, device selection, and the port's import boundary."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs.fmm2d as jax_fmm2d
import repro.core.config as jax_config
from repro.core import direct_potential as jax_direct
from repro.core import expansions as JE
from repro.core.topology import leaf_ids as jax_leaf_ids
from repro.core.topology import leaf_particle_index as jax_leaf_index
from repro_torch import errors
from repro_torch.configs import SMOKE, fmm_config
from repro_torch.core import config as C
from repro_torch.core import expansions as E
from repro_torch.core.direct import direct_potential, rel_error_inf
from repro_torch.core.fmm import plan_from_numpy
from repro_torch.core.topology import leaf_ids, leaf_particle_index
from repro_torch.core.topology.rounding import fma_rn, hypot_xla, sqrt_rn
from repro_torch.data import particles, particles_numpy
from repro_torch.solver import FmmSolver

from _torch_parity import rel

ROOT = Path(__file__).resolve().parents[1]

CFG_CASES = [dict(n=1 << 20, nlevels=7), dict(n=4096, nlevels=3, p=8),
             dict(n=1000, nlevels=2, p=5, dtype="f64"),
             dict(n=50, nlevels=0, strong_cap=8),
             dict(n=777, nlevels=3, weak_cap=40, kernel="log")]


@pytest.mark.parametrize("kw", CFG_CASES)
def test_static_layout_matches_reference(kw):
    jc, tc = jax_config.FmmConfig(**kw), C.FmmConfig(**kw)
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.nboxes == jc.nboxes
    assert tc.real_dtype == jc.real_dtype
    assert tc.complex_dtype == jc.complex_dtype
    for a, b in zip(C.level_bounds(tc), jax_config.level_bounds(jc)):
        np.testing.assert_array_equal(a, b)
    for s in range(2 * tc.nlevels + 1):
        a = C.split_bounds(tc.n, s)
        b = jax_config.split_bounds(jc.n, s)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        np.testing.assert_array_equal(C.segment_ids(a[-1]),
                                      jax_config.segment_ids(b[-1]))
    np.testing.assert_array_equal(C.leaf_sizes(tc), jax_config.leaf_sizes(jc))
    assert C.max_leaf_size(tc) == jax_config.max_leaf_size(jc)
    if tc.n <= 4096:
        np.testing.assert_array_equal(leaf_particle_index(tc),
                                      jax_leaf_index(jc))
        np.testing.assert_array_equal(leaf_ids(tc), jax_leaf_ids(jc))


@pytest.mark.parametrize("n,n_d", [(10, 45), (45, 45), (1 << 20, 45),
                                   (5000, 35), (1 << 24, 45)])
def test_num_levels_for_matches_reference(n, n_d):
    assert C.num_levels_for(n, n_d) == jax_config.num_levels_for(n, n_d)


@pytest.mark.parametrize("bad", [dict(nlevels=-1), dict(p=0),
                                 dict(theta=1.0), dict(tile_boxes=0),
                                 dict(tile_boxes=16, stage_width=16),
                                 dict(n=15, nlevels=2)])
def test_config_validation_matches_reference(bad):
    kw = dict(n=1024, nlevels=2) | bad
    with pytest.raises(ValueError):
        jax_config.FmmConfig(**kw)
    with pytest.raises(ValueError):
        C.FmmConfig(**kw)


def test_fmm2d_configs_match_reference():
    for n in (1 << 20, 4096, 100):
        for dt in ("f32", "f64"):
            a = fmm_config(n, dtype=dt)
            b = jax_fmm2d.fmm_config(n, dtype=dt)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert dataclasses.asdict(SMOKE) == dataclasses.asdict(jax_fmm2d.SMOKE)
    full = fmm_config(1 << 20)
    assert (full.nlevels, full.p, full.strong_cap, full.weak_cap) == (
        7, 17, 48, 128)
    assert C.max_leaf_size(full) == 64 and full.nboxes == 16384


@pytest.mark.parametrize("dist", ["uniform", "normal", "layer"])
def test_particles_match_reference(dist):
    from repro.data.synthetic import particles as jp
    z, q = particles_numpy(dist, 3000, seed=7)
    jz, jq = jp(dist, 3000, seed=7)
    np.testing.assert_array_equal(z, np.asarray(jz))
    np.testing.assert_array_equal(q, np.asarray(jq))
    tz, tq = particles(dist, 3000, seed=7, device="cpu")
    assert tz.dtype == torch.complex128 and tz.device.type == "cpu"
    np.testing.assert_array_equal(tz.numpy(), z)
    assert ((z.real >= 0) & (z.real <= 1) & (z.imag >= 0)
            & (z.imag <= 1)).all()


@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_direct_potential_matches_reference(kernel):
    z, q = particles_numpy("normal", 1500, seed=3)
    z[5] = z[9]                                   # a coincident pair
    ref = np.asarray(jax_direct(jnp.asarray(z), jnp.asarray(z),
                                jnp.asarray(q), kernel=kernel))
    tz, tq = torch.from_numpy(z), torch.from_numpy(q)
    got = direct_potential(tz, tz, tq, kernel=kernel, chunk=256)
    assert rel(got, ref) <= 1e-12
    assert rel(direct_potential(tz, tz, tq, kernel=kernel), ref) <= 1e-12
    assert rel_error_inf(got, ref) <= 1e-12


def test_expansions_match_reference():
    rng = np.random.default_rng(0)
    p = 17
    np.testing.assert_array_equal(E.m2l_matrix(p), JE.m2l_matrix(p))
    shape = (6, 5)
    a = rng.normal(size=shape + (p + 1,)) + 1j * rng.normal(size=shape + (p + 1,))
    u = 0.3 * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
    ratio = rng.uniform(0.3, 0.9, shape) + 0j
    r = 2 + rng.normal(size=shape) + 1j * rng.normal(size=shape)
    rs, rt = rng.uniform(0.2, 0.5, shape), rng.uniform(0.2, 0.5, shape)
    T = torch.from_numpy
    mat = E.m2l_matrix(p)
    cases = [
        (E.m2m_norm(T(a), T(u), T(ratio)), JE.m2m_norm(a, u, ratio)),
        (E.l2l_norm(T(a), T(u), T(ratio)), JE.l2l_norm(a, u, ratio)),
        (E.m2l_norm(T(a), T(r), T(rs), T(rt), T(mat)),
         JE.m2l_norm(a, r, rs, rt, jnp.asarray(mat))),
        (E.m2l_norm_horner(T(a), T(r), T(rs), T(rt)),
         JE.m2l_norm_horner(a, r, rs, rt)),
        (E.pows(T(u), p), JE.pows(u, p)),
    ]
    for got, ref in cases:
        assert rel(got, np.asarray(ref)) <= 1e-13


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_rounding_helpers_match_xla(dt):
    """hypot/fma as XLA's CPU build computes them, bit for bit; sqrt
    correctly rounded."""
    rng = np.random.default_rng(1)
    n = 200_000
    a = (rng.uniform(-1, 1, n) * rng.choice([1e-3, 1.0, 1e3], n)).astype(dt)
    b = rng.uniform(-1, 1, n).astype(dt)
    a[:4] = [0, np.inf, 0, -np.inf]
    b[:4] = [0, 1, -2, 3]
    ref = np.asarray(jax.jit(jnp.hypot)(a, b))
    got = hypot_xla(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    th = dt(0.3)
    big = rng.uniform(0, 1, n).astype(dt)
    small = rng.uniform(0, 1, n).astype(dt)
    fused = np.asarray(jax.jit(lambda x, y: x + th * y)(big, small))
    got = fma_rn(torch.tensor(th), torch.from_numpy(small),
                 torch.from_numpy(big)).numpy()
    np.testing.assert_array_equal(got, fused)
    x = rng.uniform(1, 4, n).astype(dt)
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))


def test_fma_rn_is_exactly_rounded_f64():
    from fractions import Fraction as F
    rng = np.random.default_rng(2)
    a, b = rng.uniform(-1, 1, 500), rng.uniform(-1, 1, 500)
    c = rng.uniform(-1, 1, 500) * 1e-3
    got = fma_rn(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(c)).numpy()
    exact = [float(F(x) * F(y) + F(w)) for x, y, w in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.array(exact))


def test_error_taxonomy_builtins():
    assert issubclass(errors.ShapeError, ValueError)
    assert issubclass(errors.DTypeError, TypeError)
    assert issubclass(errors.CapOverflowError, RuntimeError)
    assert issubclass(errors.DeviceUnavailableError, RuntimeError)
    e = errors.CapOverflowError("x", margins={"weak": -3}, overflow=3)
    assert e.margins == {"weak": -3} and e.overflow == 3


def test_build_without_cuda_raises(monkeypatch):
    """No silent fall-back: the default device is the CUDA card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = C.FmmConfig(n=256, nlevels=1)
    with pytest.raises(errors.DeviceUnavailableError):
        FmmSolver.build(cfg)
    with pytest.raises(errors.DeviceUnavailableError):
        FmmSolver.build(cfg, backend="cuda")
    assert FmmSolver.build(cfg, device="cpu").dispatched["apply"] == \
        "reference"
    assert FmmSolver.build(cfg, backend="cuda", device="cpu").backend.name \
        == "cuda"
    with pytest.raises(errors.DeviceUnavailableError):
        particles("uniform", 16, 0)
    with pytest.raises(errors.DeviceUnavailableError):
        plan_from_numpy({}, {}, cfg)
    z, q = particles("uniform", 16, 0, device="cpu")
    assert z.device.type == "cpu" and q.device.type == "cpu"


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert len(examples) == 3
    files += examples + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
