"""PyTorch port, the helpers beside the pipeline, each against its twin
in the JAX package on the same seeded numpy inputs: the unscaled and
constant-matrix expansion forms, ``fmm_potential_with_stats`` and
``fmm_potential_checked``, the tree oracles ``build_tree_lexsort`` and
``leaf_particle_index_loop``, ``direct_potential_numpy`` and
``ragged_requests``; and ``apply_with_health`` on the degenerate
layouts of ``tests/test_degenerate.py``. Tolerances: constant matrices,
trees, index maps, numpy oracles, requests and health dicts exact;
expansion forms within 1e-12 and FMM phi within 1e-10 relative (f64:
the two packages sum in other orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import expansions as JE
from repro.core import fmm as JF
from repro.core.direct import direct_potential_numpy as jax_direct_numpy
from repro.core.topology import build_tree_lexsort as jax_lexsort
from repro.core.topology import leaf_particle_index_loop as jax_index_loop
from repro.data.synthetic import ragged_requests as jax_ragged
from repro.solver import FmmSolver as JaxSolver
from repro.solver import host_health as jax_host_health
from repro_torch.core import expansions as E
from repro_torch.core.direct import direct_potential, direct_potential_numpy
from repro_torch.core.fmm import fmm_potential_checked, fmm_potential_with_stats
from repro_torch.core.topology import (build_tree, build_tree_lexsort,
                                       leaf_particle_index,
                                       leaf_particle_index_loop)
from repro_torch.data import ragged_requests
from repro_torch.errors import CapOverflowError
from repro_torch.solver import FmmSolver, host_health

from _torch_parity import configs, inputs, rel

EXP_TOL = 1e-12
TOL = 1e-10


def _cx(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def _close(got, ref, tol=EXP_TOL):
    assert rel(got, np.asarray(ref)) <= tol


# ---------------------------------------------------------------------------
# expansions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [3, 9, 17])
def test_constant_matrices_are_the_references(p):
    for name in ("m2m_matrix", "m2l_matrix", "l2l_matrix"):
        assert np.array_equal(getattr(E, name)(p), getattr(JE, name)(p))


@pytest.mark.parametrize("kernel", ["harmonic", "log"])
@pytest.mark.parametrize("p", [3, 9, 17])
def test_translation_forms_match_the_references(kernel, p):
    rng = np.random.default_rng(p)
    a = _cx(rng, 6, p + 1)
    if kernel == "harmonic":
        a[:, 0] = 0
    t = _cx(rng, 6)
    r = t + 4.0                                   # well separated
    ta, tt, tr = (torch.from_numpy(x) for x in (a, t, r))
    ja, jt, jr = (jnp.asarray(x) for x in (a, t, r))
    _close(E.inv_pows(tt, p), JE.inv_pows(jt, p))
    for name, shift, jshift in (("m2m", tt, jt), ("l2l", tt, jt),
                                ("m2l", tr, jr)):
        mat = getattr(E, f"{name}_matrix")(p)
        _close(getattr(E, f"{name}_apply")(ta, shift, mat),
               getattr(JE, f"{name}_apply")(ja, jshift, jnp.asarray(mat)))
        _close(getattr(E, f"{name}_horner")(ta, shift),
               getattr(JE, f"{name}_horner")(ja, jshift))


@pytest.mark.parametrize("kernel", ["harmonic", "log"])
@pytest.mark.parametrize("p", [4, 12])
def test_single_box_expansions_match_the_references(kernel, p):
    rng = np.random.default_rng(10 + p)
    z0, zt0 = 0.2 + 0.1j, 2.0 - 1.0j
    xs = z0 + 0.1 * (rng.uniform(-1, 1, 50) + 1j * rng.uniform(-1, 1, 50))
    qs = _cx(rng, 50)
    zt = zt0 + 0.1 * (rng.uniform(-1, 1, 20) + 1j * rng.uniform(-1, 1, 20))
    tx, tq, tz = (torch.from_numpy(v) for v in (xs, qs, zt))
    jx, jq, jz = (jnp.asarray(v) for v in (xs, qs, zt))
    a = E.p2m_single(tx, tq, z0, p, kernel)
    ja = JE.p2m_single(jx, jq, jnp.asarray(z0), p, kernel)
    _close(a, ja)
    _close(E.eval_multipole(a, z0, tz), JE.eval_multipole(ja, z0, jz))
    b = E.p2l_single(tx, tq, zt0, p, kernel)
    jb = JE.p2l_single(jx, jq, jnp.asarray(zt0), p, kernel)
    _close(b, jb)
    _close(E.eval_local(b, z0, tx), JE.eval_local(jb, z0, jx))
    # normalized P2M over 5 boxes of 10 particles
    w = (xs - z0) / 0.15
    inv_rho = 1 / 0.15
    got = E.p2m_norm(torch.from_numpy(w), tq, inv_rho, p, kernel,
                     lambda v: v.reshape(5, 10).sum(-1))
    want = JE.p2m_norm(jnp.asarray(w), jq, inv_rho, p, kernel,
                       lambda v: v.reshape(5, 10).sum(-1))
    assert got.shape == (5, p + 1)
    _close(got, want)


# ---------------------------------------------------------------------------
# fmm_potential_with_stats / fmm_potential_checked
# ---------------------------------------------------------------------------

# One config and input for both: the checked run grows strong_cap 2 -> 4
# once, and the stats run then reuses the reference's eager ops at 4 (the
# reference runs both eagerly: its first call compiles op by op).
CHECKED = dict(n=256, nlevels=1, p=6, dtype="f64", weak_cap=0)


def test_fmm_potential_checked_grows_the_caps_as_the_reference():
    jcfg, tcfg = configs(strong_cap=2, **CHECKED)
    z, q = inputs("normal", 256, 4)
    phi, grown = fmm_potential_checked(torch.from_numpy(z),
                                       torch.from_numpy(q), tcfg)
    jphi, jgrown = JF.fmm_potential_checked(jnp.asarray(z), jnp.asarray(q),
                                            jcfg)
    assert (grown.strong_cap, grown.weak_cap) == (4, 16)
    assert (grown.strong_cap, grown.weak_cap) == (jgrown.strong_cap,
                                                  jgrown.weak_cap)
    assert phi.shape == (256,) and rel(phi, np.asarray(jphi)) <= TOL
    same, kept = fmm_potential_checked(torch.from_numpy(z),
                                       torch.from_numpy(q), grown)
    assert kept is grown and torch.equal(same, phi)
    with pytest.raises(CapOverflowError, match="strong_cap=4"):
        fmm_potential_checked(torch.from_numpy(z), torch.from_numpy(q),
                              tcfg, max_grow=0)


def test_fmm_potential_with_stats_matches_the_reference():
    jcfg, tcfg = configs(strong_cap=4, **CHECKED)
    z, q = inputs("normal", 256, 4)
    phi, stats = fmm_potential_with_stats(torch.from_numpy(z),
                                          torch.from_numpy(q), tcfg)
    jphi, jstats = JF.fmm_potential_with_stats(jnp.asarray(z), jnp.asarray(q),
                                               jcfg)
    assert phi.shape == (256,) and rel(phi, np.asarray(jphi)) <= TOL
    assert stats == jstats and stats["overflow"] == 0
    zb = torch.from_numpy(np.stack([z, z]))
    phib, _ = fmm_potential_with_stats(zb, torch.from_numpy(
        np.stack([q, q])), tcfg)
    assert phib.shape == (2, 256) and torch.equal(phib[1], phi)


# ---------------------------------------------------------------------------
# tree oracles
# ---------------------------------------------------------------------------

def _tree_fields(t, row=None):
    pick = (lambda a: np.asarray(a)) if row is None else (
        lambda a: a[row].numpy())
    return ([pick(t.perm).astype(np.int64), pick(t.z), pick(t.q)]
            + [pick(c) for c in t.centers] + [pick(r) for r in t.radii])


@pytest.mark.parametrize("n,levels,dist", [(64, 1, "uniform"),
                                           (257, 2, "normal"),
                                           (1024, 3, "layer"),
                                           (50, 0, "normal")])
def test_build_tree_lexsort_is_bit_identical(n, levels, dist):
    """The port's lexsort oracle equals its single-sort build and the
    reference's lexsort oracle bit for bit, row by row of a batch."""
    jcfg, tcfg = configs(n=n, nlevels=levels, p=5, dtype="f64")
    probs = [inputs(dist, n, seed=n + s) for s in (0, 1)]
    zb = torch.from_numpy(np.stack([z for z, _ in probs]))
    qb = torch.from_numpy(np.stack([q for _, q in probs]))
    old = build_tree_lexsort(zb, qb, tcfg)
    new = build_tree(zb, qb, tcfg)
    for b, (z, q) in enumerate(probs):
        ref = _tree_fields(jax_lexsort(jnp.asarray(z), jnp.asarray(q), jcfg))
        for got, same, want in zip(_tree_fields(old, b),
                                   _tree_fields(new, b), ref):
            assert np.array_equal(got, want) and np.array_equal(got, same)


def test_leaf_particle_index_loop_is_the_references():
    for n, levels in [(64, 1), (300, 2), (1024, 3), (50, 0), (257, 2)]:
        jcfg, tcfg = configs(n=n, nlevels=levels, p=5, dtype="f64")
        loop = leaf_particle_index_loop(tcfg)
        assert loop.dtype == np.int32
        assert np.array_equal(loop, jax_index_loop(jcfg))
        assert np.array_equal(loop, leaf_particle_index(tcfg))


# ---------------------------------------------------------------------------
# direct_potential_numpy, ragged_requests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["harmonic", "log"])
def test_direct_potential_numpy_is_the_references(kernel):
    z, q = inputs("layer", 200, 5)
    z[7] = z[3]                                   # a coincident pair
    got = direct_potential_numpy(z, z, q, kernel=kernel)
    assert got.dtype == np.complex128
    assert np.array_equal(got, jax_direct_numpy(z, z, q, kernel=kernel))
    torch_sum = direct_potential(torch.from_numpy(z), torch.from_numpy(z),
                                 torch.from_numpy(q), kernel=kernel)
    assert rel(torch_sum, got) <= EXP_TOL


@pytest.mark.parametrize("seed", [0, 5])
def test_ragged_requests_are_the_references(seed):
    kw = dict(seed=seed, median_n=48, n_max=300, poison_rate=0.5,
              dist="normal")
    kinds = set()
    for got, want in zip(ragged_requests(16, **kw), jax_ragged(16, **kw),
                         strict=True):
        n, z, q, kind = got
        assert (n, kind) == (want[0], want[3])
        for a, b in ((z, want[1]), (q, want[2])):
            b = np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        kinds.add(kind)
    assert "ok" in kinds and len(kinds) > 2
    with pytest.raises(ValueError, match="poison_rate"):
        next(ragged_requests(1, poison_rate=2.0))


# ---------------------------------------------------------------------------
# degenerate layouts through apply_with_health
# ---------------------------------------------------------------------------

def _layouts(n):
    rng = np.random.default_rng(42)
    ones = np.ones(n, np.complex128)
    normal = rng.normal(size=n) + 0j
    cluster = np.full(n, 0.25 + 0.25j)
    cluster[0] = 0.75 + 0.75j
    uz, uq = inputs("uniform", n, 42)
    out = {
        "all-coincident": (np.full(n, 0.3 + 0.6j), ones),
        "one-distinct-in-a-cluster": (cluster, ones),
        "collinear": (rng.uniform(0, 1, n) + 0.4j, normal),
        "empty-quadrants": (rng.uniform(0, 0.25, n)
                            + 1j * rng.uniform(0, 0.25, n), normal),
        "zero-charges": (uz, np.zeros(n, np.complex128)),
    }
    for e in (-9, -3, 6):
        out[f"scale-1e{e}"] = (uz * 10.0 ** e, uq)
    return out


LAYOUTS = list(_layouts(256))


def test_the_smoke_runs_these_layouts_on_the_card():
    """``chip_smoke.degenerate_layouts`` (the card's copy, which cannot
    import the reference's generator) draws these layouts bit for bit."""
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    mine = chip_smoke.degenerate_layouts(256)
    assert list(mine) == LAYOUTS
    for name, (z, q) in _layouts(256).items():
        for a, b in zip(mine[name], (z, q)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_degenerate_layouts_health_and_phi_match_the_reference(layout):
    jcfg, tcfg = configs(n=256, nlevels=2, p=12, dtype="f64", strong_cap=32,
                         weak_cap=64)
    z, q = _layouts(256)[layout]
    phi, health = FmmSolver.build(tcfg, backend="cuda",
                                  device="cpu").apply_with_health(z, q)
    jphi, jhealth = JaxSolver.build(jcfg, "reference").apply_with_health(
        jnp.asarray(z), jnp.asarray(q))
    got, ref = phi.numpy(), np.asarray(jphi)
    assert host_health(health) == jax_host_health(jhealth)
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    ok = np.isfinite(ref)
    if ok.any() and np.abs(ref[ok]).max() > 0:
        assert rel(got[ok], ref[ok]) <= TOL
    else:
        assert np.array_equal(got[ok], ref[ok])
