"""PyTorch port, topology: the single-sort tree and the theta
connectivity are bit-identical to the JAX reference, with no hook (the
plain per-level classifier) and through the "cuda" backend's per-level
classify hook (its plain version on the CPU); that hook's leaf level is
bit-identical to the reference's Pallas kernel in interpret mode; a
build counts its levels by path."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.topology import leaf_classify_pallas
from repro_torch.core.topology import build_connectivity, build_tree
from repro_torch.core.topology import connectivity as conn_mod
from repro_torch import trace
from repro_torch.kernels import level_classify_cuda, level_classify_plain

from _torch_parity import configs, inputs, jax_plan, t

# the Pallas kernel's key of a dropped entry
INT_MAX = np.iinfo(np.int32).max

TREE_CASES = [(1024, 3, "uniform", "f64"), (4096, 3, "normal", "f32"),
              (4096, 3, "layer", "f64"), (777, 2, "layer", "f32"),
              (2000, 3, "normal", "f64"), (50, 0, "uniform", "f64")]


def _both(n, levels, dist, dt, seed=0, **kw):
    jcfg, tcfg = configs(n=n, nlevels=levels, p=5, dtype=dt, **kw)
    z, q = inputs(dist, n, seed)
    jp = jax_plan(jcfg, z, q)
    tree = build_tree(t(z), t(q), tcfg)
    return jcfg, tcfg, jp, tree


def _eq(a, b) -> bool:
    return np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("n,levels,dist,dt", TREE_CASES)
def test_tree_bit_identical(n, levels, dist, dt):
    _, _, jp, tree = _both(n, levels, dist, dt)
    jt = jp.tree
    assert _eq(jt.perm, tree.perm[0])
    assert _eq(jt.z, tree.z[0]) and _eq(jt.q, tree.q[0])
    for l in range(levels + 1):
        assert _eq(jt.centers[l], tree.centers[l][0]), l
        assert _eq(jt.radii[l], tree.radii[l][0]), l


def test_tree_batched_rows_equal_single_builds():
    _, tcfg = configs(n=1024, nlevels=3, p=5, dtype="f32")
    zs, qs = zip(*[inputs(d, 1024, s) for d, s in
                   (("uniform", 1), ("normal", 2), ("layer", 3))])
    batch = build_tree(torch.from_numpy(np.stack(zs)),
                       torch.from_numpy(np.stack(qs)), tcfg)
    for b in range(3):
        one = build_tree(t(zs[b]), t(qs[b]), tcfg)
        assert torch.equal(batch.perm[b], one.perm[0])
        for l in range(4):
            assert torch.equal(batch.radii[l][b], one.radii[l][0])


def test_build_tree_sorts_exactly_twice(monkeypatch):
    """Two stable argsorts regardless of depth, and no other sort."""
    calls = {"argsort": 0, "sort": 0}
    real_argsort, real_sort = torch.argsort, torch.sort

    def argsort(*a, **k):
        calls["argsort"] += 1
        assert k.get("stable") is True
        return real_argsort(*a, **k)

    def sort(*a, **k):
        calls["sort"] += 1
        return real_sort(*a, **k)

    monkeypatch.setattr(torch, "argsort", argsort)
    monkeypatch.setattr(torch, "sort", sort)
    for levels in (1, 2, 4):
        calls.update(argsort=0, sort=0)
        _, tcfg = configs(n=16 * 4**levels, nlevels=levels, p=5)
        z, q = inputs("uniform", tcfg.n)
        build_tree(t(z), t(q), tcfg)
        assert calls == {"argsort": 2, "sort": 0}, (levels, calls)


CONN_CASES = [
    (1024, 3, "uniform", "f64", {}),
    (4096, 3, "normal", "f32", {}),
    (4096, 3, "layer", "f64", {}),
    # theta != 0.5: the reference contracts big + theta*small into an
    # FMA; without fma_rn these lists differ
    (4096, 3, "layer", "f32", dict(theta=0.3)),
    (4096, 3, "normal", "f64", dict(theta=0.3)),
    (777, 2, "normal", "f64", dict(use_p2l_m2p=False)),
    (4096, 3, "normal", "f32", dict(strong_cap=8)),      # overflowing
    (50, 0, "normal", "f32", {}),
]


@pytest.mark.parametrize("n,levels,dist,dt,kw", CONN_CASES)
def test_connectivity_bit_identical(n, levels, dist, dt, kw):
    """With no hook (``classify_level_reference`` a level; at nlevels 0
    the root's swapped test): every list, margin and overflow equal to
    the reference. A differing entry is listed (none is allowed)."""
    _, tcfg, jp, tree = _both(n, levels, dist, dt, **kw)
    conn = build_connectivity(tree, tcfg)
    jc = jp.conn
    diffs = []
    for l in range(levels + 1):
        for name, a, b in (("strong", jc.strong[l], conn.strong[l][0]),
                           ("weak", jc.weak[l], conn.weak[l][0])):
            if not _eq(a, b):
                diffs.append((name, l, np.argwhere(np.asarray(a)
                                                   != b.numpy())[:5]))
    for name in ("p2p", "p2l", "m2p", "margins", "overflow"):
        a, b = getattr(jc, name), getattr(conn, name)[0]
        if not _eq(a, b):
            diffs.append((name, np.argwhere(np.asarray(a)
                                            != b.numpy())[:5]))
    assert diffs == []


@pytest.mark.parametrize("dt", [np.float32, np.float64])
def test_theta_predicates_bit_identical_at_the_boundary(dt):
    """Candidates placed within a few ulps of the theta boundary: the
    port's masks equal the reference's jitted masks element for element,
    and rounding big + theta*small twice (no FMA) would not."""
    import jax
    from repro.core.topology.connectivity import (_swapped_masks,
                                                  _theta_masks)
    rng = np.random.default_rng(5)
    nb, C, theta = 64, 96, 0.3
    rb = rng.uniform(0.01, 0.1, nb).astype(dt)
    rc = rng.uniform(0.01, 0.1, (nb, C)).astype(dt)
    big, small = np.maximum(rb[:, None], rc), np.minimum(rb[:, None], rc)
    edge = (big.astype(np.float64) + theta * small.astype(np.float64)) / theta
    ulps = rng.integers(-3, 4, (nb, C))
    d = np.nextafter(edge.astype(dt), np.where(ulps > 0, np.inf, -np.inf)
                     .astype(dt))
    d = np.where(ulps == 0, edge.astype(dt), d).astype(dt)
    cbx = np.zeros(nb, dt)
    cby = rng.uniform(0, 1, nb).astype(dt)
    ccx = (-d).astype(dt)                   # |cbx - ccx| == d exactly
    ccy = np.broadcast_to(cby[:, None], (nb, C)).astype(dt)
    valid = np.ones((nb, C), bool)
    jcfg, tcfg = configs(n=1024, nlevels=2, theta=theta)
    jw, js = jax.jit(_theta_masks, static_argnums=7)(
        cbx, cby, rb, ccx, ccy, rc, valid, theta)
    T = torch.from_numpy
    tw, ts = conn_mod.theta_masks(T(cbx), T(cby), T(rb), T(ccx), T(ccy),
                                  T(rc), T(valid), theta)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    jsw = jax.jit(_swapped_masks, static_argnums=7)(
        cbx, cby, rb, ccx, ccy, rc, np.asarray(js), jcfg)
    tsw = conn_mod.swapped_masks(T(cbx), T(cby), T(rb), T(ccx), T(ccy),
                                 T(rc), ts, tcfg)
    for a, b in zip(tsw, jsw):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    plain = (T(big) + dt(theta) * T(small)) <= dt(theta) * T(d)
    assert (plain.numpy() != np.asarray(jw)).any()


@pytest.mark.parametrize("dist,dt,kw", [
    ("uniform", "f64", {}), ("normal", "f32", {}), ("layer", "f64", {}),
    ("normal", "f32", dict(use_p2l_m2p=False)),
    ("layer", "f32", dict(theta=0.3))])
def test_leaf_classify_matches_pallas_interpret(dist, dt, kw):
    """The port's classify wrapper on CPU tensors (its plain version) at
    the leaf level is bit-identical to the reference's Pallas kernel
    (interpret mode) on the same candidates: each class's list is the
    Pallas kernel's row of sort keys, sorted and clipped at its cap, and
    each row's count its kept entries."""
    n, levels = 1024, 2
    jcfg, tcfg = configs(n=n, nlevels=levels, p=5, dtype=dt, strong_cap=16,
                         **kw)
    z, q = inputs(dist, n, 1)
    jp = jax_plan(jcfg, z, q)
    captured = {}

    def hook(parent, centers, radii, cfg, leaf):
        if leaf:
            captured["args"] = (parent, centers, radii)
        return level_classify_cuda(parent, centers, radii, cfg, leaf)

    from repro_torch.core.fmm import plan_from_numpy
    tree = plan_from_numpy(jp.tree, jp.conn, tcfg, device="cpu").tree
    build_connectivity(tree, tcfg, leaf_classify_impl=hook)
    parent, centers, radii = captured["args"]
    ours, counts = level_classify_cuda(parent, centers, radii, tcfg, True)
    plain, plain_counts = level_classify_plain(parent, centers, radii, tcfg,
                                               True)
    assert torch.equal(counts, plain_counts)
    cand, valid = conn_mod._candidates(parent, radii.shape[1])
    theirs = leaf_classify_pallas(jnp.asarray(cand[0].numpy()),
                                  jnp.asarray(valid[0].numpy()),
                                  jnp.asarray(centers[0].numpy()),
                                  jnp.asarray(radii[0].numpy()), jcfg,
                                  interpret=True)
    caps = (tcfg.strong_cap, tcfg.weak_cap) + 3 * (tcfg.strong_cap,)
    for k, (a, b, keys, cap) in enumerate(zip(ours, plain, theirs, caps)):
        assert a.dtype == torch.int32
        assert torch.equal(a, b)
        keys = np.asarray(keys)
        kept = np.sort(keys, axis=-1)[:, :cap]
        np.testing.assert_array_equal(
            a[0].numpy(), np.where(kept == INT_MAX, -1, kept))
        np.testing.assert_array_equal(counts[0, :, k].numpy(),
                                      (keys != INT_MAX).sum(-1))


@pytest.mark.parametrize("n,levels,dist,dt,kw", CONN_CASES)
def test_classify_hook_path_bit_identical(n, levels, dist, dt, kw):
    """The "cuda" backend's classify hook on CPU tensors (one call a
    level, compaction in candidate order, no sort): every list, margin
    and overflow equal to the reference, and the build counts its levels
    under ``connectivity.plain_levels``, none under ``.kernel_levels``."""
    _, tcfg, jp, tree = _both(n, levels, dist, dt, **kw)
    before = trace.snapshot()["counters"]
    conn = build_connectivity(tree, tcfg,
                              leaf_classify_impl=level_classify_cuda)
    after = trace.snapshot()["counters"]
    gained = {k: after[k] - before.get(k, 0)
              for k in ("connectivity.kernel_levels",
                        "connectivity.plain_levels")}
    assert gained == {"connectivity.kernel_levels": 0,
                      "connectivity.plain_levels": levels}
    jc = jp.conn
    for l in range(levels + 1):
        assert _eq(jc.strong[l], conn.strong[l][0]), ("strong", l)
        assert _eq(jc.weak[l], conn.weak[l][0]), ("weak", l)
    for name in ("p2p", "p2l", "m2p", "margins", "overflow"):
        assert _eq(getattr(jc, name), getattr(conn, name)[0]), name


def test_a_cpu_build_counts_its_levels_as_plain():
    """A build on the CPU with no hook adds its levels to
    ``connectivity.plain_levels`` and none to ``.kernel_levels``."""
    _, tcfg = configs(n=1024, nlevels=3, p=5, dtype="f64")
    z, q = inputs("normal", 1024, 0)
    tree = build_tree(t(z), t(q), tcfg)
    before = trace.snapshot()["counters"]
    build_connectivity(tree, tcfg)
    after = trace.snapshot()["counters"]
    assert {k: after[k] - before.get(k, 0)
            for k in ("connectivity.kernel_levels",
                      "connectivity.plain_levels")} == {
        "connectivity.kernel_levels": 0, "connectivity.plain_levels": 3}
