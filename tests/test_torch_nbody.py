"""PyTorch port, the direct N-body kernel's wrapper on the CPU: the
launch geometry that ``nbody_plan`` picks from (N, M) (one split when
the target tiles fill the card, enough source splits to fill it
otherwise, the splits covering the sources exactly), and ``nbody_direct``
(its plain version on CPU tensors) against the reference's Pallas
``nbody_direct`` in interpret mode at ragged N and M with coincident
positions, in f32 and f64. The same numpy-seeded inputs go to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import nbody_direct as jax_nbody
from repro_torch.kernels import nbody_direct, nbody_plan
from repro_torch.kernels.nbody.nbody import (BLOCKS_PER_SM, H100_SMS,
                                             MIN_CHUNK, THREADS,
                                             TARGETS_PER_THREAD)

from _torch_parity import rel

TOL = 1e-10
# f32: both packages round every term to f32 and sum in different orders
# (the reference in 512-source tiles, the plain version in one chunk);
# their difference stays near 1e-6 of the largest output.
F32_TOL = 1e-5


def _covers(m, splits, chunk):
    """Split s = [s * chunk, min(m, (s + 1) * chunk)): all non-empty and
    together exactly [0, m)."""
    return splits == 1 and chunk == m or (
        splits > 1 and chunk >= MIN_CHUNK and (splits - 1) * chunk < m
        <= splits * chunk)


@pytest.mark.parametrize("elem", [4, 8])
def test_plan_takes_one_split_when_the_targets_fill_the_card(elem):
    n = 1 << 20
    tiles, splits, chunk = nbody_plan(n, n, elem)
    assert (tiles, splits, chunk) == (
        -(-n // (THREADS * TARGETS_PER_THREAD[elem])), 1, n)
    assert tiles >= BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("elem", [4, 8])
@pytest.mark.parametrize("n,m", [(4096, 1 << 20), (1 << 9, 1 << 9),
                                 (37, 5000), (1 << 16, (1 << 16) + 3),
                                 (4097, 1001)])
def test_plan_splits_the_sources_to_fill_the_card(elem, n, m):
    tiles, splits, chunk = nbody_plan(n, m, elem)
    assert tiles == -(-n // (THREADS * TARGETS_PER_THREAD[elem]))
    assert tiles < BLOCKS_PER_SM * H100_SMS
    assert splits > 1 and _covers(m, splits, chunk)
    assert tiles * splits >= H100_SMS
    if n >= 4096:                # enough splits for four blocks an SM
        assert tiles * splits >= BLOCKS_PER_SM * H100_SMS


@pytest.mark.parametrize("n,m,sms", [(1, 1, 132), (5, 0, 132),
                                     (1000, 3, 132), (4096, 1 << 20, 8)])
def test_plan_edge_cases_cover_the_sources(n, m, sms):
    """One source, none, fewer sources than MIN_CHUNK per split wanted,
    and a smaller card: the splits still cover M exactly."""
    tiles, splits, chunk = nbody_plan(n, m, 4, sms)
    assert _covers(m, splits, chunk)
    assert splits <= max(1, -(-m // MIN_CHUNK))
    want = BLOCKS_PER_SM * sms
    if m and tiles < want:
        assert tiles * splits >= min(want, tiles * -(-m // MIN_CHUNK))


def _coincident_problem(n, m, seed, cdt):
    """m sources in the unit square and n targets: the first third copies
    of source positions, one at the origin (where the reference pads its
    sources), the rest fresh."""
    rng = np.random.default_rng(seed)
    zs = rng.uniform(0, 1, m) + 1j * rng.uniform(0, 1, m)
    q = rng.normal(size=m) + 1j * rng.normal(size=m)
    zt = rng.uniform(0, 1, n) + 1j * rng.uniform(0, 1, n)
    k = n // 3
    zt[:k] = zs[rng.choice(m, k, replace=False)]
    zt[k] = 0.0
    return zt.astype(cdt), zs.astype(cdt), q.astype(cdt)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("n,m", [(333, 777), (129, 1031)])
def test_nbody_direct_matches_pallas_at_ragged_sizes_with_coincident_points(
        dtype, n, m):
    cdt = np.complex64 if dtype == "f32" else np.complex128
    zt, zs, q = _coincident_problem(n, m, n + m, cdt)
    ref = np.asarray(jax_nbody(jnp.asarray(zt), jnp.asarray(zs),
                               jnp.asarray(q), t_tile=128, s_tile=256,
                               interpret=True))
    got = nbody_direct(torch.from_numpy(zt), torch.from_numpy(zs),
                       torch.from_numpy(q))
    assert got.shape == (n,) and got.dtype == torch.from_numpy(zs).dtype
    assert bool(torch.isfinite(got).all()) and np.isfinite(ref).all()
    assert rel(got, ref) <= (TOL if dtype == "f64" else F32_TOL)
    # a coincident target: the sum over every other source, as written
    zt64, zs64, q64 = (a.astype(np.complex128) for a in (zt, zs, q))
    own = zs64 != zt64[0]
    assert (~own).sum() >= 1
    want = np.sum(q64[own] / (zs64[own] - zt64[0]))
    assert abs(complex(got[0]) - want) <= (TOL if dtype == "f64" else
                                           F32_TOL) * np.abs(ref).max()
