"""The reference's frozen copies give the port's arrays byte for byte, and
its direct sum and error numbers are what they say."""
from __future__ import annotations

import importlib.util
import math

import numpy as np
import pytest
import torch

from bench.reference import direct, inputs
from repro_torch.core.direct import direct_potential_numpy
from repro_torch.data import synthetic

from ._cells import ROOT


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("dist", ["uniform", "normal", "layer"])
@pytest.mark.parametrize("seed", [0, 7, [4_000_000_001, 3]])
def test_particles_match_the_port(dist, seed):
    for n in (1, 257, 4096):
        got = inputs.particles_numpy(dist, n, seed)
        want = synthetic.particles_numpy(dist, n, seed)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 3, 2_147_483_659])
def test_ragged_requests_match_the_port(seed):
    kw = dict(seed=seed, median_n=300, sigma=1.0, n_max=4096,
              poison_rate=0.5)
    got = list(inputs.ragged_requests(40, **kw))
    want = list(synthetic.ragged_requests(40, **kw))
    assert [g[3] for g in got] == [w[3] for w in want]
    assert {g[3] for g in got} >= set(inputs.POISONS) | {"ok"}
    for (n, z, q, _), (n2, z2, q2, _) in zip(got, want):
        assert n == n2
        assert z.dtype == z2.dtype and z.tobytes() == z2.tobytes()
        assert q.dtype == q2.dtype and q.tobytes() == q2.tobytes()


def test_vortex_pair_matches_the_example():
    example = _example("torch_vortex_dynamics")
    for n in (2, 1001, 4096):
        for a, b in zip(inputs.vortex_pair(n, 0), example.vortex_pair(n)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_open_loop_stream_same_work_every_seed():
    kw = dict(median_n=2048, sigma=1.0, n_min=4, n_max=16384,
              poison_rate=0.1, dtype=np.complex64)
    due1, r1 = inputs.open_loop_requests(300, 10.0, 11, **kw)
    due2, r2 = inputs.open_loop_requests(300, 10.0, 4_000_000_003, **kw)
    again, r1b = inputs.open_loop_requests(300, 10.0, 11, **kw)
    assert sorted(r[0] for r in r1) == sorted(r[0] for r in r2)
    assert sorted(r[3] for r in r1) == sorted(r[3] for r in r2)
    assert [r[0] for r in r1] != [r[0] for r in r2]
    assert due1.tobytes() == again.tobytes()
    assert all(a[1].tobytes() == b[1].tobytes() for a, b in zip(r1, r1b))
    assert np.all(np.diff(due1) >= 0) and 0 <= due1[0] and due1[-1] < 10
    for n, z, q, kind in r1:
        if kind == "real-z":
            assert z.dtype == np.float32
        elif kind == "empty":
            assert z.size == 0
        else:
            assert z.dtype == q.dtype == np.complex64 and z.size == n
            assert np.isfinite(z).all() == (kind != "inf-z")
            assert np.isfinite(q).all() == (kind != "nan-q")


def test_direct_sum_is_the_sum():
    z, q = inputs.particles_numpy("normal", 300, 5)
    z[7] = z[3]                              # a coincident pair
    want = direct_potential_numpy(z[:50], z, q)
    zt, qt = torch.as_tensor(z), torch.as_tensor(q)
    got = direct.direct_sum(zt[:50], zt, qt).numpy()
    assert np.max(np.abs(got - want) / np.abs(want)) < 1e-12
    low = direct.direct_sum(zt[:50], zt, qt, dtype=torch.bfloat16).numpy()
    assert direct.errors(low, want)["rms"] > 1e-3


def test_errors():
    want = np.array([1.0, 2.0j, -4.0])
    assert direct.errors(want, want) == {"inf": 0.0, "rms": 0.0}
    got = want * (1 + 1e-3)
    e = direct.errors(got, want)
    assert math.isclose(e["inf"], 1e-3) and math.isclose(e["rms"], 1e-3)
    assert direct.errors(np.array([np.nan, 0, 0]), want)["rms"] == math.inf
    assert direct.errors(want[:2], want)["inf"] == math.inf
