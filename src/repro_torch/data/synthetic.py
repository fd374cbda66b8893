"""The paper's three source distributions (Fig. 5.8), from a numpy seed.

``particles`` draws exactly the numbers ``repro.data.synthetic.particles``
draws for the same ``(dist, n, seed)`` — uniform in the unit square,
N(0.5, 0.1^2) per axis and the 'layer' distribution, rejected to fit the
unit square as in the paper — so both packages see the same particles.
``ragged_requests`` is the serving workload built on them, request for
request the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def particles_numpy(dist: str, n: int, seed: int = 0):
    """(z, q) as complex128 numpy arrays: positions in the unit square and
    N(0, 1) real charges."""
    rng = np.random.default_rng(seed)

    def rejected(gen):
        out = np.empty(0, np.complex128)
        while out.size < n:
            z = gen(2 * (n - out.size) + 16)
            ok = (z.real >= 0) & (z.real <= 1) & (z.imag >= 0) & (z.imag <= 1)
            out = np.concatenate([out, z[ok]])
        return out[:n]

    if dist == "uniform":
        z = rng.uniform(0, 1, n) + 1j * rng.uniform(0, 1, n)
    elif dist == "normal":
        z = rejected(lambda m: (0.5 + rng.normal(0, 0.1, m))
                     + 1j * (0.5 + rng.normal(0, 0.1, m)))
    elif dist == "layer":
        z = rejected(lambda m: rng.uniform(0, 1, m)
                     + 1j * (0.5 + rng.normal(0, 0.1, m)))
    else:
        raise ValueError(dist)
    q = rng.normal(size=n)
    return z, q + 0j


def particles(dist: str, n: int, seed: int = 0, device=None):
    """``particles_numpy`` as complex128 tensors on ``device`` (default
    ``cuda``, raising without a card; pass ``device="cpu"`` for the
    CPU)."""
    z, q = particles_numpy(dist, n, seed)
    dev = resolve_device(device)
    return (torch.from_numpy(z).to(dev), torch.from_numpy(q).to(dev))


#: The poison kinds of ``ragged_requests``.
POISONS = ("nan-q", "inf-z", "real-z", "empty")


def ragged_requests(num: int, *, seed: int = 0, median_n: int = 256,
                    sigma: float = 0.8, n_min: int = 4,
                    n_max: int | None = None, poison_rate: float = 0.0,
                    dist: str = "uniform"):
    """Synthetic ragged serving workload: ``num`` requests whose sizes
    follow a log-normal distribution, with a fraction ``poison_rate`` of
    poisoned requests.

    Yields ``(n, z, q, kind)`` with numpy arrays, a pure function of
    ``(seed, i)`` (any consumer can regenerate any request), the same
    as ``repro.data.synthetic.ragged_requests`` for the same arguments.
    ``kind`` is "ok" or the poison: "nan-q" (one charge NaN), "inf-z"
    (one position Inf), "real-z" (positions as a real array), "empty"
    (zero-length arrays).
    """
    if not 0.0 <= poison_rate <= 1.0:
        raise ValueError(f"poison_rate must be in [0, 1]; got {poison_rate}")
    for i in range(num):
        rng = np.random.default_rng(np.random.PCG64((seed, i)))
        n = int(np.clip(np.round(rng.lognormal(np.log(median_n), sigma)),
                        n_min, n_max if n_max is not None else np.inf))
        z, q = particles_numpy(dist, n, seed=int(rng.integers(1 << 30)))
        kind = "ok"
        if poison_rate and rng.uniform() < poison_rate:
            kind = POISONS[int(rng.integers(len(POISONS)))]
            if kind == "nan-q":
                q = q.copy()
                q[int(rng.integers(n))] = np.nan
            elif kind == "inf-z":
                z = z.copy()
                z[int(rng.integers(n))] = np.inf + 0j
            elif kind == "real-z":
                z = z.real.copy()
            elif kind == "empty":
                z = z[:0]
                q = q[:0]
        yield n, z, q, kind
