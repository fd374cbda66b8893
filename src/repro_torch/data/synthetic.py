"""The paper's three source distributions (Fig. 5.8), from a numpy seed.

``particles`` draws exactly the numbers ``repro.data.synthetic.particles``
draws for the same ``(dist, n, seed)`` — uniform in the unit square,
N(0.5, 0.1^2) per axis and the 'layer' distribution, rejected to fit the
unit square as in the paper — so both packages see the same particles.
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
