"""The boundary nodes of the multiconductor cell, made from ``--seed``
(numpy only).

A frozen copy of the port's ``repro_torch.data.synthetic.wire_nodes``
(its "wires8" distribution): the same numbers for the same arguments,
checked by ``bench/tests/test_bench_block.py``. Nothing here imports the
port, so a change to the port's generator cannot change what the
benchmark feeds it.

Eight round wires in a row in free space, centres (0.15 + 0.1 i, 0.5)
for i = 0..7, radius 0.015, with no dielectric and no ground plane;
``n // 8`` nodes a wire (the first ``n % 8`` wires one more), equispaced
in angle from a phase offset drawn from the seed in [0, 2 pi / nodes).
"""
from __future__ import annotations

import numpy as np

WIRES = 8
PITCH = 0.1
FIRST = 0.15
RADIUS = 0.015


def wire_nodes(n: int, seed=0):
    """(z, q) as complex128 arrays: the nodes, wire by wire, then N(0, 1)
    real charges. ``seed`` is anything ``np.random.default_rng`` takes."""
    rng = np.random.default_rng(seed)
    counts = [n // WIRES + (i < n % WIRES) for i in range(WIRES)]
    phases = rng.uniform(0.0, 1.0, WIRES)
    parts = []
    for i, m in enumerate(counts):
        theta = 2 * np.pi * (phases[i] + np.arange(m)) / max(m, 1)
        parts.append(FIRST + PITCH * i + 0.5j
                     + RADIUS * np.exp(1j * theta))
    z = np.concatenate(parts)
    q = rng.normal(size=n)
    return z, q + 0j
