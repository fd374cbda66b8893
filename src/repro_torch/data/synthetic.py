"""Deterministic synthetic data, a pure function of a numpy seed.

Streams are stateless: a batch is a function of ``(seed, step)``, so a
restarted worker regenerates any batch with no loader state in a
checkpoint (``lm_batch``, ``Prefetcher``).

``particles`` draws exactly the numbers ``repro.data.synthetic.particles``
draws for the same ``(dist, n, seed)`` — uniform in the unit square,
N(0.5, 0.1^2) per axis and the 'layer' distribution, rejected to fit the
unit square as in the paper — so both packages see the same particles.
Its "wires8" distribution, which the reference does not have, puts the
points on eight round contours instead (``wire_nodes``): the boundary
nodes of a multiconductor line's cross-section. ``ragged_requests`` is the serving workload built on them, request for
request the reference's.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0


def lm_batch(dc: DataConfig, step: int, device=None) -> dict:
    """Synthetic token batch, deterministic in ``(seed, step)``: int32
    ``tokens`` and next-token ``labels`` of shape (batch, seq) on
    ``device`` (default ``cuda``; ``device="cpu"`` for the CPU), the
    numbers ``repro.data.synthetic.lm_batch`` draws."""
    rng = np.random.default_rng(np.random.PCG64((dc.seed, step)))
    useful_vocab = min(dc.vocab, 1024)
    a = rng.integers(0, useful_vocab, (dc.batch, 1))
    b = rng.integers(1, 17, (dc.batch, 1))
    t = np.arange(dc.seq + 1)[None, :]
    toks = torch.from_numpy(((a + b * t) % useful_vocab).astype(np.int32))
    dev = resolve_device(device)
    return {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}


#: The cross-section of ``wire_nodes``: eight round wires in a row in
#: free space, centres (0.15 + 0.1 i, 0.5), radius 0.015 (radius / pitch
#: 0.15, a 0.050-in-pitch ribbon cable).
WIRES = 8
WIRE_PITCH = 0.1
WIRE_FIRST = 0.15
WIRE_RADIUS = 0.015


def wire_nodes(n: int, seed=0):
    """(z, q) as complex128 numpy arrays: ``n`` boundary nodes on the
    ``WIRES`` contours, ``n // WIRES`` a wire (the first ``n % WIRES``
    wires one more), equispaced in angle from a phase drawn from the
    seed in [0, 2 pi / nodes), wire by wire; then N(0, 1) real charges."""
    rng = np.random.default_rng(seed)
    counts = [n // WIRES + (i < n % WIRES) for i in range(WIRES)]
    phases = rng.uniform(0.0, 1.0, WIRES)
    parts = []
    for i, m in enumerate(counts):
        theta = 2 * np.pi * (phases[i] + np.arange(m)) / max(m, 1)
        centre = WIRE_FIRST + WIRE_PITCH * i + 0.5j
        parts.append(centre + WIRE_RADIUS * np.exp(1j * theta))
    z = np.concatenate(parts)
    q = rng.normal(size=n)
    return z, q + 0j


def particles_numpy(dist: str, n: int, seed: int = 0):
    """(z, q) as complex128 numpy arrays: positions in the unit square
    (or, for "wires8", on the contours of ``wire_nodes``) and N(0, 1)
    real charges."""
    if dist == "wires8":
        return wire_nodes(n, seed)
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


class Prefetcher:
    """Background-thread batch prefetch (depth-k queue): ``get()`` returns
    ``(step, fn(step))`` for ``start_step``, ``start_step + 1``, ... in
    order.

    The current CUDA device is per thread: the thread runs ``fn`` on the
    device that was current where the ``Prefetcher`` was made (when CUDA
    was initialised there), so the tensors ``fn`` makes land where the
    consumer's do."""

    def __init__(self, fn, start_step: int = 0, depth: int = 2):
        self._fn = fn
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._device = (torch.cuda.current_device()
                        if torch.cuda.is_initialized() else None)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        if self._device is not None:
            torch.cuda.set_device(self._device)
        s = self._step
        while not self._stop.is_set():
            try:
                self._q.put((s, self._fn(s)), timeout=0.5)
                s += 1
            except queue.Full:
                continue

    def get(self):
        return self._q.get()

    def close(self):
        self._stop.set()
