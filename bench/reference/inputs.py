"""The benchmark's inputs, made from ``--seed`` (numpy only).

Frozen copies of the port's generators (``repro_torch.data.synthetic``'s
``particles_numpy`` and ``ragged_requests``, the vortex example's
``vortex_pair``): the same numbers for the same arguments, checked by
``bench/tests/test_bench_reference.py``. Nothing here imports the port,
so a change to the port's generators cannot change what the benchmark
feeds it.
"""
from __future__ import annotations

import numpy as np

#: The poison kinds of ``ragged_requests``.
POISONS = ("nan-q", "inf-z", "real-z", "empty")


def particles_numpy(dist: str, n: int, seed=0):
    """(z, q) as complex128 arrays: positions in the unit square
    ("uniform"; "normal": N(0.5, 0.1^2) per axis; "layer": uniform in x,
    N(0.5, 0.1^2) in y; both rejected to the unit square, as in the
    paper's Fig. 5.8) and N(0, 1) real charges. ``seed`` is anything
    ``np.random.default_rng`` takes."""
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


def poison(z, q, kind: str, rng):
    """``(z, q)`` with the poison ``kind`` applied (``rng`` picks the
    element), as ``ragged_requests`` applies it."""
    n = z.size
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
    return z, q


def ragged_requests(num: int, *, seed=0, median_n: int = 256,
                    sigma: float = 0.8, n_min: int = 4,
                    n_max: int | None = None, poison_rate: float = 0.0,
                    dist: str = "uniform"):
    """``num`` requests ``(n, z, q, kind)`` with log-normal sizes and a
    fraction ``poison_rate`` poisoned, a pure function of ``(seed, i)``."""
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
            z, q = poison(z, q, kind, rng)
        yield n, z, q, kind


def open_loop_requests(count: int, seconds: float, seed: int, *,
                       median_n: int, sigma: float, n_min: int, n_max: int,
                       poison_rate: float, dist: str = "uniform",
                       dtype=np.complex128, base_seed: int = 0):
    """An open-loop stream of ``count`` requests due in ``[0, seconds)``.

    Every seed gets the same multiset of sizes and poison kinds (drawn
    once from ``base_seed`` as ``ragged_requests`` draws them: log-normal
    sizes, clipped), in an order that the seed permutes, so that the
    seed changes which request comes when but not the work. Arrival
    times are a Poisson process of ``count`` arrivals in the window
    (sorted uniform times), positions and charges ``particles_numpy``
    drawn from ``(seed, i)`` and sent as ``dtype`` (the served precision,
    so that both sides see the same numbers). Returns sorted due times
    (seconds) and a list of ``(n, z, q, kind)``."""
    base = np.random.default_rng([base_seed, count])
    sizes = np.clip(np.round(base.lognormal(np.log(median_n), sigma, count)),
                    n_min, n_max).astype(np.int64)
    poisoned = base.uniform(size=count) < poison_rate
    kinds = np.where(poisoned, np.array(POISONS)[
        base.integers(len(POISONS), size=count)], "ok")
    rng = np.random.default_rng([seed, 1])
    order = rng.permutation(count)
    due = np.sort(rng.uniform(0.0, seconds, count))
    out = []
    for i, j in enumerate(order):
        n, kind = int(sizes[j]), str(kinds[j])
        r = np.random.default_rng([seed, 2, i])
        z, q = particles_numpy(dist, n, seed=[seed, 3, i])
        z, q = z.astype(dtype), q.astype(dtype)
        if kind != "ok":
            z, q = poison(z, q, kind, r)
        out.append((n, z, q, kind))
    return due, out


def vortex_pair(n: int, seed=0):
    """Two counter-rotating Gaussian clusters (sigma 0.08, centred at
    0.35 + 0.5i and 0.65 + 0.5i, circulation +1 and -1): positions
    (complex128) and strengths (float64), from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    n2 = n // 2
    z0 = np.concatenate([
        0.35 + 0.5j + 0.08 * (rng.normal(size=n2) + 1j * rng.normal(size=n2)),
        0.65 + 0.5j + 0.08 * (rng.normal(size=n - n2)
                              + 1j * rng.normal(size=n - n2)),
    ])
    gamma = np.concatenate([np.full(n2, 1.0 / n2),
                            np.full(n - n2, -1.0 / (n - n2))])
    return z0, gamma


def vortex_pair_permuted(n: int, seed: int, base_seed: int = 0):
    """``vortex_pair(n, base_seed)`` in the order ``(seed, 5)`` permutes:
    every seed the same vortices (and so the same tree, lists and tuned
    caps), in another order."""
    z0, gamma = vortex_pair(n, base_seed)
    order = np.random.default_rng([seed, 5]).permutation(n)
    return z0[order], gamma[order]
