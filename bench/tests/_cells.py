"""Tiny-size copies of the benchmark's cells, and one run of a driver on
the CPU, for the bench tests."""
from __future__ import annotations

import copy

import torch

from bench import harness
from bench.tracing import Tracer

ROOT = harness.ROOT

#: Parameters that shrink each cell to a size the CPU runs in seconds;
#: everything else is the cell file's.
TINY = {
    "f64-uniform-solve": dict(n=4096, ring=2,
                              check={"solves": 1, "targets": 256}),
    "f64-layer-solve": dict(n=4096, ring=2, strong_cap=48, weak_cap=128,
                            check={"solves": 1, "targets": 256}),
    "f32-vortex-rk2": dict(n=4096, warm_steps=1,
                           check={"steps": 2, "targets": 256}),
    "f32-serve-ragged": dict(rate=20, lattice=[64, 1024, 2.0], median_n=256,
                             n_max=1024, warm_batches=[1, 2],
                             check={"requests": 0}),
}


def tiny_cell(name: str, **over) -> dict:
    cell = copy.deepcopy(harness.cell(name))
    cell["params"].update(TINY[name], trace_iterations=1)
    cell["params"].update(over)
    return cell


def run_cell(cell: dict, seconds: float = 1.0, seed: int = 4_000_000_007,
             trace: bool = False):
    """Set up, run the window, release and check one cell on the CPU:
    ``(run, numbers, correct)``."""
    run = harness.Run(cell=cell, seed=seed, device=torch.device("cpu"),
                      trace=trace)
    driver = harness.driver_class(cell["traffic"])(run)
    driver.setup(seconds)
    tracer = Tracer(trace, cell["params"]["trace_iterations"], "cpu",
                    seconds)
    driver.window(seconds, tracer)
    run.digest = tracer.finish()
    driver.release()
    numbers = driver.check()
    correct = all(numbers[k] <= lim for k, lim in run.limits.items())
    return run, numbers, correct
