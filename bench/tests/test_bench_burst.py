"""The burst cell's schedule and its driver on the CPU at a tiny size."""
from __future__ import annotations

import copy
import json
import math
from collections import Counter

import numpy as np
import pytest

from bench.reference.inputs import open_loop_requests
from bench.traffic.serve_burst import burst_schedule

from ._cells import ROOT, harness, run_cell

CELL = "f32-serve-ragged-burst"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CARD_ONLY = {"peak_mem_gib", "device_idle", "program_pool_gib"}


def _schedule(seed, seconds=30.0):
    p = harness.cell(CELL)["params"]
    return burst_schedule(seed, seconds, p["rate"], p["period"],
                          p["burst_duty"], p["burst_factor"])


@pytest.mark.parametrize("seed", [0, 2_236_067_977, 4_000_000_007])
def test_thirty_bursts_of_160_then_160_a_window(seed):
    due = _schedule(seed)
    assert due.size == 30 * (160 + 160)
    assert np.all(np.diff(due) >= 0) and due[0] >= 0 and due[-1] < 30
    # every 0.25 s burst window of the seed's phase holds 160, and each
    # 0.75 s rest window 160
    offset = np.random.default_rng([seed, 9]).uniform(0.0, 1.0)
    phase = np.mod(due - offset, 1.0)
    assert int((phase < 0.25).sum()) == 30 * 160
    assert int((phase >= 0.25).sum()) == 30 * 160


@pytest.mark.parametrize("seed", [1, 2_718_281_828])
def test_the_steady_cells_sizes_and_poisons(seed):
    steady = harness.cell("f32-serve-ragged")["params"]
    kw = {k: steady[k] for k in ("median_n", "sigma", "n_min", "n_max",
                                 "poison_rate")}
    due = _schedule(seed)
    _, burst = open_loop_requests(due.size, 30.0, seed, **kw,
                                  dtype=np.complex64)
    _, plain = open_loop_requests(round(steady["rate"] * 30), 30.0, seed,
                                  **kw, dtype=np.complex64)
    assert Counter((n, k) for n, _, _, k in burst) == \
        Counter((n, k) for n, _, _, k in plain)


def test_burst_driver_runs_on_the_cpu():
    cell = copy.deepcopy(harness.cell(CELL))
    cell["params"].update(rate=20, lattice=[64, 1024, 2.0], median_n=256,
                          n_max=1024, warm_batches=[1, 2],
                          check={"requests": 0}, trace_iterations=1)
    run, numbers, correct = run_cell(cell, seconds=2.0)
    assert correct, numbers
    assert run.readings["attempted"] == 2 * 20
    run.setup_seconds = 1.0
    for m in harness.cell_metrics(BENCH, CELL, False):
        read, scope = harness.reader(m["name"])
        if m["name"].partition(".")[0] in CARD_ONLY:
            continue
        value = read(run, scope)
        assert value is not None and math.isfinite(value), m["name"]
