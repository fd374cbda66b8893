"""Each cell's driver runs a few iterations at a tiny size on the CPU,
called directly with the CPU as its device, and comes out correct; the
metrics that need no card read from it."""
from __future__ import annotations

import json
import math

import pytest

from ._cells import ROOT, TINY, harness, run_cell, tiny_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: Metrics only a run on the card can give (device memory, the trace).
CARD_ONLY = {"peak_mem_gib", "device_idle", "m2l_roofline",
             "eval_fused_roofline", "program_pool_gib"}


@pytest.mark.parametrize("name", sorted(TINY))
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_driver_runs_on_the_cpu(name, trace):
    # a traced run times its host-clock metrics after the traced slice
    run, numbers, correct = run_cell(tiny_cell(name), trace=trace,
                                     seconds=3.0 if trace else 1.0)
    assert correct, numbers
    assert set(run.limits) <= set(numbers)
    assert run.readings["iterations"] >= 1 and run.readings["failed"] == 0
    run.setup_seconds = 1.0
    for m in harness.cell_metrics(BENCH, name, trace):
        read, scope = harness.reader(m["name"])
        value = read(run, scope)
        if m["name"].partition(".")[0] in CARD_ONLY:
            continue
        assert value is not None and math.isfinite(value), m["name"]
