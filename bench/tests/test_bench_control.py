"""On the card, at each cell's own size: the control, the nearest
precision below the configuration's in the program's place, comes out
not correct on three seeds (``gpu``: skipped without a card).

For an f64 configuration the control is the program's own f32 path; for
an f32 one, the reference computed in bfloat16. ``bench/tools/
readings.py`` prints the same readings beside the program's own."""
from __future__ import annotations

import copy

import pytest
import torch

from ._cells import harness

CONTROLS = {"f64-uniform-solve": "f32", "f64-layer-solve": "f32",
            "f32-vortex-rk2": "bf16", "f32-serve-ragged": "bf16"}
SEEDS = (3_300_000_001, 3_300_000_002, 3_300_000_003)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONTROLS))
def test_the_control_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    from bench.tracing import Tracer
    device = torch.device("cuda", 0)
    for seed in SEEDS:
        cell = copy.deepcopy(harness.cell(name))
        if CONTROLS[name] == "f32":
            cell["config"]["dtype"] = "f32"
        run = harness.Run(cell=cell, seed=seed, device=device,
                          control="bf16" if CONTROLS[name] == "bf16"
                          else None)
        driver = harness.driver_class(cell["traffic"])(run)
        driver.setup(2.0)
        driver.window(2.0, Tracer(False, 0, device))
        driver.release()
        numbers = driver.check()
        assert any(numbers[k] > lim for k, lim in run.limits.items()), \
            (seed, numbers)
