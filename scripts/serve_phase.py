#!/usr/bin/env python3
"""Run only the ``serve`` phase of a tree's ``chip_smoke.py`` on the card.

    python3 scripts/serve_phase.py DIR

DIR is the root of a checkout (this one: ``.``; an older commit unpacked
with ``git archive <rev> | tar -x -C DIR``). The phase runs with that
tree's own ``src/`` (``chip_smoke.py`` puts it first on ``sys.path``):
the kernels are built, then ``serve_phase`` serves its waves and prints
requests/s, latency and the dispatch numbers. To compare two commits on
one card, run old, new, new, old in one call, each in a fresh process.
"""
import importlib.util
import sys
import time

import torch

root = sys.argv[1]
spec = importlib.util.spec_from_file_location("smoke", root + "/chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
from repro_torch.kernels import build_all  # noqa: E402

print("tree", root, flush=True)
build_all()
if hasattr(smoke, "observe_programs"):
    smoke.observe_programs()
t0 = time.perf_counter()
smoke.serve_phase(torch)
print(f"serve phase {time.perf_counter() - t0:.1f} s", flush=True)
