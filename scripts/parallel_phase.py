#!/usr/bin/env python3
"""Run only the ``parallel`` phase of ``chip_smoke.py`` on the card.

    python3 scripts/parallel_phase.py

Builds the kernels, then runs the phase's legs: (a) one NCCL rank, the
compressed gradient and ``ef_allreduce`` against ``all_reduce`` (ms,
bytes); (c) the vortex state at 2^20 saved, restored as DTensors and
resumed bitwise; (b) eight gloo ranks sharing the card. Each leg
prints one line; a failing gate exits nonzero.
"""
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (importable by name: the ranks unpickle it)
from repro_torch.kernels import build_all  # noqa: E402


def main() -> None:
    print(chip_smoke.card_line(), flush=True)
    build_all()
    chip_smoke.observe_programs()
    t0 = time.perf_counter()
    chip_smoke.parallel_phase(
        chip_smoke.load_example("torch_vortex_dynamics"), torch)
    print(f"parallel phase {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":    # the spawned ranks import this file
    main()
