#!/usr/bin/env python3
"""Count the leaf-layout builds of a 9-size serving wave, for one tree.

    python3 scripts/layout_builds.py [--src DIR] [--label TEXT]
                                     [--device DEV]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``;
another tree's ``src``, e.g. an earlier commit unpacked with ``git
archive``, compares two versions in one call) and runs the shape
sequence of the serving plane's default lattice: one
``apply_batched_with_health`` (B = 1, uniform particles, seed 0) at each
of N = 64, 128, ..., 16384 in ascending order, each on its own solver
(``fmm_config(N)``, caps 48/128, f32, p = 17, backend "auto"), and the
same wave a second time. A leaf layout is built once per (N, nlevels,
device) and cached; a cache that holds fewer layouts than the wave has
sizes rebuilds every one of them in the second wave. Builds are counted
by wrapping ``leaf_particle_index``, which every build calls once, so
trees that count their builds differently compare. Prints one JSON line:
the label, the device (and the card's name and power limit), the builds
in each wave, a digest of every phi of both waves (equal digests across
two trees: bitwise equal outputs) and ``leaf_layout.cache_info()``
after it. Without
``--device`` it runs on the CUDA card and fails without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SIZES = [64 << k for k in range(9)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    from repro_torch.configs import fmm_config
    from repro_torch.core.topology import tree
    from repro_torch.data import particles_numpy
    from repro_torch.device import resolve_device
    from repro_torch.solver import FmmSolver

    dev = resolve_device(args.device)
    builds = [0]
    index = tree.leaf_particle_index

    def counted(cfg):
        builds[0] += 1
        return index(cfg)

    tree.leaf_particle_index = counted
    waves = []
    digest = hashlib.sha256()
    for _ in range(2):
        before = builds[0]
        for n in SIZES:
            solver = FmmSolver.build(fmm_config(n), device=dev)
            z, q = particles_numpy("uniform", n, 0)
            zt = torch.as_tensor(z.astype(np.complex64), device=dev)[None]
            qt = torch.as_tensor(q.astype(np.complex64), device=dev)[None]
            phi, _ = solver.apply_batched_with_health(zt, qt)
            digest.update(phi.cpu().numpy().tobytes())
        waves.append(builds[0] - before)
    card = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    print(json.dumps({"label": args.label, "src": args.src,
                      "device": str(dev), "card": card, "sizes": SIZES,
                      "builds_per_wave": waves,
                      "phi_digest": digest.hexdigest()[:16],
                      "lru": tree.leaf_layout.cache_info()._asdict()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
