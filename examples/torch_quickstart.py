"""Quickstart on the PyTorch port: evaluate the harmonic potential of
100k particles with the adaptive FMM through ``FmmSolver``, check it
against direct summation on a sample, then serve a batched (B, N)
workload through ``apply_batched`` — one call, B problems. The twin of
``examples/quickstart.py``.

    python examples/torch_quickstart.py [--n 100000] [--p 17] [--batch 4]
    python examples/torch_quickstart.py --n 6000 --device cpu

Runs on the CUDA card unless ``--device cpu``; ``--backend cuda`` is the
hand-written kernels (the reference's ``pallas``), ``reference`` the
plain torch sweeps, ``auto`` the kernels on the card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import fmm_config
from repro_torch.core.direct import direct_potential, rel_error_inf
from repro_torch.data import particles
from repro_torch.device import resolve_device
from repro_torch.solver import FmmSolver


def _timed(fn, dev):
    """(fn(), host seconds ending when the device is done)."""
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0


def run(n: int = 100_000, p: int = 17, dist: str = "normal",
        backend: str = "auto", batch: int = 4, device=None,
        log=print) -> dict:
    """The reference quickstart's steps in f64. Returns its numbers: the
    default and tuned caps, the first and second apply's seconds, the
    512-point error, and (with ``batch`` > 0) the batched call's seconds,
    the batched caps and what ``apply_batched`` dispatched."""
    dev = resolve_device(device)
    z, q = particles(dist, n, seed=0, device=dev)
    cfg = fmm_config(n, p=p, dtype="f64")
    log(f"[quickstart] N={n} ({dist}), p={p}, levels={cfg.nlevels} "
        f"({4**cfg.nlevels} leaf boxes), on {dev}")

    # tune() fits the padded-list caps to this workload (overflow-free,
    # shrunk padding); build() caches the solver per config.
    solver = FmmSolver.build(cfg, backend, dev).tune(z, q)
    out = dict(default_caps=(cfg.strong_cap, cfg.weak_cap),
               caps=(solver.cfg.strong_cap, solver.cfg.weak_cap))
    log(f"[quickstart] tuned caps: strong={solver.cfg.strong_cap} "
        f"weak={solver.cfg.weak_cap} (from {cfg.strong_cap}/{cfg.weak_cap})")

    # on the card the first call at a shape runs eagerly and the second
    # captures its program (the reference's compile)
    phi, out["first_s"] = _timed(lambda: solver.apply(z, q), dev)
    phi, out["second_s"] = _timed(lambda: solver.apply(z, q), dev)
    log(f"[quickstart] fmm: {out['second_s'] * 1e3:.0f} ms/eval "
        f"(first call {out['first_s'] * 1e3:.0f} ms)")

    # spot-check 512 points against O(N^2) truth
    idx = np.random.default_rng(0).choice(n, 512, replace=False)
    idx = torch.from_numpy(idx).to(dev)
    ref = direct_potential(z[idx], z, q)
    out["err"] = err = rel_error_inf(phi[idx], ref)
    log(f"[quickstart] rel err vs direct (512-pt sample): {err:.2e}")
    if not err < 1e-4:
        raise AssertionError(f"accuracy regression: {err:.2e}")

    if batch > 0:
        # batched serving: B independent problems per call, one launch a
        # kernel for the whole batch on the "cuda" backend
        B = batch
        rest = [particles(dist, n, seed=s, device=dev) for s in range(1, B)]
        zb = torch.stack([z] + [r[0] for r in rest])
        qb = torch.stack([q] + [r[1] for r in rest])
        # the batch shares ONE cap budget: tune it on the (B, N) sample
        # (sized to the worst row), then serve with the batch-wide
        # overflow check — an overflowing member raises instead of
        # silently returning truncated potentials.
        solver = solver.tune(zb, qb, tiles=False)
        out["batched_caps"] = (solver.cfg.strong_cap, solver.cfg.weak_cap)
        solver.apply_batched_checked(zb, qb)
        phib, t_b = _timed(lambda: solver.apply_batched(zb, qb), dev)
        out.update(batched_s=t_b,
                   dispatched=solver.dispatched["apply_batched"])
        log(f"[quickstart] batched: {B} problems/call, "
            f"{t_b * 1e3:.0f} ms/call ({t_b / B * 1e3:.0f} ms/problem), "
            f"dispatched={out['dispatched']}")
        if not torch.allclose(phib[0], phi, rtol=1e-6, atol=1e-6):
            raise AssertionError("batched row 0 != apply")
    log("[quickstart] OK")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--p", type=int, default=17)
    ap.add_argument("--dist", default="normal",
                    choices=["uniform", "normal", "layer"])
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "reference", "cuda"])
    ap.add_argument("--batch", type=int, default=4,
                    help="problems per apply_batched call (0 skips the "
                         "batched-serving section)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(args.n, args.p, args.dist, args.backend, args.batch, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
