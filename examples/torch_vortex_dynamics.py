"""2D point-vortex dynamics with FMM velocity evaluation on the PyTorch
port — the twin of ``examples/vortex_dynamics.py``, the application the
paper's code was built for (vortex methods).

Each RK2 step evaluates the induced velocity field

    u - i v = (1 / 2*pi*i) * sum_j G_j / (z - z_j)

with the adaptive FMM, advects the vortices, and tracks the linear
impulse sum G_j z_j, which point-vortex dynamics conserves exactly, so
its drift measures the integration and FMM error.

    python examples/torch_vortex_dynamics.py --n 20000 --steps 20
    python examples/torch_vortex_dynamics.py --n 3000 --steps 6 --device cpu

Runs on the CUDA card unless ``--device cpu``. As in the reference the
run is f32 (``fmm_config``'s default): positions and strengths are held
in the config's complex dtype from the start, so the integration is f32
too.
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np
import torch

from repro_torch.configs import fmm_config
from repro_torch.device import resolve_device
from repro_torch.solver import FmmSolver


def velocity(z, gamma, guard):
    """u + iv at each vortex (harmonic-kernel FMM, Biot-Savart in 2D).

    Splits the evaluation at the topology/evaluation seam
    (``refresh_guarded`` + ``apply_plan``): the guarded refresh reads
    the plan's cap margins (one host read, no extra build) and, when
    advection drifts the layout past the tuned caps, re-plans at
    escalated caps instead of dropping interactions. Returns
    ``(velocity, GuardReport)``."""
    plan, report = guard.refresh_guarded(z, gamma.to(z.dtype))
    phi = guard.apply_plan(plan)
    # phi_i = sum_j G_j/(z_j - z_i);  u - iv = phi/(2 pi i) -> conj.
    # conj_physical: a lazy conj view would reach readers of the raw
    # storage unresolved.
    return torch.conj_physical(phi / (2j * math.pi)), report


def vortex_pair(n: int):
    """Two counter-rotating Gaussian clusters (a translating vortex pair)
    from ``default_rng(0)``, as the reference draws them: positions
    (complex128) and strengths (float64, circulation +1 and -1)."""
    rng = np.random.default_rng(0)
    n2 = n // 2
    z0 = np.concatenate([
        0.35 + 0.5j + 0.08 * (rng.normal(size=n2) + 1j * rng.normal(size=n2)),
        0.65 + 0.5j + 0.08 * (rng.normal(size=n - n2)
                              + 1j * rng.normal(size=n - n2)),
    ])
    gamma = np.concatenate([np.full(n2, 1.0 / n2),
                            np.full(n - n2, -1.0 / (n - n2))])
    return z0, gamma


def rk2_step(z, g, guard, dt: float):
    """One midpoint step: ``(z_next, (report_1, report_2))``."""
    u1, rep1 = velocity(z, g, guard)
    zm = z + 0.5 * dt * u1
    u2, rep2 = velocity(zm, g, guard)
    return z + dt * u2, (rep1, rep2)


def impulse(gamma: np.ndarray, z) -> complex:
    """sum_j G_j z_j on the host, in f64."""
    return complex(np.sum(gamma * z.cpu().numpy()))


def setup(n: int, p: int = 12, device=None):
    """The reference's initial state on ``device``: ``(z, g, guard, z0,
    gamma)`` with ``z``/``g`` in the config's complex dtype and the guard
    tuned on the initial layout with head-room (margin 1.5) for the
    advected positions."""
    dev = resolve_device(device)
    z0, gamma = vortex_pair(n)
    cfg = fmm_config(n, p=p)
    z = torch.from_numpy(z0).to(dev, cfg.torch_complex)
    g = torch.from_numpy(gamma + 0j).to(dev, cfg.torch_complex)
    solver = FmmSolver.build(cfg, "auto", dev).tune(z, g, margin=1.5)
    # guarded refresh: cap drift re-plans through the escalation lattice
    # instead of aborting
    guard = solver.guarded(max_cap_doublings=3)
    return z, g, guard, z0, gamma


def run(n: int = 20_000, steps: int = 20, dt: float = 2e-4, p: int = 12,
        device=None, log=print) -> dict:
    """The reference's time-stepping loop. Returns its numbers: the
    tuned and final caps, re-plans, every step's guard reports, the
    impulse drifts (every 5 steps and the last), the final cluster
    separation, seconds a step and the final positions."""
    z, g, guard, z0, gamma = setup(n, p, device)
    tuned = (guard.cfg.strong_cap, guard.cfg.weak_cap)
    log(f"[vortex] N={n} vortices, {steps} RK2 steps, p={p}, "
        f"levels={guard.cfg.nlevels}, caps={tuned[0]}/{tuned[1]}, "
        f"{z.dtype} on {z.device}")
    imp0 = complex(np.sum(gamma * z0))
    t0 = time.perf_counter()
    replans, reports, drifts = 0, [], {}
    for s in range(steps):
        z, (rep1, rep2) = rk2_step(z, g, guard, dt)
        reports += [rep1, rep2]
        replans += rep1.retries + rep2.retries
        if rep1.retries or rep2.retries:
            log(f"[vortex] step {s:3d}  re-planned: "
                f"{(rep2 if rep2.retries else rep1).summary()}  "
                f"caps now {guard.cfg.strong_cap}/{guard.cfg.weak_cap}")
        if s % 5 == 0 or s == steps - 1:
            drifts[s] = abs(impulse(gamma, z) - imp0) / max(abs(imp0), 1e-12)
            log(f"[vortex] step {s:3d}  impulse drift {drifts[s]:.2e}  "
                f"replans {replans}  "
                f"({(time.perf_counter() - t0) / (s + 1):.2f} s/step avg)")
    secs = (time.perf_counter() - t0) / max(steps, 1)
    if not (guard.trace_counts["build"] == 1 or replans > 0):
        raise AssertionError("refresh re-prepared mid-run without a cap "
                             "re-plan")
    zn = z.cpu().numpy()
    sep = abs(np.mean(zn[:n // 2]) - np.mean(zn[n // 2:]))
    log(f"[vortex] final cluster separation {sep:.3f} (pair translates, "
        f"separation ~const)")
    drift = abs(impulse(gamma, z) - imp0) / max(abs(imp0), 1e-12)
    if not drift < 1e-2:
        raise AssertionError(f"impulse drift {drift} too large")
    log("[vortex] OK — invariants preserved")
    return dict(tuned_caps=tuned,
                caps=(guard.cfg.strong_cap, guard.cfg.weak_cap),
                replans=replans, reports=reports, drifts=drifts,
                drift=drift, separation=sep, s_per_step=secs, z=z,
                trace_counts=dict(guard.trace_counts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--dt", type=float, default=2e-4)
    ap.add_argument("--p", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    run(args.n, args.steps, args.dt, args.p, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
