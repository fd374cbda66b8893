"""Closed loop, one caller: RK2 time steps of 2D point-vortex dynamics,
the paper's own user (a vortex-method code waits for each step).

Each half-step evaluates the induced velocity with the FMM split at the
topology/evaluation seam, ``GuardedSolver.refresh_guarded`` (which
re-plans at escalated caps when the advected layout overflows them) and
``apply_plan``; the step's caller code is a copy of
``examples/torch_vortex_dynamics.py``'s. The state (the positions) is
carried from step to step.

Parameters: ``n`` vortices of the vortex pair (drawn once, as the
example draws it, and put in an order drawn from the seed: the seed
changes the order, not the work; tuned caps follow the draw), the
step ``dt``, the caps' head-room ``tune_margin`` (``FmmSolver.tune`` on
the initial layout at set-up), ``max_cap_doublings`` of the guard,
``warm_steps`` taken at set-up and discarded, the steps of the traced
slice (``trace_iterations``), and what the check samples (``check``:
``steps`` steps of the window, the last included, each half-step's
velocity at ``targets`` targets).

Readings: ``iterations`` (steps), ``window_s``, ``replans`` (guard
re-plans in the window), ``failed`` (steps with a guard report not ok on
"cuda"); in a traced run ``refresh_s`` and ``apply_plan_s``, the host
clock around each ``refresh_guarded`` and each ``apply_plan`` (ending in
a synchronize) outside the traced slice.
"""
from __future__ import annotations

import math
import time

import torch
from torch.profiler import record_function

from bench.reference.direct import direct_sum, errors, velocity
from bench.reference.inputs import vortex_pair_permuted
from repro_torch.solver import FmmSolver

from ._common import build_kernels, fmm_config, sample, sync, window_end

#: Steps whose state the check may sample come from the first KEEP_FROM
#: steps of the window (the last step is always checked).
KEEP_FROM = 16


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfg = fmm_config(run.config, run.params["n"])
        self._timed = None

    def _velocity(self, z):
        """u + iv at each vortex: ``(velocity, GuardReport)``."""
        guard, dev = self.guard, self.run.device
        if self._timed is None:
            plan, report = guard.refresh_guarded(z, self.g)
            phi = guard.apply_plan(plan)
        else:
            t0 = time.perf_counter()
            plan, report = guard.refresh_guarded(z, self.g)
            t1 = time.perf_counter()
            phi = guard.apply_plan(plan)
            sync(dev)
            t2 = time.perf_counter()
            self._timed["refresh_s"].append(t1 - t0)
            self._timed["apply_plan_s"].append(t2 - t1)
        # phi_i = sum_j G_j/(z_j - z_i);  u - iv = phi/(2 pi i) -> conj.
        return torch.conj_physical(phi / (2j * math.pi)), report

    def _step(self, z):
        """One midpoint step: ``(z_next, u1, zm, u2, reports)``."""
        dt = self.run.params["dt"]
        u1, rep1 = self._velocity(z)
        zm = z + 0.5 * dt * u1
        u2, rep2 = self._velocity(zm)
        return z + dt * u2, u1, zm, u2, (rep1, rep2)

    def setup(self, seconds: float) -> None:
        run, cfg, p = self.run, self.cfg, self.run.params
        dev = run.device
        build_kernels(dev)
        z0, gamma = vortex_pair_permuted(p["n"], run.seed)
        self.z0 = torch.as_tensor(z0).to(dev, cfg.torch_complex)
        self.g = torch.as_tensor(gamma + 0j).to(dev, cfg.torch_complex)
        solver = FmmSolver.build(cfg, run.config["backend"], dev).tune(
            self.z0, self.g, margin=p["tune_margin"])
        self.guard = solver.guarded(max_cap_doublings=p["max_cap_doublings"])
        z = self.z0
        for _ in range(p["warm_steps"]):
            z = self._step(z)[0]
        sync(dev)
        self.caps = (self.guard.cfg.strong_cap, self.guard.cfg.weak_cap)

    def window(self, seconds: float, tracer) -> None:
        run = self.run
        keep = set(sample(run.seed, 1, KEEP_FROM,
                          run.params["check"]["steps"] - 1).tolist())
        self.kept = {}
        timed = {"refresh_s": [], "apply_plan_s": []}
        replans = failed = 0
        z = self.z0
        i = 0
        t0 = time.perf_counter()
        while True:
            tracer.before(i)
            self._timed = timed if run.trace and not tracer.active else None
            with record_function("bench::step"):
                z_next, u1, zm, u2, reports = self._step(z)
            sync(run.device)
            replans += sum(r.retries for r in reports)
            failed += not all(r.ok and r.final_backend == "cuda"
                              and not r.degradations for r in reports)
            if i in keep:
                self.kept[i] = (z, u1, zm, u2, z_next)
            last = (i, (z, u1, zm, u2, z_next))
            z = z_next
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        tracer.end()
        wall = time.perf_counter() - t0
        self._timed = None
        self.kept[last[0]] = last[1]
        run.readings.update(iterations=i, window_s=wall, replans=replans,
                            failed=failed, caps=list(self.caps))
        if run.trace:
            run.readings.update(timed)
        window_end(run)

    def release(self) -> None:
        self.guard.solver._release_executables()
        FmmSolver.cache_clear()
        del self.guard
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The start state against the pair drawn again from the seed
        (exact); each kept half-step's velocity, at ``targets`` targets,
        against the f64 direct sum on the state the program carried
        (worst ``inf`` and ``rms``); and each kept advance (``zm = z +
        dt/2 u1``, ``z_next = z + dt u2``) recomputed in f64 from the
        program's own values, as its largest gap over the largest
        increment."""
        run, p = self.run, self.run.params
        dev = run.device
        z0, gamma = vortex_pair_permuted(p["n"], run.seed)
        want0 = torch.as_tensor(z0).to(dev, self.cfg.torch_complex)
        start = float((self.z0 - want0).abs().max())
        g = torch.as_tensor(gamma + 0j, device=dev)
        worst = {"inf": 0.0, "rms": 0.0}
        state = 0.0
        for i, (z, u1, zm, u2, z_next) in sorted(self.kept.items()):
            idx = torch.as_tensor(sample(run.seed, 2 + i, p["n"],
                                         p["check"]["targets"]), device=dev)
            for at, u in ((z, u1), (zm, u2)):
                a = at.to(torch.complex128)
                ref = velocity(direct_sum(a[idx], a, g))
                got = (velocity(direct_sum(a[idx], a, g,
                                           dtype=torch.bfloat16))
                       if run.control == "bf16" else u[idx])
                e = errors(got, ref)
                worst = {k: max(worst[k], e[k]) for k in worst}
            for frm, inc, to in ((z, 0.5 * p["dt"] * u1.to(torch.complex128),
                                  zm),
                                 (z, p["dt"] * u2.to(torch.complex128),
                                  z_next)):
                gap = (to.to(torch.complex128)
                       - (frm.to(torch.complex128) + inc)).abs().max()
                state = max(state, float(gap / inc.abs().max()))
        return {"start_diff": start, "vel_err_inf": worst["inf"],
                "vel_err_rms": worst["rms"], "state_err": state}
