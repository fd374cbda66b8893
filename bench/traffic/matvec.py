"""Closed loop, one caller: the matvec of an iterative boundary-integral
solve. The positions never move, so the caller builds the plan once and
applies the operator to a new charge vector on each call, waiting for
phi, because the next Krylov vector depends on it (a GMRES iteration).

At set-up: one input of ``n`` particles of ``distribution`` made from
the seed, one ``FmmSolver.refresh`` (tree and connectivity, the only
ones), and a ``ring`` of real N(0, 1) charge vectors made from the seed,
all on the device. In the window: ``FmmSolver.apply_charges(plan, q)``
on the next ring vector, then a synchronize. The plan is the same object
on every call, so the program copies only the charges (``program``'s
held plan): the counter ``program.plan_bind`` must not rise in the
window.

Parameters (``params`` of the cell file): ``n``, ``distribution``,
``ring``, the list caps (``strong_cap``/``weak_cap``; default the
configuration's), the matvecs of the traced slice (``trace_iterations``)
and what the check samples (``check``: the last output of each ring
vector and ``matvecs`` more outputs drawn from the seed, each at
``targets`` targets drawn from the seed).

Readings: ``iterations`` (matvecs completed), ``window_s``,
``plan_binds`` (the rise of ``program.plan_bind`` over the window);
in a traced run also ``traced_work``, the plan's list occupancy for each
traced matvec.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from bench.metrics._work import bound_s, m2l
from bench.metrics._work_log import eval_fused_log
from bench.reference.direct import errors
from bench.reference.direct_log import direct_log
from bench.reference.inputs import particles_numpy
from repro_torch.solver import FmmSolver

from ._common import build_kernels, fmm_config, sample, sync, window_end
from .solve import list_work

#: Matvecs whose outputs the check draws come from the first
#: ``KEEP_FROM`` ring passes (the last output of every ring vector is
#: checked too).
KEEP_FROM = 4


def plan_binds() -> int | None:
    """The port's ``program.plan_bind`` counter (None without one)."""
    from repro_torch import trace
    return trace.snapshot()["counters"].get("program.plan_bind")


class Driver:
    def __init__(self, run):
        self.run = run
        p = run.params
        self.cfg = fmm_config(run.config, p["n"], p.get("strong_cap"),
                              p.get("weak_cap"))

    def _positions(self) -> np.ndarray:
        p = self.run.params
        return particles_numpy(p["distribution"], p["n"],
                               seed=[self.run.seed, 0])[0]

    def _charges(self, k: int) -> np.ndarray:
        """Ring vector ``k``: real N(0, 1) charges (float64)."""
        rng = np.random.default_rng([self.run.seed, 7, k])
        return rng.normal(size=self.run.params["n"])

    def setup(self, seconds: float) -> None:
        run, cfg = self.run, self.cfg
        dev = run.device
        if not hasattr(FmmSolver, "apply_charges"):
            raise RuntimeError(
                "this port has no FmmSolver.apply_charges: it cannot "
                "evaluate new charges on a plan it holds")
        build_kernels(dev)
        self.solver = FmmSolver.build(cfg, run.config["backend"], dev)
        z = torch.as_tensor(self._positions()).to(dev, cfg.torch_complex)
        self.charges = [torch.as_tensor(self._charges(k) + 0j).to(
            dev, cfg.torch_complex) for k in range(run.params["ring"])]
        self.plan = self.solver.refresh(z, self.charges[0])
        del z
        for k in range(3):           # eager, capture, replay
            self.solver.apply_charges(self.plan, self.charges[k])
        sync(dev)
        if run.trace:
            self.work = list_work(self.plan, cfg)
            print("roofline bounds: M2L "
                  f"{1e3 * bound_s(m2l(self.work), cfg.dtype):.4f} ms, fused "
                  "evaluation (log) "
                  f"{1e3 * bound_s(eval_fused_log(self.work), cfg.dtype):.4f}"
                  f" ms ({self.work})", file=sys.stderr, flush=True)

    def window(self, seconds: float, tracer) -> None:
        run, solver, plan = self.run, self.solver, self.plan
        ring = len(self.charges)
        keep = set(sample(run.seed, 1, KEEP_FROM * ring,
                          run.params["check"]["matvecs"]).tolist())
        self.kept, last = {}, {}
        binds0 = plan_binds()
        i = 0
        t0 = time.perf_counter()
        while True:
            k = i % ring
            tracer.before(i)
            with record_function("bench::matvec"):
                phi = solver.apply_charges(plan, self.charges[k])
            sync(run.device)
            if i in keep:
                self.kept[i] = (k, phi)
            last[k] = (i, phi)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        tracer.end()
        wall = time.perf_counter() - t0
        binds1 = plan_binds()
        for k, (j, phi) in last.items():
            self.kept[j] = (k, phi)
        run.readings.update(iterations=i, window_s=wall, failed=0,
                            plan_binds=(binds1 or 0) - (binds0 or 0))
        if run.trace:
            run.readings["traced_work"] = [self.work] * len(tracer.traced)
        window_end(run)

    def release(self) -> None:
        """Free the program's state: the solver's programs, the plan and
        the charges (the check makes its own)."""
        self.solver._release_executables()
        FmmSolver.cache_clear()
        del self.solver, self.plan, self.charges
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Each kept output's real part against the f64 direct log sum of
        its charges at ``targets`` targets drawn from the seed: the worst
        ``inf`` and ``rms`` errors (``bench.reference.direct.errors``).
        Real parts only: ``bench.reference.direct_log`` says why."""
        run = self.run
        z = torch.as_tensor(self._positions(), device=run.device)
        worst = {"inf": 0.0, "rms": 0.0}
        for i, (k, phi) in sorted(self.kept.items()):
            q = torch.as_tensor(self._charges(k), device=run.device)
            idx = torch.as_tensor(sample(run.seed, 2 + i, z.numel(),
                                         run.params["check"]["targets"]),
                                  device=run.device)
            e = errors(phi[idx].real, direct_log(z[idx], z, q))
            worst = {key: max(worst[key], e[key]) for key in worst}
        return {f"re_phi_err_{key}": v for key, v in worst.items()}
