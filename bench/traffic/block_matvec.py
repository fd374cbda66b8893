"""Closed loop, one caller: the block matvec of a 2D multiconductor
capacitance solve. The cross-section's boundary nodes never move, so the
caller builds the plan once; block GMRES then applies the log-potential
operator to a block of K densities (one a conductor's right-hand side)
on each call, waiting for the K answers, because the next block of
Krylov vectors depends on them.

At set-up: ``n`` boundary nodes on the eight wire contours made from the
seed (``bench/reference/wires.py``), one ``FmmSolver.refresh`` (tree and
connectivity, the only ones), and a ``ring`` of blocks of K real
N(0, 1) densities made from the seed (K the configuration's
``densities``), all on the device. In the window:
``FmmSolver.apply_charges(plan, Q)`` with Q of shape (K, n), the next
ring block, then a synchronize. The plan is the same object on every
call, so the program copies only the densities: the counter
``program.plan_bind`` must not rise in the window.

Parameters (``params`` of the cell file): ``n``, ``ring``, the list caps
(``strong_cap``/``weak_cap``; default the configuration's), the calls of
the traced slice (``trace_iterations``) and what the check samples
(``check``: the last output of each ring block and ``blocks`` more
outputs drawn from the seed, each at ``targets`` targets drawn from the
seed, every density of it).

Readings: ``iterations`` (block matvecs completed), ``window_s``,
``plan_binds`` (the rise of ``program.plan_bind`` over the window),
``densities`` (the rise of the port's ``fmm.densities`` over the window:
the densities the calls evaluated); in a traced run also
``traced_work``, the plan's list occupancy and K for each traced call.

A port whose ``apply_charges`` takes no (K, n) block fails at set-up,
at its first call, with its own error.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from bench.metrics._work import bound_s
from bench.metrics._work_block import (eval_block, m2l_block, p2l_block,
                                       upward_block)
from bench.reference.direct import errors
from bench.reference.direct_log import direct_log
from bench.reference.wires import wire_nodes
from repro_torch.solver import FmmSolver

from ._common import build_kernels, fmm_config, sample, sync, window_end
from .matvec import plan_binds
from .solve import list_work

#: Calls whose outputs the check draws come from the first ``KEEP_FROM``
#: ring passes (the last output of every ring block is checked too).
KEEP_FROM = 4


def densities_counted() -> int | None:
    """The port's ``fmm.densities`` counter (None without one)."""
    from repro_torch import trace
    return trace.snapshot()["counters"].get("fmm.densities")


def block_work(plan, cfg, K: int) -> dict:
    """``solve.list_work`` of a one-problem plan, with the occupied P2L
    entries, the G kernel and the K densities a call evaluates on it."""
    work = list_work(plan, cfg)
    work.update(p2l=int((plan.conn.p2l >= 0).sum()) if cfg.use_p2l_m2p
                else 0, densities=K, kernel=cfg.kernel)
    return work


class Driver:
    def __init__(self, run):
        self.run = run
        p = run.params
        self.cfg = fmm_config(run.config, p["n"], p.get("strong_cap"),
                              p.get("weak_cap"))
        self.K = run.config["densities"]

    def _positions(self) -> np.ndarray:
        return wire_nodes(self.run.params["n"], seed=[self.run.seed, 0])[0]

    def _block(self, k: int) -> np.ndarray:
        """Ring block ``k``: K real N(0, 1) densities (float64, (K, n))."""
        rng = np.random.default_rng([self.run.seed, 7, k])
        return rng.normal(size=(self.K, self.run.params["n"]))

    def setup(self, seconds: float) -> None:
        run, cfg = self.run, self.cfg
        dev = run.device
        build_kernels(dev)
        self.solver = FmmSolver.build(cfg, run.config["backend"], dev)
        z = torch.as_tensor(self._positions()).to(dev, cfg.torch_complex)
        self.blocks = [torch.as_tensor(self._block(k) + 0j).to(
            dev, cfg.torch_complex) for k in range(run.params["ring"])]
        self.plan = self.solver.refresh(z, self.blocks[0][0])
        del z
        for k in range(3):           # eager, capture, replay
            self.solver.apply_charges(self.plan, self.blocks[k % len(
                self.blocks)])
        sync(dev)
        if run.trace:
            self.work = block_work(self.plan, cfg, self.K)
            bounds = {name: 1e3 * bound_s(count(self.work), cfg.dtype)
                      for name, count in (("eval", eval_block),
                                          ("m2l", m2l_block),
                                          ("p2l", p2l_block),
                                          ("upward", upward_block))}
            print(f"roofline bounds (ms, K = {self.K}): {bounds} "
                  f"({self.work})", file=sys.stderr, flush=True)

    def window(self, seconds: float, tracer) -> None:
        run, solver, plan = self.run, self.solver, self.plan
        ring = len(self.blocks)
        keep = set(sample(run.seed, 1, KEEP_FROM * ring,
                          run.params["check"]["blocks"]).tolist())
        self.kept, last = {}, {}
        binds0, dens0 = plan_binds(), densities_counted()
        i = 0
        t0 = time.perf_counter()
        while True:
            k = i % ring
            tracer.before(i)
            with record_function("bench::block_matvec"):
                phi = solver.apply_charges(plan, self.blocks[k])
            sync(run.device)
            if i in keep:
                self.kept[i] = (k, phi)
            last[k] = (i, phi)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        tracer.end()
        wall = time.perf_counter() - t0
        binds1, dens1 = plan_binds(), densities_counted()
        for k, (j, phi) in last.items():
            self.kept[j] = (k, phi)
        run.readings.update(iterations=i, window_s=wall, failed=0,
                            plan_binds=(binds1 or 0) - (binds0 or 0))
        if dens1 is not None:
            run.readings["densities"] = dens1 - (dens0 or 0)
        if run.trace:
            run.readings["traced_work"] = [self.work] * len(tracer.traced)
        window_end(run)

    def release(self) -> None:
        """Free the program's state: the solver's programs, the plan and
        the blocks (the check makes its own)."""
        self.solver._release_executables()
        FmmSolver.cache_clear()
        del self.solver, self.plan, self.blocks
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Each kept output's real part, every density of it, against the
        f64 direct log sum of that density at ``targets`` targets drawn
        from the seed: the worst ``inf`` and ``rms`` errors over all of
        them (``bench.reference.direct.errors``). Real parts only:
        ``bench.reference.direct_log`` says why."""
        run = self.run
        z = torch.as_tensor(self._positions(), device=run.device)
        worst = {"inf": 0.0, "rms": 0.0}
        for i, (k, phi) in sorted(self.kept.items()):
            Q = torch.as_tensor(self._block(k), device=run.device)
            idx = torch.as_tensor(sample(run.seed, 2 + i, z.numel(),
                                         run.params["check"]["targets"]),
                                  device=run.device)
            if phi.shape != Q.shape:
                return {"re_phi_err_inf": float("inf"),
                        "re_phi_err_rms": float("inf")}
            for d in range(Q.shape[0]):
                e = errors(phi[d, idx].real, direct_log(z[idx], z, Q[d]))
                worst = {key: max(worst[key], e[key]) for key in worst}
        return {f"re_phi_err_{key}": v for key, v in worst.items()}
