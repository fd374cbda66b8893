"""Closed loop, one caller: ``FmmSolver.apply`` on the next input of a
ring, waiting for phi after each call (a caller that needs each answer
before going on: an N-body or boundary-integral code).

Parameters (``params`` of the cell file): ``n`` particles, their
``distribution`` ("uniform", "normal", "layer"), a ``ring`` of that many
inputs made from the seed at set-up so that no two consecutive calls see
the same input, the list caps ``strong_cap``/``weak_cap``, the solves the
traced slice covers (``trace_iterations``), and what the check samples
(``check``: the last output of each ring input and ``solves`` more
outputs drawn from the seed, each at ``targets`` targets drawn from the
seed).

Readings: ``iterations`` (solves completed) and ``window_s``; in a traced
run also ``traced_work``, the list occupancy of each traced solve's input
(read at set-up from ``FmmSolver.plan`` on a solver of its own).
"""
from __future__ import annotations

import sys
import time

import torch
from torch.profiler import record_function

from bench.metrics._work import bound_s, eval_fused, m2l
from bench.reference.direct import direct_sum, errors
from bench.reference.inputs import particles_numpy
from repro_torch.kernels import fused_levels
from repro_torch.solver import FmmSolver

from ._common import build_kernels, fmm_config, sample, sync, window_end

#: Solves whose outputs the check draws come from the first ``KEEP_FROM``
#: ring passes (the last output of every ring input is checked too).
KEEP_FROM = 4


def list_work(plan, cfg) -> dict:
    """Occupied entries of a B = 1 plan's lists that the M2L and fused
    evaluation kernels read, with the sizes their byte counts need."""
    conn = plan.conn
    return {"weak": int(sum(int((conn.weak[l] >= 0).sum())
                            for l in fused_levels(cfg))),
            "p2p": int((conn.p2p >= 0).sum()),
            "m2p": int((conn.m2p >= 0).sum()) if cfg.use_p2l_m2p else 0,
            "n": cfg.n, "nlevels": cfg.nlevels, "p": cfg.p,
            "strong_cap": cfg.strong_cap, "weak_cap": cfg.weak_cap,
            "dtype": cfg.dtype, "m2p_lists": cfg.use_p2l_m2p}


class Driver:
    def __init__(self, run):
        self.run = run
        p = run.params
        self.cfg = fmm_config(run.config, p["n"], p.get("strong_cap"),
                              p.get("weak_cap"))

    def _input(self, k: int):
        """Ring input ``k`` as the benchmark makes it (float64 numpy)."""
        p = self.run.params
        return particles_numpy(p["distribution"], p["n"],
                               seed=[self.run.seed, k])

    def setup(self, seconds: float) -> None:
        run, cfg = self.run, self.cfg
        dev = run.device
        build_kernels(dev)
        self.solver = FmmSolver.build(cfg, run.config["backend"], dev)
        self.inputs = [tuple(torch.as_tensor(a).to(dev, cfg.torch_complex)
                             for a in self._input(k))
                       for k in range(run.params["ring"])]
        for k in range(3):           # eager, capture, replay
            self.solver.apply(*self.inputs[k % len(self.inputs)])
        sync(dev)
        if run.trace:
            counter = FmmSolver(cfg, run.config["backend"], dev)
            self.work = []
            for z, q in self.inputs:
                self.work.append(list_work(counter.plan(z, q), cfg))
                counter._release_executables()
            del counter
            first = self.work[0]
            print("roofline bounds of ring input 0: M2L "
                  f"{1e3 * bound_s(m2l(first), cfg.dtype):.4f} ms, fused "
                  f"evaluation {1e3 * bound_s(eval_fused(first), cfg.dtype):.4f}"
                  f" ms ({first})", file=sys.stderr, flush=True)

    def window(self, seconds: float, tracer) -> None:
        run = self.run
        ring = len(self.inputs)
        keep = set(sample(run.seed, 1, KEEP_FROM * ring,
                          run.params["check"]["solves"]).tolist())
        self.kept, last = {}, {}
        i = 0
        t0 = time.perf_counter()
        while True:
            k = i % ring
            tracer.before(i)
            with record_function("bench::apply"):
                phi = self.solver.apply(*self.inputs[k])
            sync(run.device)
            if i in keep:
                self.kept[i] = (k, phi)
            last[k] = (i, phi)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        tracer.end()
        wall = time.perf_counter() - t0
        for k, (j, phi) in last.items():
            self.kept[j] = (k, phi)
        run.readings.update(iterations=i, window_s=wall, failed=0)
        if run.trace:
            run.readings["traced_work"] = [self.work[j % ring]
                                           for j in tracer.traced]
        window_end(run)

    def release(self) -> None:
        """Free the program's state: the solver's programs and the
        benchmark's device inputs (the check makes its own)."""
        self.solver._release_executables()
        FmmSolver.cache_clear()
        del self.solver, self.inputs
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Each kept output against the f64 direct sum of its input at
        ``targets`` targets drawn from the seed: the worst ``inf`` and
        ``rms`` errors (``bench.reference.direct.errors``)."""
        run = self.run
        worst = {"inf": 0.0, "rms": 0.0}
        for i, (k, phi) in sorted(self.kept.items()):
            z, q = (torch.as_tensor(a, device=run.device)
                    for a in self._input(k))
            idx = torch.as_tensor(sample(run.seed, 2 + i, z.numel(),
                                         run.params["check"]["targets"]),
                                  device=run.device)
            ref = direct_sum(z[idx], z, q)
            got = (direct_sum(z[idx], z, q, dtype=torch.bfloat16)
                   if run.control == "bf16" else phi[idx])
            e = errors(got, ref)
            worst = {key: max(worst[key], e[key]) for key in worst}
        return {f"phi_err_{key}": v for key, v in worst.items()}
