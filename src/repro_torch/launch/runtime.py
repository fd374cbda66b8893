"""Runtime pieces shared by long-running loops: straggler monitoring,
failure injection, and the generic fault-tolerant step loop.

The twin of ``repro.launch.runtime``. ``train_loop`` drives any step
function over any state (a time-stepping run's particle positions, a
model's parameters) with asynchronous checkpoints
(``repro_torch.checkpoint.CheckpointManager``); a run stopped by a
failure resumes from the latest checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np


class StragglerMonitor:
    """Per-step wall-time tracker.

    At cluster scale the same median logic runs per worker and feeds the
    coordinator's slow-node eviction; here it records slow steps (warm-up
    steps are excluded) so stalls are visible.

    The FMM serving plane (``repro_torch.serve.plane.ServePlane``) wires
    one of these around every guarded batched dispatch as its
    slow-request detector: a dispatch beyond ``threshold``x the rolling
    median flags ``slow=True`` on every ``ServeReport`` in that batch
    (drilled by the ``latency_spike`` injector in
    ``repro_torch.testing.serve_faults``).
    """

    def __init__(self, window: int = 50, threshold: float = 2.5,
                 warmup: int = 2):
        self.times: deque[float] = deque(maxlen=window)
        self.threshold = threshold
        self.warmup = warmup
        self.slow_steps: list[tuple[int, float]] = []
        self._seen = 0

    def record(self, step: int, dt: float) -> bool:
        """Record one step's seconds; True when it is a straggler (more
        than ``threshold`` times the median of at least 5 earlier
        steps, after the first ``warmup`` steps)."""
        self._seen += 1
        if self._seen <= self.warmup:
            return False
        slow = False
        if len(self.times) >= 5:
            med = float(np.median(self.times))
            if dt > self.threshold * med:
                self.slow_steps.append((step, dt))
                slow = True
        self.times.append(dt)
        return slow

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else float("nan")


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for fault-tolerance tests: raises at
    the given steps (simulating a lost worker) exactly once each."""

    fail_at: tuple[int, ...] = ()
    _done: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at and step not in self._done:
            self._done.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


def train_loop(step_fn: Callable, state, batch_fn: Callable, *,
               start_step: int, num_steps: int,
               ckpt_manager=None, ckpt_every: int = 0,
               monitor: StragglerMonitor | None = None,
               failure: FailureInjector | None = None,
               log_every: int = 10, log_fn=print) -> tuple[Any, dict]:
    """Generic loop: ``state, metrics = step_fn(state, batch, step)``.
    Returns (state, summary). Checkpoints asynchronously every
    ``ckpt_every`` steps (as step ``step + 1``). ``float(metrics["loss"])``
    waits for the step's device work, so a step's time is its device
    time."""
    monitor = monitor or StragglerMonitor()
    losses = []
    step = start_step
    for step in range(start_step, num_steps):
        if failure is not None:
            failure.check(step)
        batch = batch_fn(step)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch, step)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        slow = monitor.record(step, dt)
        losses.append(loss)
        if log_every and step % log_every == 0:
            log_fn(f"step {step:5d} loss {loss:8.4f} "
                   f"dt {dt*1e3:8.1f}ms{'  [SLOW]' if slow else ''}")
        if ckpt_manager is not None and ckpt_every and \
                (step + 1) % ckpt_every == 0:
            ckpt_manager.save(step + 1, state)
    if ckpt_manager is not None:
        ckpt_manager.wait()
    return state, {
        "last_step": step,
        "losses": losses,
        "median_step_time": monitor.median,
        "slow_steps": monitor.slow_steps,
    }
