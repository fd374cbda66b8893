"""Runtime pieces shared by long-running loops: straggler monitoring.

The twin of ``repro.launch.runtime.StragglerMonitor``; the reference's
failure injector and fault-tolerant step loop are not ported yet.
"""
from __future__ import annotations

from collections import deque

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
