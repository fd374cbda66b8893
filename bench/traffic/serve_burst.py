"""Open loop in synchronised waves: the serving cell's requests
(``serve``: the same sizes, poisons and plane, in the order the seed
gives), due in bursts instead of as a Poisson process. Callers that
submit together, such as time-stepping clients at the top of each step,
send such traffic.

Due times (``burst_schedule``): the window is cut into periods of
``period`` seconds from an offset drawn from the seed in [0, period);
each period opens with a burst of ``burst_duty`` of its length at
``burst_factor`` times the mean ``rate``, then runs at the rate that
keeps the period's mean at ``rate``. Each phase holds a fixed count of
requests, due at uniform times inside it, and a time past the window's
end wraps to its start, so that every run holds the same number of
bursts of the same shape. Everything else is ``serve``'s driver.

Parameters: ``serve``'s, and ``period``, ``burst_duty``,
``burst_factor``.
"""
from __future__ import annotations

import numpy as np

from . import serve


def burst_schedule(seed: int, seconds: float, rate: float, period: float,
                   burst_duty: float, burst_factor: float) -> np.ndarray:
    """Sorted due times (seconds) in ``[0, seconds)``: ``round(seconds /
    period)`` periods, each ``round(rate * period * burst_duty *
    burst_factor)`` requests in its burst and the rest of ``round(rate *
    period)`` after it, from ``(seed, 9)``."""
    periods = max(1, round(seconds / period))
    per = round(rate * period)
    burst = min(per, round(rate * period * burst_duty * burst_factor))
    rng = np.random.default_rng([seed, 9])
    offset = rng.uniform(0.0, period)
    starts = offset + period * np.arange(periods)[:, None]
    split = burst_duty * period
    due = np.concatenate([
        (starts + rng.uniform(0.0, split, (periods, burst))).ravel(),
        (starts + rng.uniform(split, period, (periods, per - burst))).ravel()])
    return np.sort(np.mod(due, periods * period))


class Driver(serve.Driver):
    def reseed(self, seed: int, seconds: float) -> None:
        """The window's stream for ``seed``: ``serve``'s requests, due on
        the burst schedule."""
        p = self.run.params
        self.run.seed = seed
        due = burst_schedule(seed, seconds, p["rate"], p["period"],
                             p["burst_duty"], p["burst_factor"])
        _, self.reqs = self._stream(len(due), seconds, seed)
        self.due = due
