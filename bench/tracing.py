"""The traced slice of a window: ``torch.profiler`` over its first
iterations, reduced to what the per-layer metrics read.

A traced run (``--trace 1``) profiles a bounded number of iterations at
the end of its window (``trace_iterations`` in the cell file), so that
the trace stays a few hundred thousand events whatever the window's
length, and stops the profiler (which takes seconds) only once the
window has closed; the rest of the window runs untraced, and the
host-clock readings and counters of a traced run are taken there. The
slice starts at the first iteration from which, at the window's mean
pace so far, that many iterations would fill the rest of the window. It
is one ``bench::traced`` range; the digest reads, inside it,

* ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy, set) ran, and ``window_s``, the range's length;
* the device time and count of each device operation by name (over the
  whole profile, which runs from the slice's first iteration to the
  window's close);
* the longest idle gaps of the device, each named by what the host was
  doing at its middle (the outermost ``bench::`` range and the innermost
  host operation there).
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Optional

import torch

SPAN = "bench::traced"
TOP = 10
NAME_CHARS = 160


def _on_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


@dataclasses.dataclass
class Digest:
    window_s: float
    busy_s: float
    ops: dict          # name -> [count, seconds]
    gaps: list         # [label, seconds], longest first

    def kernel(self, part: str) -> tuple[int, float]:
        """(count, seconds) of the device operations whose name holds
        ``part``."""
        hits = [v for k, v in self.ops.items() if part in k]
        return sum(c for c, _ in hits), sum(s for _, s in hits)

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:TOP]
        return {"device_ops": [[k[:NAME_CHARS], s] for k, (_, s) in top],
                "idle_gaps": [[g, s] for g, s in self.gaps[:TOP]]}


def digest(events) -> Optional[Digest]:
    """The digest of a profile's events (None without the slice's range
    or without any device operation in it)."""
    spans = [e for e in events if e.name == SPAN and not _on_device(e)]
    if not spans:
        return None
    t0, t1 = spans[0].time_range.start, spans[0].time_range.end
    host = [e for e in events if not _on_device(e)]
    # a record_function range is mirrored on the device's timeline as an
    # annotation, under its own name: not an operation
    ranges = {e.name for e in host}
    work = [e for e in events if _on_device(e) and e.name not in ranges
            and not getattr(e, "is_user_annotation", False)]
    # operations by name over the whole profile: it holds the slice's
    # iterations and nothing else of the program, and the device's clock,
    # mapped onto the host's, can put the last kernels a few us past the
    # range
    ops: dict = {}
    for e in work:
        rec = ops.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += (e.time_range.end - e.time_range.start) * 1e-6
    dev = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1),
                  e.name) for e in work
                 if e.time_range.end > t0 and e.time_range.start < t1)
    if not dev:
        return None
    union, busy = [], 0.0
    for a, b, _ in dev:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    busy = sum(b - a for a, b in union)
    edges = [t0] + [x for ab in union for x in ab] + [t1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in host if e.name != SPAN)
    starts = [h[0] for h in host]
    labelled = []
    for length, a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [h for h in host[:bisect.bisect_right(starts, mid)]
                  if h[1] >= mid]
        outer = next((h[2] for h in inside if h[2].startswith("bench::")),
                     None)
        inner = inside[-1][2] if inside else "no host range"
        label = inner if outer in (None, inner) else f"{outer} > {inner}"
        labelled.append([label[:NAME_CHARS], length * 1e-6])
    return Digest(window_s=(t1 - t0) * 1e-6, busy_s=busy * 1e-6, ops=ops,
                  gaps=labelled)


class Tracer:
    """Profiles the last ``iterations`` iterations of a window of
    ``seconds`` when ``enabled``; a no-op otherwise. A driver calls
    ``before(i)`` before iteration ``i`` (``i`` counts from 0) and
    ``end()`` when its last iteration has returned, the harness
    ``finish()`` once the window has closed; ``traced`` lists
    the iterations inside the slice, and ``active`` is true from the
    slice's first iteration on."""

    def __init__(self, enabled: bool, iterations: int, device,
                 seconds: float = 0.0):
        self.enabled = enabled and iterations > 0
        self.iterations = iterations
        self.seconds = seconds
        self.device = torch.device(device)
        self.traced: list[int] = []
        self._prof = self._range = None
        self._t0 = None

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop the profiler once (at set-up), so that the
        slice does not pay its first start."""
        if not self.enabled:
            return
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.zeros(1, device=self.device).add_(1)
            self._sync()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def before(self, i: int) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        elapsed = now - self._t0
        if not self.active and i > 0 and \
                elapsed * (1 + self.iterations / i) >= self.seconds:
            from torch.profiler import profile, record_function
            self._sync()
            self._prof = profile(activities=self._activities())
            self._prof.start()
            self._range = record_function(SPAN)
            self._range.__enter__()
        if self.active:
            self.traced.append(i)

    def end(self) -> None:
        """The window's last iteration has returned: close the slice's
        range (the profiler itself stops in ``finish``)."""
        if self._range is not None:
            self._sync()
            self._range.__exit__(None, None, None)
            self._range = None

    def finish(self) -> Optional[Digest]:
        """Stop the profiler (the window has closed); the slice's
        digest."""
        if self._prof is None:
            return None
        self.end()
        self._prof.stop()
        out = digest(self._prof.events())
        self._prof = self._range = None
        return out
