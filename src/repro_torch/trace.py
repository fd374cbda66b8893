"""Spans, counters and device phase marks of the port: one process-wide,
in-memory, bounded registry that ``snapshot()`` returns whole.

Spans. ``with span(name, tag=None, densities=None):`` appends one
record (id, parent id, name, start, end on the host's
``time.perf_counter``, tag, densities: the densities a call evaluates
on one geometry, where the span is one call's) when the block exits; the parent is the innermost span open on the same thread.
A ring keeps the newest ``SPANS`` records. Two clock reads and an append
are cheap enough to stay on. While a ``torch.profiler`` runs, a span
also enters a ``record_function`` range of its name, so that it sits on
the profiler's host timeline beside the device's.

Counters. ``count(name, n=1)`` adds to an integer counter.

Device phase marks. Every solver entry point replays as one CUDA graph
on the card (``solver.program``), and a replay runs no Python: no span
can time the work inside it. So the pipeline's phases
(``phase("fmm::tree")``, ``"fmm::connectivity"``, ``"fmm::charges"``,
``"fmm::upward"``, ``"fmm::downward"``, ``"fmm::evaluation"``,
``"fmm::unsort"``, ``"fmm::health"``) also record a timing event into
the graph while it is captured (``torch.cuda.Event(enable_timing=True,
external=True)``: an event-record node of the graph), and the program
adds an end mark after the pipeline, still inside the capture
(``marking``). Before each replay the program records one ordinary
timing event on its stream (``Marks.before_replay``). A replay's marks
are read without blocking: at the program's next replay, when its
programs are released, or at ``snapshot()``, whichever comes first, and
only if the end mark has completed (else the counter
``trace.marks_unread`` rises). Each reading is one record under the
entry's name (``apply``, ``refresh``, ``apply_plan``, ``apply_charges``,
``apply_batched_with_health``, ...): the device ms from each mark to the
next, under the phase's name without its ``fmm::`` prefix, and
``launch_gap``, the device ms from the event before the replay to its
first mark (what the device waits for the graph's first node). A ring
keeps the newest ``REPLAYS`` readings of each entry. Eager calls and the
CPU record no marks.

There is no switch and no file: ``snapshot()`` is the way out, and
``reset()`` empties everything.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, NamedTuple, Optional

import torch
from torch.profiler import record_function

#: Span records kept (the newest).
SPANS = 1 << 16
#: Replays whose phase readings are kept, per entry point (the newest).
REPLAYS = 1 << 14

clock = time.perf_counter

_spans: deque = deque(maxlen=SPANS)
_counters: dict[str, int] = {}
_phases: dict[str, deque] = {}
_pending: dict[int, "Marks"] = {}      # replayed, not read yet
_ids = itertools.count(1)
_local = threading.local()
_counting = threading.Lock()
_marking: Optional[list] = None        # (name, event) of the capture


class Span(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    start: float
    end: float
    tag: Any = None
    densities: Optional[int] = None


def _open() -> list:
    """The ids of the spans open on this thread, innermost last."""
    stack = getattr(_local, "open", None)
    if stack is None:
        stack = _local.open = []
    return stack


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class span:
    """A host span (module docstring); ``id`` and ``start`` are set on
    entry."""

    __slots__ = ("name", "tag", "densities", "id", "parent", "start",
                 "_range")

    def __init__(self, name: str, tag: Any = None,
                 densities: Optional[int] = None):
        self.name, self.tag, self.densities = name, tag, densities

    def __enter__(self) -> "span":
        stack = _open()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self._range = None
        if _profiling():
            self._range = record_function(self.name)
            self._range.__enter__()
        self.start = clock()
        return self

    def __exit__(self, *exc) -> None:
        end = clock()
        if self._range is not None:
            self._range.__exit__(*exc)
        _open().pop()
        _spans.append(Span(self.id, self.parent, self.name, self.start, end,
                           self.tag, self.densities))


class phase(span):
    """A span of one phase of the pipeline that, while a program's graph
    is being captured, also records the phase's device mark."""

    __slots__ = ()

    def __enter__(self) -> "phase":
        if _marking is not None and torch.cuda.is_current_stream_capturing():
            event = torch.cuda.Event(enable_timing=True, external=True)
            event.record()
            _marking.append((self.name.rpartition("::")[2], event))
        return super().__enter__()


def record(name: str, start: float, end: float, tag: Any = None,
           parent: Optional[int] = None) -> None:
    """Append a span that was timed elsewhere (``clock()`` readings); its
    parent defaults to the innermost open span."""
    if parent is None:
        stack = _open()
        parent = stack[-1] if stack else None
    _spans.append(Span(next(_ids), parent, name, start, end, tag))


def count(name: str, n: int = 1) -> None:
    with _counting:
        _counters[name] = _counters.get(name, 0) + n


class Marks:
    """The phase marks captured in one program's graph, and the event
    recorded before each of its replays."""

    def __init__(self, entry: str, marks: list):
        self.entry = entry
        self.names = [name for name, _ in marks[:-1]]
        self.events = [event for _, event in marks]
        self.start = torch.cuda.Event(enable_timing=True)
        self._replayed = False

    def before_replay(self, stream) -> None:
        """Read the last replay's marks, then mark this replay's start on
        ``stream`` (after the inputs were copied in)."""
        self.read()
        self.start.record(stream)
        self._replayed = True
        _pending[id(self)] = self

    def read(self) -> None:
        """Keep the last replay's phase readings, if it has completed."""
        if not self._replayed:
            return
        self._replayed = False
        _pending.pop(id(self), None)
        if not self.events[-1].query():
            count("trace.marks_unread")
            return
        reading = {"launch_gap": self.start.elapsed_time(self.events[0])}
        for name, a, b in zip(self.names, self.events, self.events[1:]):
            reading[name] = a.elapsed_time(b)
        _phases.setdefault(self.entry, deque(maxlen=REPLAYS)).append(reading)


class marking:
    """Collects the phase marks recorded while a program's graph is
    captured; ``close(entry)``, called inside the capture after the
    pipeline, adds the end mark and returns the ``Marks``."""

    def __enter__(self) -> "marking":
        global _marking
        self._outer, _marking = _marking, []
        self._marks = _marking
        return self

    def close(self, entry: str) -> Marks:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        self._marks.append(("end", event))
        return Marks(entry, self._marks)

    def __exit__(self, *exc) -> None:
        global _marking
        _marking = self._outer


def snapshot() -> dict:
    """Everything the registry holds, after reading every replay whose
    marks are still pending: ``spans`` (``Span`` records, oldest first),
    ``counters`` and ``phases`` (entry -> readings, oldest first)."""
    for marks in list(_pending.values()):
        marks.read()
    return {"spans": list(_spans), "counters": dict(_counters),
            "phases": {entry: list(ring) for entry, ring in _phases.items()}}


def reset() -> None:
    """Forget every span, counter, reading and pending replay."""
    _spans.clear()
    _counters.clear()
    _phases.clear()
    _pending.clear()
