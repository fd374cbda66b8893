"""What the readers of the port's own spans, counters and device phase
marks share (``repro_torch.trace``): the registry's snapshot when the
run's metrics are read, medians of phase readings over an entry point's
calls, and span durations. Each returns None where the registry holds
nothing to read, and where the port has no registry at all.

On the card a phase reading is one replay's device marks. On the CPU,
where every program call runs eagerly and records no mark, it is read
from the call's own spans: ``program::eager`` (tagged with the entry
point) and the ``fmm::<phase>`` spans inside it, whose host times are
the phases' times there (the CPU runs each operation before it returns);
``launch_gap`` is then the time from the call's start to its first
phase."""
from __future__ import annotations

import statistics


def snapshot() -> dict | None:
    """``repro_torch.trace.snapshot()``, or None for a port without it."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    return trace.snapshot()


def _eager_readings(snap: dict, entries: tuple) -> list[dict]:
    """Phase readings (ms) of the eager calls of ``entries``, from their
    spans."""
    calls = {s.id: s for s in snap["spans"]
             if s.name == "program::eager" and s.tag in entries}
    inside: dict = {}
    for s in snap["spans"]:
        if s.parent in calls and s.name.startswith("fmm::"):
            inside.setdefault(s.parent, []).append(s)
    readings = []
    for call, phases in inside.items():
        first = min(s.start for s in phases)
        reading = {"launch_gap": 1e3 * (first - calls[call].start)}
        for s in phases:
            reading[s.name.partition("::")[2]] = duration_ms(s)
        readings.append(reading)
    return readings


def phase_ms(run, entries: tuple, phases: tuple) -> float | None:
    """The median, over every call of the entry points ``entries`` that
    the process made (replays on the card, eager calls on the CPU), of
    the ms of ``phases`` summed."""
    snap = snapshot()
    if snap is None:
        return None
    if run.device.type == "cpu":
        readings = _eager_readings(snap, entries)
    else:
        readings = [r for e in entries for r in snap["phases"].get(e, ())]
    values = [sum(r[p] for p in phases) for r in readings
              if all(p in r for p in phases)]
    return statistics.median(values) if values else None


def spans(name: str) -> list:
    """The span records named ``name``, oldest first."""
    snap = snapshot()
    return [] if snap is None else [s for s in snap["spans"]
                                    if s.name == name]


def duration_ms(span) -> float:
    return 1e3 * (span.end - span.start)
