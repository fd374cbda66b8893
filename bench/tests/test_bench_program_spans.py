"""The readers of the port's spans, counters and device phase marks
(``bench/metrics/_spans.py`` and the metrics on it) on a registry filled
by hand, and their None where it holds nothing for them or where the
port has no registry."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import trace

from ._cells import harness

S = trace.Span


def _apply(gap, tree, conn, up, down, ev, unsort):
    return {"launch_gap": gap, "tree": tree, "connectivity": conn,
            "upward": up, "downward": down, "evaluation": ev,
            "unsort": unsort}


PHASES = {
    "apply": [_apply(0.1, 1.0, 2.0, 3.0, 4.0, 5.0, 0.5),
              _apply(0.3, 2.0, 2.0, 4.0, 5.0, 6.0, 0.5),
              _apply(0.2, 9.0, 9.0, 9.0, 9.0, 9.0, 0.5)],
    "refresh": [{"launch_gap": 0.4, "tree": 10.0, "connectivity": 20.0},
                {"launch_gap": 0.6, "tree": 12.0, "connectivity": 20.0}],
    "apply_plan": [{"launch_gap": 0.5, "upward": 1.5, "downward": 2.5,
                    "evaluation": 3.5, "unsort": 0.25}],
    "apply_batched_with_health": [_apply(7, 7, 7, 7, 7, 7, 7)],
}
SPANS = [
    S(1, None, "serve::wave", 0.0, 0.010),
    S(2, 1, "serve::admit", 0.0, 0.001),
    S(3, 1, "serve::queue", 0.0, 0.002, 40),
    S(4, 1, "serve::apply", 0.002, 0.006),
    S(5, 1, "serve::queue", 0.0, 0.007, 41),
    S(6, 1, "serve::apply", 0.007, 0.009),
    S(7, None, "serve::wave", 1.0, 1.004),
    S(8, 7, "serve::queue", 1.0, 1.001, 42),
    S(9, 7, "serve::apply", 1.001, 1.003),
    S(10, None, "serve::wave", 2.0, 2.003),
    S(11, 99, "serve::apply", 2.0, 2.003),     # another wave's child
    S(12, None, "guard::read", 0.0, 5.0),
]
COUNTERS = {"program.eager": 36, "program.capture": 35,
            "program.replay": 900}
FULL = {"spans": SPANS, "counters": COUNTERS, "phases": PHASES}
EMPTY = {"spans": [], "counters": {}, "phases": {}}


CARD = SimpleNamespace(device=torch.device("cuda", 0))
CPU = SimpleNamespace(device=torch.device("cpu"))


def read(name, snap, monkeypatch, run=CARD):
    monkeypatch.setattr(trace, "snapshot", lambda: snap)
    fn, scope = harness.reader(name)
    return fn(run, scope)


@pytest.mark.parametrize("name,want", [
    ("topology_ms.solve", 4.0),
    ("upward_ms.solve", 4.0),
    ("downward_ms.solve", 5.0),
    ("evaluation_ms.solve", 6.5),
    ("launch_gap_ms.solve", 0.2),
    ("topology_ms.step", 31.0),
    ("upward_ms.step", 1.5),
    ("downward_ms.step", 2.5),
    ("evaluation_ms.step", 3.75),
    ("launch_gap_ms.step", 0.5),
    ("plane_host_ms.serve", 3.0),      # waves 10-4-2, 4-2, 3
    ("queue_ms.serve",
     float(np.percentile([2.0, 7.0, 1.0], 95))),
    ("cold_calls.serve", 71),
])
def test_reader_on_a_filled_registry(monkeypatch, name, want):
    got = read(name, FULL, monkeypatch)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("name", [
    "topology_ms.solve", "upward_ms.step", "downward_ms.solve",
    "evaluation_ms.step", "launch_gap_ms.step", "plane_host_ms.serve",
    "queue_ms.serve", "cold_calls.serve"])
def test_reader_on_an_empty_registry_is_none(monkeypatch, name):
    assert read(name, EMPTY, monkeypatch) is None


def test_phase_readers_need_every_phase_they_sum(monkeypatch):
    """A reading without one of the phases a reader sums is left out;
    another entry's readings are never read."""
    snap = {"spans": [], "counters": {},
            "phases": {"refresh": [{"launch_gap": 1.0, "tree": 3.0}],
                       "apply_batched_with_health": PHASES["apply"]}}
    assert read("topology_ms.step", snap, monkeypatch) is None
    assert read("launch_gap_ms.step", snap, monkeypatch) == 1.0
    assert read("topology_ms.solve", snap, monkeypatch) is None


def test_a_scope_without_entries_is_none(monkeypatch):
    assert read("topology_ms.serve", FULL, monkeypatch) is None


def test_cold_calls_with_one_counter(monkeypatch):
    snap = dict(EMPTY, counters={"program.capture": 3})
    assert read("cold_calls.serve", snap, monkeypatch) == 3
    snap = dict(EMPTY, counters={"program.replay": 3})
    assert read("cold_calls.serve", snap, monkeypatch) is None


def test_readers_without_the_ports_registry_are_none(monkeypatch):
    """A port that has no ``repro_torch.trace`` (an older tree): every
    reader returns None and none raises."""
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    for name in ("topology_ms.solve", "launch_gap_ms.step",
                 "plane_host_ms.serve", "queue_ms.serve",
                 "cold_calls.serve"):
        fn, scope = harness.reader(name)
        assert fn(CARD, scope) is None, name


def test_serving_readers_through_the_registry():
    """The serving readers on spans and counters the registry itself
    holds."""
    trace.reset()
    try:
        with trace.span("serve::wave") as wave:
            trace.record("serve::queue", wave.start, wave.start + 0.004,
                         tag=3, parent=wave.id)
            with trace.span("serve::apply"):
                pass
        trace.count("program.eager", 2)
        trace.count("program.capture")
        snap = trace.snapshot()
        (w,) = [s for s in snap["spans"] if s.name == "serve::wave"]
        (a,) = [s for s in snap["spans"] if s.name == "serve::apply"]
        host = 1e3 * ((w.end - w.start) - (a.end - a.start))
        for name, want in (("plane_host_ms.serve", host),
                           ("queue_ms.serve", 4.0),
                           ("cold_calls.serve", 3)):
            fn, scope = harness.reader(name)
            assert fn(CARD, scope) == pytest.approx(want), name
    finally:
        trace.reset()



def _eager(call, entry, start, phases):
    """The spans of one eager call: ``program::eager`` tagged ``entry``
    from ``start`` (s), then each phase (name, ms) back to back after a
    1 ms lead."""
    out, t = [S(call, None, "program::eager", start, 0.0, entry)], \
        start + 1e-3
    for k, (name, ms) in enumerate(phases):
        out.append(S(call + 1 + k, call, f"fmm::{name}", t, t + 1e-3 * ms))
        t += 1e-3 * ms
    out[0] = out[0]._replace(end=t)
    return out


def test_phase_readers_on_the_cpu_read_the_eager_calls(monkeypatch):
    """On the CPU (no replay, no mark) a phase reader reads the phase
    spans inside each eager call of its entry points; the marks are not
    read there, nor eager calls on the card."""
    spans = (_eager(100, "apply", 0.0, [("tree", 1), ("connectivity", 2),
                                        ("upward", 3), ("unsort", 4)])
             + _eager(200, "apply", 1.0, [("tree", 3), ("connectivity", 3),
                                          ("upward", 5), ("unsort", 4)])
             + _eager(300, "apply", 2.0, [("tree", 5), ("connectivity", 5),
                                          ("upward", 7), ("unsort", 4)])
             + _eager(400, "refresh", 3.0, [("tree", 50)]))
    snap = dict(FULL, spans=spans)
    for name, want in (("topology_ms.solve", 6.0), ("upward_ms.solve", 5.0),
                       ("launch_gap_ms.solve", 1.0),
                       ("topology_ms.step", None),
                       ("launch_gap_ms.step", 1.0),
                       ("evaluation_ms.solve", None)):
        got = read(name, snap, monkeypatch, run=CPU)
        assert got == (want if want is None else pytest.approx(want)), name
    assert read("topology_ms.solve", snap, monkeypatch) == 4.0
    assert read("topology_ms.solve", EMPTY, monkeypatch, run=CPU) is None
