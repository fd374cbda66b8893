"""PyTorch port, the tracing registry (``repro_torch.trace``) on the CPU:
span records nest with parent ids and tags, the rings stay bounded, a
span enters a profiler range only while a profiler runs, the program
counters count every (eager) call, the pipeline's phases become device
marks in order inside a capture (the capture and the events stood in for
by fakes: the CPU has neither), a replay's marks read once and an
unfinished one counted unread, and the serving plane's spans of a mixed
wave."""
import itertools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core.config import FmmConfig
from repro_torch.data import particles
from repro_torch.serve import BucketLattice, Request, ServePlane
from repro_torch.solver import FmmSolver

PHASES = ["tree", "connectivity", "upward", "downward", "evaluation",
          "unsort"]


@pytest.fixture(autouse=True)
def empty_registry():
    trace.reset()
    yield
    trace.reset()


class FakeEvent:
    """A timing event whose clock is a counter (one ms a record)."""

    ticks = itertools.count()

    def __init__(self, enable_timing=False, external=False):
        self.t = None
        self.done = True

    def record(self, stream=None):
        self.t = next(FakeEvent.ticks)

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return float(other.t - self.t)


@pytest.fixture
def capturing(monkeypatch):
    """Stand-ins for a stream that captures and for CUDA events."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)


def _replay(marks):
    """What one replay of a captured graph does to its marks."""
    marks.before_replay(None)
    for event in marks.events:
        event.record()


def test_spans_nest_with_parent_ids_and_tags():
    with trace.span("a") as a:
        with trace.span("b", tag=7) as b:
            with trace.span("c") as c:
                pass
        trace.record("d", a.start, b.start, tag="x")
        trace.record("e", 1.0, 2.0, parent=c.id)
    spans = {s.name: s for s in trace.snapshot()["spans"]}
    assert spans["a"].parent is None
    assert spans["b"].parent == a.id and spans["b"].tag == 7
    assert spans["c"].parent == b.id
    assert spans["d"].parent == a.id and spans["d"].tag == "x"
    assert (spans["d"].start, spans["d"].end) == (a.start, b.start)
    assert spans["e"].parent == c.id
    for s in spans.values():
        assert s.start <= s.end
    assert spans["a"].start <= spans["b"].start <= spans["c"].start
    assert spans["c"].end <= spans["b"].end <= spans["a"].end
    assert len({s.id for s in spans.values()}) == 5


def test_span_ring_keeps_the_newest():
    for i in range(trace.SPANS + 5):
        trace.record("s", 0.0, 0.0, tag=i)
    spans = trace.snapshot()["spans"]
    assert len(spans) == trace.SPANS
    assert spans[0].tag == 5 and spans[-1].tag == trace.SPANS + 4


def test_counters_add_and_reset():
    trace.count("x")
    trace.count("x", 4)
    trace.count("y", 2)
    assert trace.snapshot()["counters"] == {"x": 5, "y": 2}
    trace.reset()
    assert trace.snapshot() == {"spans": [], "counters": {}, "phases": {}}


def test_profiler_range_only_while_profiling():
    with trace.span("outside::span"):
        torch.ones(3).sum()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("inside::span"):
            torch.ones(3).sum()
        with trace.phase("inside::phase"):
            torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert {"inside::span", "inside::phase"} <= names
    assert "outside::span" not in names
    with trace.span("after::span"):
        pass
    assert [s.name for s in trace.snapshot()["spans"]] == [
        "outside::span", "inside::span", "inside::phase", "after::span"]


def test_program_counters_count_every_eager_call_on_the_cpu():
    cfg = FmmConfig(n=256, nlevels=2, p=6, dtype="f64")
    z, q = particles("uniform", cfg.n, 0, device="cpu")
    solver = FmmSolver(cfg, "cuda", "cpu")
    for _ in range(3):
        solver.apply(z, q)
    plan = solver.refresh(z, q)
    solver.apply_plan(plan)
    solver.apply_batched(z[None].repeat(2, 1), q[None].repeat(2, 1))
    snap = trace.snapshot()
    # five builds of two levels (3 apply, refresh, apply_batched), each
    # level classified by the hook's plain version on the CPU
    assert snap["counters"] == {"program.eager": 6,
                                "connectivity.kernel_levels": 0,
                                "connectivity.plain_levels": 10}
    assert snap["phases"] == {}            # no capture, no marks
    spans = snap["spans"]
    eager = [s for s in spans if s.name == "program::eager"]
    assert len(eager) == 6
    first = [s.name.partition("::")[2] for s in spans
             if s.parent == eager[0].id]
    assert first == PHASES


@pytest.mark.parametrize("entry,names", [
    ("apply", PHASES),
    ("apply_with_health", PHASES + ["health"]),
    ("refresh", ["tree", "connectivity"]),
])
def test_a_capture_marks_each_phase_in_order(capturing, entry, names):
    cfg = FmmConfig(n=256, nlevels=2, p=6, dtype="f64")
    z, q = particles("uniform", cfg.n, 0, device="cpu")
    solver = FmmSolver(cfg, "cuda", "cpu")
    fn = solver._pipeline(entry)
    with trace.marking() as marking:
        fn(z[None], q[None])
        marks = marking.close(entry)
    with trace.phase("fmm::tree"):           # no capture open: no mark
        pass
    assert marks.names == names
    assert len(marks.events) == len(names) + 1
    for _ in range(3):
        _replay(marks)
    readings = trace.snapshot()["phases"][entry]
    assert len(readings) == 3
    for reading in readings:
        assert reading == dict({"launch_gap": 1.0},
                               **{n: 1.0 for n in names})


def test_a_replay_is_read_once_and_an_unfinished_one_counted(capturing):
    with trace.marking() as marking:
        with trace.phase("fmm::upward"):
            pass
        with trace.phase("fmm::downward"):
            pass
        marks = marking.close("apply_plan")
    marks.read()                            # nothing replayed yet
    _replay(marks)
    _replay(marks)                          # reads the first replay
    assert len(trace._phases["apply_plan"]) == 1
    marks.events[-1].done = False           # the second is still running
    _replay(marks)                          # so it goes unread
    marks.events[-1].done = True
    snap = trace.snapshot()                 # reads the pending third
    assert snap["counters"] == {"trace.marks_unread": 1}
    assert len(snap["phases"]["apply_plan"]) == 2
    assert len(trace.snapshot()["phases"]["apply_plan"]) == 2


def test_phase_ring_keeps_the_newest_replays(capturing):
    with trace.marking() as marking:
        with trace.phase("fmm::tree"):
            pass
        marks = marking.close("refresh")
    for _ in range(trace.REPLAYS + 3):
        _replay(marks)
    assert len(trace.snapshot()["phases"]["refresh"]) == trace.REPLAYS


def _requests(rng, sizes):
    return [Request(rng.random(n) + 1j * rng.random(n),
                    rng.random(n) + 0j) for n in sizes]


def test_serve_spans_of_a_mixed_wave():
    plane = ServePlane(BucketLattice.geometric(64, 1024), backend="cuda",
                       max_batch=2, device="cpu")
    rng = np.random.default_rng(3)
    wave1 = _requests(rng, [10, 100, 30, 700, 50, 20])
    wave1.insert(2, Request(np.array([np.nan + 0j]), np.array([1 + 0j])))
    wave1.append(Request(np.ones(4), np.ones(4)))        # real z
    wave2 = _requests(rng, [200, 5])
    results = plane.serve(wave1) + plane.serve(wave2)
    spans = trace.snapshot()["spans"]
    waves = [s for s in spans if s.name == "serve::wave"]
    assert len(waves) == 2 and all(w.parent is None for w in waves)
    dispatched = [r.report.rid for r in results if r.report.batch]
    assert len(dispatched) == 8             # the two poisons rejected
    queue = [s for s in spans if s.name == "serve::queue"]
    assert sorted(s.tag for s in queue) == sorted(dispatched)
    by_id = {w.id: w for w in waves}
    packs = {(s.parent, s.start) for s in spans if s.name == "serve::pack"}
    for s in queue:
        assert s.parent in by_id and s.start == by_id[s.parent].start
        assert (s.parent, s.end) in packs
    children = {}
    for s in spans:
        if s.parent in by_id and s.name != "serve::queue":
            children.setdefault(s.parent, []).append(s.name)
    # wave 1: buckets 64 (10, 30, 50, 20: two chunks), 128 (100), 1024
    assert children[waves[0].id] == (
        ["serve::admit"]
        + ["serve::cache", "serve::pack", "serve::apply",
           "serve::unpack"] * 4)
    assert children[waves[1].id] == (
        ["serve::admit"]
        + ["serve::cache", "serve::pack", "serve::apply",
           "serve::unpack"] * 2)
    for s in spans:
        if s.parent in by_id:
            w = by_id[s.parent]
            assert w.start <= s.start <= s.end <= w.end
