"""The traced slice's digest on made-up profiler events: the union of
device intervals, device annotations of host ranges left out, and the
idle gaps named by what the host was doing."""
from __future__ import annotations

import math
from types import SimpleNamespace

from bench.tracing import SPAN, digest


def event(name, start, end, device=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        is_user_annotation=False)


def test_digest():
    events = [
        event(SPAN, 0, 1000),
        event("bench::apply", 0, 1000),
        event("cudaGraphLaunch", 100, 300),
        event("bench::apply", 0, 1000, device=True),   # its annotation
        event("k1", 50, 200, device=True),
        event("k2", 150, 410, device=True),             # overlaps k1
        event("k1", 700, 800, device=True),
        event("k3", 990, 1200, device=True),            # clipped at 1000
    ]
    d = digest(events)
    assert math.isclose(d.window_s, 1e-3)
    assert math.isclose(d.busy_s, (360 + 100 + 10) * 1e-6)
    assert d.kernel("k1") == (2, (150 + 100) * 1e-6)
    count, seconds = d.kernel("k3")               # counted whole
    assert count == 1 and math.isclose(seconds, 210e-6)
    assert "bench::apply" not in d.ops
    # gaps: 410..700 (290), 800..990 (190), 0..50 (50)
    assert [round(s * 1e6) for _, s in d.gaps] == [290, 190, 50]
    assert d.gaps[0][0] == "bench::apply"
    assert d.gaps[2][0] == "bench::apply"
    out = d.breakdown()
    assert out["device_ops"][0][0] == "k2" and len(out["idle_gaps"]) == 3


def test_no_slice_or_no_device_work():
    assert digest([event("x", 0, 10)]) is None
    assert digest([event(SPAN, 0, 10), event("x", 0, 10)]) is None
