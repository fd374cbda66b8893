"""Finds a cell's files by name and holds the state of one run.

A cell ``<name>`` is ``bench/workloads/<name>.json``:

    {"config": "<config>", "traffic": "<driver>[.<mix>]", "params": {...},
     "limits": {"<number>": <limit>, ...}}

``config`` names ``bench/configs/<config>.json``. ``traffic`` names the
cell's traffic mix, the same name as in ``BENCHMARK.json``; the part
before its first dot names ``bench/traffic/<driver>.py`` (its
``Driver``), so that one driver reads several mixes, each one a cell
file's ``params``. ``limits`` is the upper limit of each number that
the driver's ``check()`` compares against the plain reference. A metric
``<module>[.<scope>]`` is read by
``bench/metrics/<module>.py``. Nothing here names a cell, a driver or a
metric: adding one is adding its files and its entries in
``BENCHMARK.json``.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import sys
from pathlib import Path
from typing import Any, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: Top-level module names the benchmark's process may never hold: JAX and
#: the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def cell(name: str) -> dict:
    """The cell file of ``name`` with its configuration loaded under
    ``config`` (and its name under ``config_name``)."""
    spec = load_json(BENCH / "workloads" / f"{name}.json")
    return dict(spec, name=name, config_name=spec["config"],
                config=config(spec["config"]))


def driver_class(traffic: str):
    """The ``Driver`` of a traffic mix: the module is the part of its
    name before the first dot."""
    module = traffic.partition(".")[0]
    return importlib.import_module(f"bench.traffic.{module}").Driver


def reader(metric: str):
    """``(read, scope)`` of a metric name: the module is the part before
    the first dot, the scope the part after it (None without a dot)."""
    module, _, scope = metric.partition(".")
    return (importlib.import_module(f"bench.metrics.{module}").read,
            scope or None)


def cell_metrics(bench: dict, name: str, trace: bool) -> list[dict]:
    """The metric entries of ``BENCHMARK.json`` that cell ``name``
    reports: its end-to-end metrics untraced, its per-layer ones traced.
    A metric without a ``workloads`` key belongs to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Run:
    """One run of one cell: what the driver was given and what it read.

    ``readings`` is filled by the driver (counts and host-clock times of
    the window); ``digest`` by the harness from the profiler trace of a
    traced run; ``control`` is None in the benchmark's runs and names a
    lower-precision stand-in in the control readings
    (``bench/tools/readings.py``)."""

    cell: dict
    seed: int
    device: Any
    trace: bool = False
    control: Optional[str] = None
    readings: dict = dataclasses.field(default_factory=dict)
    digest: Any = None
    setup_seconds: Optional[float] = None
    peak_bytes: Optional[int] = None

    @property
    def params(self) -> dict:
        return self.cell["params"]

    @property
    def config(self) -> dict:
        return self.cell["config"]

    @property
    def limits(self) -> dict:
        return self.cell["limits"]
