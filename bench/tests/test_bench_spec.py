"""``BENCHMARK.json`` against the benchmark's contract, and every cell,
configuration, driver and metric it names found by name."""
from __future__ import annotations

import json
import re

import pytest

from ._cells import ROOT, harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", path)
        assert (ROOT / path).is_dir() and ".." not in path
    assert 1 <= len(BENCH["command"]) <= 32
    assert BENCH["command"][1].startswith(tuple(BENCH["paths"]))


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + \
        [m["name"] for m in METRICS]
    for name in names:
        assert NAME.match(name), name
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert len(set(CELLS)) == len(CELLS)
    configs = [c["name"] for c in BENCH["configs"]]
    assert len(set(configs)) == len(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs), "a config and traffic pair twice"
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for cell in CELLS:
        own = [m["name"] for m in harness.cell_metrics(BENCH, cell, False)]
        assert "setup_s" in own and len(own) >= 2, cell
        layer = harness.cell_metrics(BENCH, cell, True)
        assert layer, cell
        for m in layer:
            assert m["moves"] in own, (cell, m["name"])
    for m in METRICS:
        for cell in m.get("workloads", []):
            assert cell in CELLS, (m["name"], cell)


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_configs_found_by_name(entry):
    assert entry["file"] == f"bench/configs/{entry['name']}.json"
    cfg = harness.config(entry["name"])
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    assert entry["source"].startswith("https://")
    assert entry["name"] in {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("name", CELLS)
def test_cells_and_drivers_found_by_name(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = harness.cell(name)
    assert cell["config_name"] == entry["config"]
    assert cell["traffic"] == entry["traffic"]
    driver = harness.driver_class(cell["traffic"])
    for method in ("setup", "window", "release", "check"):
        assert callable(getattr(driver, method))
    assert cell["limits"] and all(v >= 0 for v in cell["limits"].values())


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_metrics_found_by_name(name):
    read, scope = harness.reader(name)
    assert callable(read)
    module, _, rest = name.partition(".")
    assert (scope or "") == rest
    assert (ROOT / "bench" / "metrics" / f"{module}.py").exists()


def test_the_harness_names_no_cell_driver_or_metric():
    """Adding a cell, a configuration, a driver or a metric is adding
    files and entries: the harness's own code names none of them."""
    words = set(CELLS) | {c["name"] for c in BENCH["configs"]} | \
        {w["traffic"].partition(".")[0] for w in BENCH["workloads"]} | \
        {m["name"].partition(".")[0] for m in METRICS}
    for path in ("bench/run.py", "bench/harness.py", "bench/tracing.py"):
        text = (ROOT / path).read_text()
        for word in words:
            assert not re.search(rf"\b{re.escape(word)}\b", text), \
                (path, word)
