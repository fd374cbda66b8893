"""The block matvec cell (K densities on one held plan of nodes on the
eight wire contours) on the CPU at a tiny size: its frozen geometry is
the port's, its work counts hold against the operands the kernels are
given, its driver comes out correct through the harness and reads every
metric that needs no card, and its entries keep the contract."""
from __future__ import annotations

import copy
import json
import math

import numpy as np
import pytest
import torch

from bench.metrics import _work_block as W
from bench.reference.wires import wire_nodes
from bench.traffic.block_matvec import block_work

from ._cells import ROOT, harness, run_cell

CELL = "f64-log-mtl8-block"
CONFIG = "fmm2d-log-mtl8-f64"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: Metrics only a run on the card can give (device memory, the trace).
CARD_ONLY = {"peak_mem_gib", "device_idle", "program_pool_gib",
             "eval_block_roofline", "m2l_block_roofline",
             "upward_block_roofline"}


def tiny(**over) -> dict:
    cell = copy.deepcopy(harness.cell(CELL))
    cell["params"].update(n=4096, ring=2, trace_iterations=1,
                          check={"blocks": 1, "targets": 128})
    cell["config"].update(densities=3)
    cell["params"].update(over)
    return cell


@pytest.mark.parametrize("n,seed", [(8, 0), (4096, 3), (4099, [5, 0]),
                                    (1 << 14, [3_000_000_011, 0])])
def test_frozen_wires_are_the_ports_generator(n, seed):
    from repro_torch.data.synthetic import particles_numpy
    z, q = wire_nodes(n, seed)
    zp, qp = particles_numpy("wires8", n, seed)
    assert np.array_equal(z, zp) and np.array_equal(q, qp)
    # eight circles of radius 0.015 at 0.15 + 0.1 i, 0.5
    counts = [n // 8 + (i < n % 8) for i in range(8)]
    centre = 0.15 + 0.1 * np.repeat(np.arange(8), counts) + 0.5j
    assert np.allclose(np.abs(z - centre), 0.015, rtol=0, atol=1e-12)


def _staged(kernel="log", K=3, dist="wires8", n=4096):
    """A tiny one-problem plan with K densities and the operands of each
    K-density kernel as the port stages them."""
    from repro_torch.core import fmm as F
    from repro_torch.core.config import FmmConfig
    from repro_torch.data.synthetic import particles_numpy
    from repro_torch.kernels import (eval_operands, m2l_operands,
                                     p2l_operands)
    cfg = FmmConfig(n=n, nlevels=3, p=17, kernel=kernel, dtype="f64",
                    strong_cap=48, weak_cap=128)
    z, q = particles_numpy(dist, n, 4)
    plan = F.fmm_build(torch.as_tensor(z)[None], torch.as_tensor(q)[None],
                       cfg)
    Q = torch.as_tensor(np.random.default_rng(1).normal(size=(K, n)) + 0j)
    plan = F.with_charges(plan, Q)
    rho = F.effective_radii(plan.tree, cfg)
    mult = F.upward(plan.tree, cfg, rho)
    local = F.downward(mult, plan.tree, plan.conn, cfg)
    work = block_work(plan, cfg, K)
    return cfg, plan, work, {
        "eval": eval_operands(local, mult[-1], plan.tree, plan.conn, cfg),
        "m2l": m2l_operands(mult, plan.conn.weak, plan.tree.centers, cfg,
                            rho)[0],
        "p2l": p2l_operands(plan.tree, plan.conn, cfg, rho[-1])}


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("kernel", ["log", "harmonic"])
@pytest.mark.parametrize("dist", ["wires8", "layer"])
def test_block_counts_hold_against_the_staged_operands(kernel, dist):
    """Bytes: every operand the port stages for a kernel once, with the
    charge, coefficient and result planes K rows deep (the geometry's
    single row once); entries: the occupied slots of the staged lists;
    a term of a density counted K times: the K-density count less the
    single-density count is K - 1 times the density terms."""
    K = 3
    cfg, plan, work, ops = _staged(kernel, K, dist)
    (p2p, m2p, zr, zi, qr, qi, rk, tr, ti, br, bi), kw = ops["eval"]
    assert qr.shape[0] == br.shape[0] == kw["ar"].shape[0] == K
    assert zr.shape[0] == tr.shape[0] == p2p.shape[0] == 1
    # results: K planes like the charges
    staged = _nbytes([p2p, m2p, zr, zi, qr, qi, rk, tr, ti, br, bi,
                      kw["ar"], kw["ai"], kw["mcr"], kw["mci"],
                      kw["mrho"]]) + _nbytes([qr, qi])
    assert W.eval_block(work)[2] == staged
    n = zr.shape[-1]
    assert work["p2p"] == int((p2p >= 0).sum())
    assert work["m2p"] == int((m2p >= 0).sum())
    one = W.eval_block(dict(work, densities=1))[0]
    per = 8 * work["p2p"] * n * n + 8 * cfg.p * p2p.shape[1] * n + \
        work["m2p"] * n * (8 * cfg.p + (8 if kernel == "log" else 0))
    assert W.eval_block(work)[0] - one == (K - 1) * per
    weak, ar, ai, cr, ci, rho, h, _ = ops["m2l"]
    assert ar.shape[0] == K and weak.shape[0] == cr.shape[0] == 1
    assert work["weak"] == int((weak >= 0).sum())
    assert W.m2l_block(work)[2] == _nbytes([weak, ar, ai, cr, ci, rho, h,
                                            ar, ai])
    P = cfg.p + 1
    assert W.m2l_block(work)[1] == K * 4.0 * P * P * work["weak"]
    (lists, z0r, z0i, rh, xr, xi, pq, pqi), _ = ops["p2l"]
    assert work["p2l"] == int((lists >= 0).sum())
    got = W.p2l_block(work)[2]
    ref = _nbytes([lists, z0r, z0i, rh]) + K * 2 * z0r.numel() * P * 8 + \
        work["p2l"] * n * 8 * (2 + 2 * K)
    assert got == ref
    if dist == "layer":
        assert work["p2l"] > 0 and work["m2p"] > 0
    up = W.upward_block(work)
    z, q = plan.tree.z, plan.tree.q
    boxes = sum(c.shape[1] for c in plan.tree.centers)
    assert up[2] == _nbytes([z]) + _nbytes([q]) + \
        (4 ** cfg.nlevels + 1) * 4 + 3 * boxes * 8 + K * 2 * boxes * P * 8


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_block_matvec_runs_through_the_harness_on_the_cpu(trace):
    """Set-up, window, release, check and every metric that needs no card,
    as ``bench/run.py`` calls them: correct, the plan held (no bind in
    the window), the densities counted K a call."""
    run, numbers, correct = run_cell(tiny(), trace=trace,
                                     seconds=3.0 if trace else 1.0)
    assert correct, numbers
    assert set(run.limits) <= set(numbers)
    assert run.readings["iterations"] >= 1 and run.readings["failed"] == 0
    assert run.readings["plan_binds"] == 0
    assert run.readings["densities"] == 3 * run.readings["iterations"]
    run.setup_seconds = 1.0
    names = []
    for m in harness.cell_metrics(BENCH, CELL, trace):
        names.append(m["name"])
        read, scope = harness.reader(m["name"])
        value = read(run, scope)
        if m["name"].partition(".")[0] in CARD_ONLY:
            continue
        assert value is not None and math.isfinite(value), m["name"]
    if trace:
        assert {"density_ms.matvec", "charges_ms.matvec",
                "evaluate_ms.matvec", "plan_binds.matvec"} <= set(names)
        dens = harness.reader("density_ms.matvec")[0](run, "matvec")
        ev = harness.reader("evaluate_ms.matvec")[0](run, "matvec")
        assert dens == pytest.approx(ev / 3)


def test_block_check_fails_on_answers_for_other_densities():
    """Outputs checked against another ring block's densities read far
    above the cell's limit: the check compares each density with its
    own."""
    from bench.tracing import Tracer
    run = harness.Run(cell=tiny(), seed=4_000_000_007,
                      device=torch.device("cpu"))
    driver = harness.driver_class(run.cell["traffic"])(run)
    driver.setup(1.0)
    driver.window(1.0, Tracer(False, 0, "cpu"))
    driver.release()
    own = driver._block
    driver._block = lambda k: own(k + 1)
    numbers = driver.check()
    assert numbers["re_phi_err_rms"] > 100 * run.limits["re_phi_err_rms"]


def test_block_entries_keep_the_contract():
    """The configuration and its cell, on one chip; the config's file
    holds its K and uncut widths; the cell reports ``solve_ms``,
    ``peak_mem_gib``, ``setup_s`` and the per-layer metrics it reads, and
    not the single-density log roofline; the (config, traffic) pairs are
    distinct."""
    entry = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
    cfg = harness.config(CONFIG)
    assert entry["reduced"] == cfg["reduced"] == []
    assert cfg["densities"] == 8 and cfg["kernel"] == "log" and \
        cfg["dtype"] == "f64" and (cfg["p"], cfg["theta"], cfg["n_d"]) == \
        (17, 0.5, 45)
    cells = {w["name"]: w for w in BENCH["workloads"]}
    assert cells[CELL]["chips"] == 1 and cells[CELL]["config"] == CONFIG
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, CELL, False)]
    assert set(e2e) == {"solve_ms", "peak_mem_gib", "setup_s"}
    layer = {m["name"] for m in harness.cell_metrics(BENCH, CELL, True)}
    assert "eval_log_roofline.matvec" not in layer
    # the wire plan has no P2L entry: its P2L launch would read a no-op
    assert "p2l_block_roofline.matvec" not in layer
    assert {"eval_block_roofline.matvec", "m2l_block_roofline.matvec",
            "upward_block_roofline.matvec",
            "density_ms.matvec", "device_idle.matvec",
            "program_pool_gib"} <= layer
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
