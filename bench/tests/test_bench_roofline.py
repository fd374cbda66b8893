"""The operation and byte counts behind the M2L and fused-evaluation
rooflines: a hand count on made-up occupancy, the occupancy read from a
small plan against a count entry by entry, and the counts against the
kernel table's own (``chip_smoke.work_of``) on the operands the port
stages for the kernels."""
from __future__ import annotations

import importlib
import math

import numpy as np
import pytest
import torch

from bench.metrics import _work
from bench.reference.inputs import particles_numpy
from bench.traffic._common import fmm_config
from bench.traffic.solve import list_work
from repro_torch.core.fmm import effective_radii
from repro_torch.kernels import eval_operands, m2l_operands
from repro_torch.solver import FmmSolver

from ._cells import harness

HAND = {"weak": 10, "p2p": 5, "m2p": 2, "n": 16, "nlevels": 1, "p": 2,
        "strong_cap": 3, "weak_cap": 4, "dtype": "f64", "m2p_lists": True}


def test_hand_count():
    # P = 3: 4P^2 + 6P + 12p + 8P = 102 a weak entry, 36 of them dense;
    # 4 boxes: lists 64 B, multipoles 192, centers and radii 96, H 72,
    # result 192
    assert _work.m2l(HAND) == (1020.0, 360.0, 616.0)
    # 4 leaves of 4 slots: L2P 16 * 8p, P2P 5 * 16 * 14, M2P 2 * 4 *
    # (8p + 14); lists 48 B, planes 768, ranks 64, locals 192, result
    # 256; M2P lists 48, multipoles 192, centers and radii 96
    assert _work.eval_fused(HAND) == (1616.0, 0.0, 1664.0)
    assert _work.bound_s((34e12, 0.0, 1.0), "f64") == 1.0
    assert _work.bound_s((0.0, 0.0, 3.35e12), "f32") == 1.0
    assert math.isclose(_work.bound_s((67e12, 67e12, 0.0), "f64"), 1.0)


@pytest.fixture(scope="module")
def small_plan():
    cfg = fmm_config(harness.config("fmm2d-paper-f64"), 3000)
    z, q = (torch.as_tensor(a) for a in particles_numpy("layer", 3000, 9))
    solver = FmmSolver(cfg, "cuda", "cpu")
    return cfg, solver.plan(z, q)


def test_occupancy_entry_by_entry(small_plan):
    cfg, plan = small_plan
    work = list_work(plan, cfg)

    def count(t):
        return sum(1 for v in t.reshape(-1).tolist() if v >= 0)

    assert cfg.nlevels == 3
    assert work["weak"] == sum(count(plan.conn.weak[l])
                               for l in (1, 2, 3)) > 0
    assert work["p2p"] == count(plan.conn.p2p) > 0
    assert work["m2p"] == count(plan.conn.m2p)


def test_counts_agree_with_the_kernel_table(small_plan):
    smoke = importlib.import_module("chip_smoke")
    cfg, plan = small_plan
    work = list_work(plan, cfg)
    tree, conn = plan.tree, plan.conn
    P = cfg.p + 1
    mult = [torch.zeros(1, 4 ** l, P, dtype=cfg.torch_complex)
            for l in range(cfg.nlevels + 1)]
    args, _ = m2l_operands(mult, conn.weak, tree.centers, cfg,
                           effective_radii(tree, cfg))
    flops, nbytes, dense = smoke.work_of("m2l", args, {}, cfg.dtype)
    assert _work.m2l(work) == (flops, dense, nbytes)
    args, kwargs = eval_operands(mult[-1], mult[-1], tree, conn, cfg)
    flops, nbytes, dense = smoke.work_of("eval_fused", args, kwargs,
                                         cfg.dtype)
    assert _work.eval_fused(work) == (flops, dense, nbytes)
    assert np.isfinite(_work.bound_s(_work.m2l(work), cfg.dtype))


def test_roofline_share_from_a_trace():
    from types import SimpleNamespace

    from bench.tracing import Digest
    bound = _work.bound_s(_work.m2l(HAND), "f64")
    digest = Digest(window_s=1.0, busy_s=0.5, gaps=[],
                    ops={"void m2l_kernel<double, false, 18>":
                         [3, 3 * 4 * bound]})
    run = SimpleNamespace(readings={"traced_work": [HAND] * 4},
                          digest=digest)
    # three launches recorded for four solves: the means still give 25%
    assert math.isclose(_work.roofline(run, "m2l_kernel", _work.m2l), 25.0)
    assert _work.roofline(run, "eval_fused_kernel", _work.eval_fused) is None
    run.digest = None
    assert _work.roofline(run, "m2l_kernel", _work.m2l) is None
