"""The held-plan log matvec cell on the CPU at a tiny size: its driver
comes out correct and reads every metric that needs no card, holds its
plan through the window, and the log reference is the direct log sum."""
from __future__ import annotations

import copy
import json
import math

import numpy as np
import pytest
import torch

from bench.metrics._work import eval_fused
from bench.metrics._work_log import eval_fused_log
from bench.reference.direct_log import direct_log
from bench.reference.inputs import particles_numpy

from ._cells import ROOT, harness, run_cell

CELL = "f64-log-matvec-layer"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
#: Metrics only a run on the card can give (device memory, the trace).
CARD_ONLY = {"peak_mem_gib", "device_idle", "m2l_roofline",
             "eval_log_roofline", "program_pool_gib"}


def tiny(**over) -> dict:
    cell = copy.deepcopy(harness.cell(CELL))
    cell["params"].update(n=4096, ring=3, trace_iterations=1,
                          check={"matvecs": 1, "targets": 256})
    cell["config"].update(strong_cap=48, weak_cap=128)
    cell["params"].update(over)
    return cell


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_matvec_driver_runs_on_the_cpu(trace):
    run, numbers, correct = run_cell(tiny(), trace=trace,
                                     seconds=3.0 if trace else 1.0)
    assert correct, numbers
    assert set(run.limits) <= set(numbers)
    assert run.readings["iterations"] >= 1 and run.readings["failed"] == 0
    assert run.readings["plan_binds"] == 0
    run.setup_seconds = 1.0
    for m in harness.cell_metrics(BENCH, CELL, trace):
        read, scope = harness.reader(m["name"])
        value = read(run, scope)
        if m["name"].partition(".")[0] in CARD_ONLY:
            continue
        assert value is not None and math.isfinite(value), m["name"]


def test_matvec_check_fails_on_answers_for_other_charges():
    """Outputs checked against the charges of another ring vector read
    far above the cell's limit: the check compares each output with its
    own charges."""
    from bench.tracing import Tracer
    run = harness.Run(cell=tiny(), seed=4_000_000_007,
                      device=torch.device("cpu"))
    driver = harness.driver_class(run.cell["traffic"])(run)
    driver.setup(1.0)
    driver.window(1.0, Tracer(False, 0, "cpu"))
    driver.release()
    own = driver._charges
    driver._charges = lambda k: own(k + 1)
    numbers = driver.check()
    assert numbers["re_phi_err_rms"] > 100 * run.limits["re_phi_err_rms"]


@pytest.mark.parametrize("n", [1, 300, 2048])
def test_direct_log_is_the_direct_log_sum(n):
    from repro_torch.core.direct import direct_potential_numpy
    z, q = particles_numpy("layer", n, seed=[4_000_000_011, n])
    z[-1] = z[0]                     # a coincident pair is left out
    zt, qt = torch.as_tensor(z), torch.as_tensor(q)
    got = direct_log(zt[::7], zt, qt).numpy()
    want = direct_potential_numpy(z[::7], z, q, kernel="log").real
    # the same f64 sum in another order: a few ulps of its largest term
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * max(1.0, np.abs(want).max()))


def test_direct_log_refuses_complex_charges():
    z, q = particles_numpy("uniform", 16, seed=3)
    with pytest.raises(ValueError):
        direct_log(torch.as_tensor(z), torch.as_tensor(z),
                   torch.as_tensor(q + 1j))


def test_log_count_adds_the_log_terms_to_the_harmonic_count():
    work = {"weak": 10_000, "p2p": 20_000, "m2p": 3_000, "n": 1 << 20,
            "nlevels": 7, "p": 17, "strong_cap": 256, "weak_cap": 1024,
            "dtype": "f64", "m2p_lists": True}
    harmonic, log = eval_fused(work), eval_fused_log(work)
    width = -(-work["n"] // 4 ** work["nlevels"])
    assert log[2] == harmonic[2]
    assert log[0] - harmonic[0] == (2 * work["p2p"] * width * width
                                    + 14 * work["m2p"] * width)


def test_log_counts_agree_with_the_kernel_table():
    """The log evaluation's count against the kernel table's own
    (``chip_smoke.work_of``) on the operands the port stages for the
    kernel on a small log plan; the table's M2L count adds a log term to
    each weak entry, which ``_work.m2l`` leaves out."""
    import importlib

    from bench.metrics import _work
    from bench.traffic._common import fmm_config
    from bench.traffic.solve import list_work
    from repro_torch.core.fmm import effective_radii
    from repro_torch.kernels import eval_operands, m2l_operands
    from repro_torch.solver import FmmSolver

    smoke = importlib.import_module("chip_smoke")
    cfg = fmm_config(harness.config("fmm2d-log-bie-f64"), 3000, 48, 128)
    z, q = (torch.as_tensor(a) for a in particles_numpy("layer", 3000, 9))
    plan = FmmSolver(cfg, "cuda", "cpu").plan(z, q)
    work = list_work(plan, cfg)
    tree, conn = plan.tree, plan.conn
    mult = [torch.zeros(1, 4 ** l, cfg.p + 1, dtype=cfg.torch_complex)
            for l in range(cfg.nlevels + 1)]
    args, kwargs = eval_operands(mult[-1], mult[-1], tree, conn, cfg)
    assert kwargs["kernel"] == "log"
    flops, nbytes, dense = smoke.work_of("eval_fused", args, kwargs, "f64")
    assert eval_fused_log(work) == (flops, dense, nbytes)
    args, _ = m2l_operands(mult, conn.weak, tree.centers, cfg,
                           effective_radii(tree, cfg))
    flops, nbytes, dense = smoke.work_of("m2l", args, {}, "f64")
    harmonic = _work.m2l(work)
    assert (flops - smoke.LOG_TERM * work["weak"], dense, nbytes) == harmonic
