#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the adaptive FMM on one NVIDIA card.

    python3 chip_smoke.py

Runs top to bottom and exits nonzero on the first failure:

1. prints the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. builds the eight CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all started together) and prints each
   kernel's registers, shared memory and spills, and for the direct
   N-body kernel its targets a thread (K) and the SASS instructions a
   pair of its pair loop (``cuobjdump -sass``);
3. kernel phase: on the operands of the N = 2^20, p = 17 plans (paper
   Fig. 5.8 scale) of uniform, normal and layer particles (caps raised
   until no list overflows), in f32 and f64, holds each kernel against
   its plain torch version on the same inputs (classify: the kernel
   path's connectivity, one launch a level, bit-identical to the plain
   path's;
   the upward pass (its one or two launches) against the plain
   ``core.fmm.upward`` over every box of every level;
   the others per element within F64_TOL in f64 and F32_KERNEL_TOL in
   f32; the direct N-body sum on N_SAMPLE of the particles as targets
   against all 2^20 sources, where the kernel splits the sources to
   fill the card), checks that a second launch is bitwise
   equal to the first, prints how many list entries each plan occupies,
   and at the uniform plan times each kernel (many back-to-back launches
   on its staged operands between one pair of CUDA events) and its plain
   version (CUDA events around each call), with the kernel's share of
   its bound;
4. m2l_wide: the M2L kernel on synthetic weak rows of width
   W = 128, 7,680 and 12,288 (ragged runs with gaps, sources from 3,000
   boxes, a ragged last tile and empty boxes) in f32 and f64, against
   its plain version, a second launch bitwise equal, the rows of width
   128 spread over 12,288 slots bitwise equal to the packed ones, and
   its dynamic shared memory (which must not grow with W) and time at
   each W;
5. main path: ``FmmSolver.build(fmm_config(1 << 20, p=17))`` on the
   default device and ``apply_checked`` on uniform, normal and layer
   particles (seed 0), in f32 and f64: each entry point runs as a
   program, eagerly at its first call at a shape, captured as a CUDA
   graph at its second and replayed after; the four main-path kernels
   run exactly once per apply (launched from the host at a first call,
   recorded into the graph at a second, or a replay of a graph that
   recorded them) and the per-phase and N-body kernels never;
   accuracy against ``direct_potential`` on 4096 sampled targets over
   all 2^20 sources; in f64 the "cuda" and "reference" backends must
   agree within 1e-10; apply ms replayed, the first call's beside it;
   graphs: at the main path's configs on the three distributions (and
   the per-phase backend on uniform), in f32 and f64, each entry point
   (``apply``, ``apply_with_health``, ``apply_batched`` at B = 4,
   ``refresh``, ``apply_plan``) on a fresh solver: the first call's ms
   (eager, one run's launches from the host), the second's (capture and
   replay, one run's launches recorded), replay and eager medians, every
   call bitwise the eager pipeline (``fmm_build`` / ``fmm_evaluate``
   with the backend's hooks), no host launch in a replay, the kernels a
   replay runs on the card read by name from a profiler trace, the pool
   bytes each capture charges, the programs held, and the memory back
   after ``_release_executables``;
   log: at the shapes of the held-plan log matvec (layer particles, f64,
   G = log, caps 256/1024), M2L, P2L and the fused evaluation in their
   log branches held against their plain versions and timed with their
   bounds as in 3, and ``apply_charges`` on a held plan run as the
   graphs phase runs an entry point, its real part against the f64
   direct log sum at 4096 targets and against the reference backend;
   block: at the shapes of the block matvec (2^20 nodes on the eight wire
   contours, f64, G = log, caps 8/16, 8 densities), the upward pass, M2L,
   P2L and the fused evaluation for 8 densities on one plan against
   their plain versions, a second launch bitwise equal, each timed with
   its share of the bound (``bench/metrics/_work_block.py``) beside its
   single-density launch, and ``apply_charges`` of the (8, N) block
   against eight single-density calls on the same plan, replayed (rows
   within F64_TOL; the block at most half the eight; medians and phase
   splits of both);
   after each group of phases the programs held, the pool bytes charged
   against the programs' memory budget, the solvers it released, and
   the memory reserved with its peak; nothing is released between
   phases but by the solver LRU and that budget;
6. seam: the time-stepping shape of a vortex-method user on the main
   path's uniform config, in f32 and f64: five steps of
   ``refresh(z_k, q)`` then ``apply_plan(plan)`` on particles moved by
   1e-4 N(0, 1) a step (clamped to the unit square), each step's phi
   bitwise ``apply(z_k, q)``'s; ``refresh`` launches classify once a
   level,
   ``apply_plan`` M2L, P2L and the fused evaluation once each (eager,
   captured, then replayed);
   ``trace_counts`` 1 / 1 on a fresh solver; ``stats`` without overflow
   and its pair counts those of a numpy count of the plan's lists;
   refresh and apply_plan ms (host clock ending in a synchronize,
   median of the steps after the first) beside apply's; one step on the
   per-phase backend with its launches;
7. tune: ``FmmSolver.tune`` on the main path's problems from the default
   caps, in f32 and f64: its trials, tuned caps and host time, one
   classify launch a level and probe; the tuned solver's
   ``apply_checked`` launches the four main-path kernels (classify once
   a level, the others once) and meets the accuracy
   bound at the sampled targets; its apply ms beside the main path's;
8. guard: (a) ``FmmSolver.build(cfg).guarded().apply_guarded`` from the
   default caps on normal and layer particles, in f32 and f64: the walk
   primary -> caps*... ends ok without degrading or warning, launches
   the four kernels once a rung, meets the accuracy bound (in f64, where
   its caps are the main path's, within F64_TOL of its phi); the walk's
   host ms; at the final caps the promoted guard's,
   ``apply_with_health``'s and the plain apply's ms in rounds of
   alternating order, and one ``host_health`` read's; (b)
   ``refresh_guarded`` + ``apply_plan`` on the layer particles: one
   escalation that promotes, then steps on moved particles without
   retries, refresh_guarded ms beside refresh ms and beside refresh plus
   the guard's host read; (c) the five cases of
   ``repro_torch.testing.faults``' smoke walk at N = 2^16, f64, "cuda":
   each case's rungs and final backend, its launches and host ms per
   rung through the guard's ``rung_hook`` (the degrade rung launches
   classify and M2L only, the direct rung none), one
   ``BackendDowngradeWarning`` for each of those two rungs, phi against
   the f64 direct sum, a poisoned input refused;
   the direct rung's ms beside one ``nbody_direct`` call on the same
   particles;
9. serve: (a) the default ``ServePlane()`` (lattice 64 .. 16,384, B <= 8,
   f32, p = 17, caps 48/128) on two waves of 64 ragged requests with
   10% poison (seeds 0 and 1) and the 9-size wave served twice: every
   clean request "ok" or "recovered" on "cuda" within the f32 accuracy
   bound of the f64 direct sum at every target, each poison rejected
   with the reference's typed error, no ``BackendDowngradeWarning``,
   the four main-path kernels a guard attempt a dispatch (classify once
   a level, the others once; classify and P2L none at nlevels 0); on
   the warm waves a dispatch hits the cache exactly when its shape
   class was dispatched before, a hit
   re-prepares nothing, and a bucket seen before builds no leaf layout;
   requests/s, p50/p99 latency, padded-row share, cache counters and
   median dispatch ms, program calls by kind (eager / capture / replay),
   programs held and memory reserved a wave, and a
   naive loop of one unpadded
   ``FmmSolver.apply`` a request beside the second wave; (b) 8 requests
   of 10^5-10^6 particles on the lattice 2^17 .. 2^20 (B <= 4) in f32
   and f64, the same gates at N_SAMPLE targets a request; (c)
   ``repro_torch.testing.serve_faults``' soak with its gates, every
   clean request on "cuda" but the designed ``oversize->direct`` ones,
   each warning once;
10. degenerate: the layouts of ``tests/test_torch_helpers.py``
   (all-coincident, one distinct point in a cluster, collinear, empty
   quadrants, zero charges, scales 1e-9 / 1e-3 / 1e6) at n = 256, f64,
   through ``apply_with_health`` on a fresh "cuda" solver each: the
   first (eager) call against the port's run on the CPU (the same
   ``host_health``, finite and NaN pattern, phi within F64_TOL where
   finite) and the third call (a replay) bitwise the first;
11. examples: the three twins in ``examples/`` through their ``run``
   functions on the card: ``torch_vortex_dynamics`` at N = 2^20, p = 17,
   f32, VORTEX_STEPS RK2 steps of ``refresh_guarded`` + ``apply_plan``
   (the first step's velocity against the f64 direct sum at N_SAMPLE
   targets; every guard report on "cuda" without degradation, no
   downgrade warning, the example's drift assert, every program
   replaying from its third call; re-plans, caps, the replayed
   ``refresh_guarded`` / ``apply_plan`` ms, program calls by kind);
   ``torch_quickstart`` at N = 2^20, normal, f64, B = 4 (its asserts,
   its 512-point error under the f64 bound, ``apply_batched`` on
   "cuda"; apply and batched ms); ``torch_serve_traffic`` at its
   defaults (clean requests "ok" / "recovered" on "cuda", poisons
   refused with the reference's errors, one warning a designed
   ``oversize->direct`` request; requests/s a wave); each example runs
   the four main-path kernels;
12. substrate: ``train_loop`` around the vortex twin's RK2 steps at
   2^20 with the impulse drift as its loss: checkpoints every
   SUB_EVERY steps, a ``FailureInjector`` stop at step SUB_FAIL,
   ``restore_latest`` onto the card (bitwise the saved state), resumed
   to SUB_STEPS; the final z bitwise an uninterrupted run's when no run
   re-planned (else within 1e-5); save (snapshot) and restore ms and
   the checkpoint's bytes;
13. parallel: the multi-device substrate (``repro_torch.parallel``,
   ``repro_torch.launch.mesh``, the elastic checkpoint path): (a) one
   NCCL rank, mesh (1, 1, 1) ("pod", "data", "model"):
   ``make_compressed_value_and_grad`` on a 2^20 f32 tree (its gradient
   within half a quantum of the exact one, the loss exact, the errors
   the residual), ``ef_allreduce`` against a plain f32 ``all_reduce``
   (host ms, and the bytes of each read from a profiler trace by
   ``collective_bytes_traced``); (c) on that mesh the vortex state
   (2^20 f32 z and gamma) saved after RESUME_STEPS RK2 steps, restored
   with ``shardings=`` as replicated DTensors (bitwise the saved state)
   and RESUME_STEPS steps resumed through the replayed programs, bitwise
   the uninterrupted run, running the four main-path kernels; (b)
   PAR_RANKS ranks sharing the card over gloo (NCCL refuses two ranks
   on one device), mesh (2, 2, 2): the reference test's problem within
   its bounds, and over FEEDBACK_STEPS steps with the errors fed back
   the gradient plus the pods' mean error equal to the pods' mean
   exact gradient plus error fed in, within f32 rounding;
   TELESCOPE_STEPS error-feedback steps of a 2^20 tree whose sent sum
   telescopes, and ``ef_allreduce`` against ``all_reduce`` over "pod";
   a failing rank fails the phase;
14. per-phase path: the "cuda" backend without its fused hooks,
   registered as "cuda-phases", on the same problems: M2L once per
   level, L2P and P2P once, classify once a level, P2L once, the fused
   evaluation
   never; the same accuracy bounds; in f64 phi within 1e-10 of the main
   path's and the reference backend's;
15. batched: ``apply_batched`` with B = 4 at N = 2^20 in f32 on both
   paths — the same launches as one apply, each row equal to that
   problem's ``apply``;
16. direct baseline: ``nbody_direct`` all-pairs at N = 2^20 in f32 and
   f64 (one launch each, its source splits printed), timed beside the
   FMM apply, and the paper's Fig. 5.5 sweep N = 2^9 .. 2^20 with the
   break-even N (the FMM apply replayed; its first call printed);
17. prints one JSON line with every kernel's launches (from the host in
   the main path's run), error, times and
   bound (N-body also its splits at both shapes, K, registers and SASS
   instructions a pair; M2L its wide-row times and shared memory), the
   card line again, and last
   ``{"ok": true, "device": {...}}``.

Needs one CUDA card; without one it exits nonzero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N = 1 << 20
P_TERMS = 17
SEED = 0
DISTS = ("uniform", "normal", "layer")
N_SAMPLE = 4096
KERNEL_REPS = 20
PLAIN_REPS = 5
# Kernel vs plain version, per element (``scaled_err``): |kernel - plain|
# over |plain| plus the mean |plain| of its column (one coefficient order
# of M2L and P2L, one particle slot of the evaluation), so neither the
# largest output (the nearest pair's, for the evaluation) nor an element
# that cancels to near zero sets the scale.
F64_TOL = 1e-10
# In f32 both versions round every operation to f32 but sum in different
# orders (and the kernels contract products into FMAs), so they differ by
# about the f32 rounding error of each. The smoke prints that level (the
# plain version in f32 against itself in f64 on the same inputs) beside
# each f32 comparison; the limits sit about ten times above it. P2L's
# high orders are sums of many terms of both signs that cancel, so its
# level is the highest. A dropped or wrong term moves the elements it
# touches by far more than any of these limits.
F32_KERNEL_TOL = {"m2l": 2e-5, "p2l": 1e-4, "eval_fused": 1e-5, "p2p": 1e-5,
                  "l2p": 1e-5, "nbody": 1e-4, "upward": 1e-5}
# The direct N-body sum of a target runs over all 2^20 sources, whose
# terms cancel: phi is far smaller than the sum of the terms' magnitudes
# S_i = sum_j |q_j| / |x_j - y_i|, and an f32 sum's rounding error grows
# with S_i, not with |phi_i|. So in f32 the N-body gate scales each
# target's error by S_i (in f64 by |phi| plus its mean, as every other
# kernel).
# The per-phase backend: the "cuda" backend with its fused hooks removed.
PHASES = "cuda-phases"
# m2l_wide: weak-list widths (the default cap, and two that the M2L kernel
# refused before it staged its rows in chunks: above 7,008 (f64) and
# 7,654 (f32) slots at p = 17), source boxes (rows empty) and target
# boxes (4,099 boxes in all: the kernel's 7-box tiles leave a ragged one)
WIDE_W = (128, 7680, 12288)
WIDE_BOXES = (3000, 1099)
# seam: time steps (a program runs eagerly at its first call and
# captures at its second, so steps 3-5 time replays), and the step of
# the particles' random walk
SEAM_STEPS = 5
SEAM_EPS = 1e-4
# the fault walk's size: its direct rung costs N^2 pair terms in plain
# torch on the card (about 0.3-0.5 s at 2^16; 256 times that at 2^20)
FAULT_N = 1 << 16
# guard: rounds of (apply, apply_with_health, apply_guarded), the order
# reversed every other round
GUARD_ROUNDS = 6
# guard: time steps of (refresh, refresh + the guard's host read,
# refresh_guarded) on moved particles, the order rotated every step
REFRESH_STEPS = 9
# serve: the ragged waves of the default plane (seeds, requests a wave,
# median request size), and the typed rejection of each poison kind (the
# reference's, ``tests/test_serve.py``)
SERVE_SEEDS = (0, 1)
SERVE_REQUESTS = 64
SERVE_MEDIAN = 2048
POISON_ERRORS = {"nan-q": "NonFiniteInputError",
                 "inf-z": "NonFiniteInputError", "real-z": "DTypeError",
                 "empty": "ShapeError"}
# serve (b): the lattice 2^17 .. 2^20 and 8 requests of 10^5-10^6
# particles (the users' scale, PERF.md section 1)
BIG_LATTICE = (1 << 17, 1 << 20)
BIG_WAVE = dict(seed=2, median_n=300_000, sigma=0.6, n_min=100_000,
                n_max=1 << 20)
# degenerate: the layouts of tests/test_torch_helpers.py (its size and
# config), each held against the port's own run on the CPU
DEGENERATE = dict(n=256, nlevels=2, p=12, dtype="f64", strong_cap=32,
                  weak_cap=64)
# examples: the vortex twin's RK2 steps at N (p = P_TERMS, the example's
# f32), the quickstart twin's batch at N (f64, normal), and the serve
# twin at its defaults; the vortex steps of the substrate's runs (a
# failure before SUB_FAIL, a checkpoint every SUB_EVERY steps) and its
# time step
VORTEX_STEPS = 12
QUICK_BATCH = 4
SUB_STEPS = 8
SUB_FAIL = 5
SUB_EVERY = 2
VORTEX_DT = 2e-4
# graphs: replays and eager runs timed per entry point, and the batch
# width of apply_batched
GRAPH_REPS = 5
GRAPH_B = 4
# Fig. 5.5 sweep of the direct baseline against the FMM
SWEEP = [1 << k for k in range(9, 21)]
# log: the kernel G = q log(z - x) at the shapes of the held-plan log
# matvec (bench/configs/fmm2d-log-bie-f64.json): layer particles at N,
# f64, caps 256/1024; its three kernels with a log branch; the operations
# of a complex log term (log and atan2, product, sum) and those a
# near-field pair adds over the harmonic pair's (work_of)
LOG_CAPS = (256, 1024)
LOG_KERNELS = ("m2l", "p2l", "eval_fused", "upward")
# block: K densities on one held plan of nodes on the eight wire contours
# (the f64-log-mtl8-block cell: f64, G = log, caps 8/16)
BLOCK_K = 8
BLOCK_CAPS = (8, 16)
BLOCK_REPS = 20
# device names of the K-density kernels -> their libraries
BLOCK_OF = {"eval_block": "eval_fused", "m2l_block": "m2l",
            "p2l_block": "p2l", "upward_block": "upward"}
LOG_TERM = 14
LOG_PAIR = 2
# accuracy bounds of the JAX reference's own tests
# (tests/test_fmm_accuracy.py:29 in f64, :41 in f32)
ACC_BOUND = {"f64": 2e-6, "f32": 5e-4}

# H100 SXM data-sheet peaks (vector f32 / f64 outside the tensor cores,
# HBM3 bandwidth)
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
PEAK_BYTES = 3.35e12
# Peak of a dense matrix product (work_of's third term): f64 on the FP64
# tensor cores (mma m8n8k4, data sheet); f32 stays at the vector rate,
# since TF32's 10-bit mantissa is too coarse for the f32 results.
PEAK_DENSE = {"f32": 67e12, "f64": 67e12}

KERNELS = {
    "classify": ("src/repro_torch/kernels/csrc/classify.cu",
                 "src/repro/kernels/topology/classify.py:85"),
    "m2l": ("src/repro_torch/kernels/csrc/m2l.cu",
            "src/repro/kernels/m2l/m2l.py:106"),
    "p2l": ("src/repro_torch/kernels/csrc/p2l.cu",
            "src/repro/kernels/eval/p2l.py:120"),
    "eval_fused": ("src/repro_torch/kernels/csrc/eval_fused.cu",
                   "src/repro/kernels/eval/fused.py:140"),
    "p2p": ("src/repro_torch/kernels/csrc/p2p.cu",
            "src/repro/kernels/p2p/p2p.py:74"),
    "l2p": ("src/repro_torch/kernels/csrc/l2p.cu",
            "src/repro/kernels/l2p/l2p.py:33"),
    "nbody": ("src/repro_torch/kernels/csrc/nbody.cu",
              "src/repro/kernels/nbody/nbody.py:40"),
    # no Pallas kernel: the reference's upward pass is plain jnp
    "upward": ("src/repro_torch/kernels/csrc/upward.cu",
               "none (src/repro/core/fmm.py:143, plain jnp)"),
}


def want_counts(cfg, **kw) -> dict:
    """Launches per kernel of one main-path apply at ``cfg`` (classify
    once a tree level, the upward pass in ``upward_launches``), with
    ``kw`` changed."""
    from repro_torch.kernels import upward_launches

    want = {"classify": cfg.nlevels, "upward": upward_launches(cfg.nlevels),
            "m2l": 1, "p2l": 1, "eval_fused": 1, "p2p": 0, "l2p": 0,
            "nbody": 0}
    want.update(kw)
    return want


def phase_counts(cfg) -> dict:
    """Launches per kernel of one per-phase apply: M2L once per level."""
    return want_counts(cfg, m2l=max(cfg.nlevels, 1), eval_fused=0, p2p=1,
                       l2p=1)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


class ProgramCall(NamedTuple):
    """One program call: its entry point, its kind ("eager": a program's
    first call, "capture": its second, which captures and then replays
    once, or "replay"), the launches its capture recorded, and which
    program it was (the id of its solver's ``ProgramSet`` and its key)."""

    entry: str
    kind: str
    recorded: dict
    program: tuple


# Every program call of the run. Filled by ``observe_programs``, read by
# ``counting``.
PROGRAM_CALLS: list = []
# a kernel's name on the card's timeline: <name>_kernel<...>(...)
KERNEL_NAME = re.compile(r"\b([a-z0-9_]+?)_kernel\b")


class Calls(NamedTuple):
    """What the kernel wrappers and the programs did in one counted
    call: launches from the host (``kernels.launch_counts``), launches
    recorded into a graph being captured (``kernels.build.
    recorded_counts``), and the program calls made (``PROGRAM_CALLS``)."""

    host: dict
    recorded: dict
    programs: list


def observe_programs() -> None:
    """Log every ``Program`` call into PROGRAM_CALLS, with its kind (once
    per process: a second call changes nothing)."""
    from repro_torch.solver.program import Program

    real = Program.__call__
    if getattr(real, "observed", False):
        return

    def observed(self, *args):
        kind = ("replay" if self.captured else
                "eager" if self.calls == 0 else "capture")
        out = real(self, *args)
        PROGRAM_CALLS.append(ProgramCall(self.entry, kind,
                                         dict(self.recorded),
                                         (id(self._owner()), self.key)))
        return out

    observed.observed = True
    Program.__call__ = observed


@contextlib.contextmanager
def counting(torch):
    """Count what runs inside the block: on exit the yielded dict holds
    ``calls`` (``Calls``) and ``secs`` (host seconds, the block ending
    in a synchronize)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.build import recorded_counts

    box = {}
    torch.cuda.synchronize()
    reset_launch_counts()
    rec, n = recorded_counts(), len(PROGRAM_CALLS)
    t0 = time.perf_counter()
    yield box
    torch.cuda.synchronize()
    box["secs"] = time.perf_counter() - t0
    after = recorded_counts()
    box["calls"] = Calls(launch_counts(),
                         {k: after[k] - rec[k] for k in after},
                         PROGRAM_CALLS[n:])


def counted(fn, torch):
    """(fn(), its ``Calls``, its host seconds ending in a synchronize)."""
    with counting(torch) as box:
        out = fn()
    return out, box["calls"], box["secs"]


def ran(c: Calls, want: dict, n: int = 1) -> bool:
    """Whether a counted call ran ``want`` in each of its ``n`` program
    calls, by measured counts only: the program calls that ran eagerly
    or captured launched or recorded ``want`` each (the wrappers' counts
    over the call), and each replay replayed a graph whose capture
    recorded ``want`` (what a replay runs on the card is read from a
    profiler trace in the graphs phase)."""
    fresh = sum(p.kind != "replay" for p in c.programs)
    return (len(c.programs) == n
            and all(c.host[k] + c.recorded[k] == want[k] * fresh
                    for k in KERNELS)
            and all(p.recorded == want for p in c.programs
                    if p.kind == "replay"))


def calls_note(c: Calls) -> str:
    """A counted call's launches from the host, recorded into captures,
    and its program calls by kind (nonzero kernels only)."""
    nz = lambda d: {k: v for k, v in d.items() if v}  # noqa: E731
    kinds = "/".join(p.kind for p in c.programs) or "none"
    return f"host {nz(c.host)}, recorded {nz(c.recorded)}, programs {kinds}"


def replay_kernels(call, torch):
    """(call(), launches per kernel of KERNELS on the card's timeline): a
    ``torch.profiler`` trace of the call, its device events counted by
    kernel name (``<name>_kernel``)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = call()
        torch.cuda.synchronize()
    counts = dict.fromkeys(KERNELS, 0)
    for e in prof.events():
        m = KERNEL_NAME.search(e.name)
        name = m and BLOCK_OF.get(m.group(1), m.group(1))
        if str(e.device_type).endswith("CUDA") and name in counts:
            counts[name] += 1
    return out, counts


def programs_held() -> int:
    """Programs held by the solvers of the ``FmmSolver.build`` cache."""
    from repro_torch.solver import FmmSolver
    return sum(s._compiled_program_count()
               for s in FmmSolver._cached_solvers())


def memory_line(tag: str, torch) -> None:
    """Print the programs the cached solvers hold, the graph-pool bytes
    charged to all programs against their budget, the solvers the budget
    has released so far, and the memory reserved now and at its peak
    since the last line (then reset the peak)."""
    from repro_torch.solver import program_memory

    mem = program_memory()
    print(f"memory[{tag}]: cached solvers hold {programs_held()} programs;"
          f" pools charged {mem['held']} B over {mem['solvers']} solvers "
          f"(budget {mem['budget']} B; released so far "
          f"{mem['released_sets']} solvers, {mem['released_bytes']} B); "
          f"reserved {torch.cuda.memory_reserved()} B, peak "
          f"{torch.cuda.max_memory_reserved()} B", flush=True)
    torch.cuda.reset_peak_memory_stats()


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def demangle(sym: str) -> str:
    """``_Z14classify_kernelIfEv...`` -> ``classify_kernel<float>`` (with
    ``, log`` for the log-kernel instantiation and the integer template
    arguments, e.g. ``p2l_kernel<double, log, 18, 64>``)."""
    m = re.match(r"_Z(\d+)", sym)
    if not m:
        return sym
    start = m.end()
    name = sym[start:start + int(m.group(1))]
    rest = sym[start + int(m.group(1)):]
    t = {"f": "float", "d": "double"}.get(rest[1:2], "?")
    log = ", log" if rest.startswith(("IfLb1E", "IdLb1E")) else ""
    ints = "".join(f", {v}" for v in
                   re.findall(r"Li(\d+)E", rest.split("Ev", 1)[0]))
    return f"{name}<{t}{log}{ints}>"


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel: name, registers, static shared
    memory and spills (from ``-Xptxas -v``; the kernels' shared memory is
    dynamic: each library reports its own, ``CudaLibrary.smem_bytes``)."""
    lines, name, spill = [], None, ""
    for raw in log.splitlines():
        s = raw.strip()
        if "Compiling entry function" in s:
            name = demangle(s.split("'")[1]) if "'" in s else s
        elif "spill stores" in s:
            spill = s.split("bytes stack frame,")[-1].strip()
        elif "Used" in s and "registers" in s and name:
            lines.append(f"  {name}: {s.split(':', 1)[1].strip()}; {spill}")
    return lines


def sass_pair_loop(sass: str, kernel: str, marker: str = "MUFU.RCP") -> dict:
    """The innermost loop of each instantiation of ``kernel`` in ``sass``
    (``cuobjdump -sass`` output; a loop is a branch back to a lower
    address) that runs the most ``marker`` instructions (one reciprocal
    estimate a pair): its instructions, pairs (markers), instructions a
    pair and its opcode mix."""
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = demangle(block.split("\n", 1)[0].strip())
        if not name.startswith(kernel):
            continue
        ops, loops = [], []
        for addr, pred, opcode, branch in re.findall(
                r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                r"(?:\s+0x([0-9a-f]+))?", block):
            ops.append((int(addr, 16), opcode))
            if opcode == "BRA" and branch and int(branch, 16) <= ops[-1][0]:
                loops.append((int(branch, 16), ops[-1][0]))

        def pairs(lo, hi):
            return sum(o.startswith(marker) for a, o in ops if lo <= a <= hi)

        inner = [(lo, hi) for lo, hi in loops if pairs(lo, hi) and not any(
            (a, b) != (lo, hi) and lo <= a <= b <= hi and pairs(a, b)
            for a, b in loops)]
        if not inner:
            continue
        lo, hi = max(inner, key=lambda lh: pairs(*lh))
        body = [o.split(".")[0] for a, o in ops if lo <= a <= hi]
        mix = {o: body.count(o) for o in sorted(set(body), key=body.count,
                                                 reverse=True)}
        out[name] = dict(instructions=len(body), pairs=pairs(lo, hi),
                         per_pair=len(body) / pairs(lo, hi), mix=mix)
    return out


def nbody_code() -> dict:
    """Per dtype: the built N-body kernel's targets a thread (K), its
    registers (``cuobjdump -res-usage``) and the SASS instructions a pair
    of its pair loop."""
    from repro_torch.kernels.build import LIBRARIES, nvcc_path
    from repro_torch.kernels.nbody import nbody as nb

    tool = Path(nvcc_path()).parent / "cuobjdump"

    def dump(flag):
        return subprocess.run([str(tool), flag,
                               str(LIBRARIES["nbody"].target())],
                              capture_output=True, text=True,
                              check=True).stdout

    sass = sass_pair_loop(dump("-sass"), "nbody_kernel")
    regs = {demangle(f): int(r) for f, r in re.findall(
        r"Function (\S+):\s*REG:(\d+)", dump("-res-usage"))}
    # a wrapper from before the register blocking: one target a thread
    k_of = getattr(nb, "TARGETS_PER_THREAD", {4: 1, 8: 1})
    out = {}
    for dt, t, elem in (("f32", "float", 4), ("f64", "double", 8)):
        name = f"nbody_kernel<{t}>"
        loop = sass.get(name)
        out[dt] = dict(k=k_of[elem], registers=regs.get(name),
                       sass_per_pair=None if loop is None else round(
                           loop["per_pair"], 3),
                       sass_loop=loop)
    return out


def nbody_splits(n: int, m: int, dt: str, torch):
    """Source splits of an N-body launch of n targets and m sources (1
    for a wrapper with no split)."""
    from repro_torch.kernels.nbody import nbody as nb

    plan = getattr(nb, "nbody_plan", None)
    if plan is None:
        return 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return plan(n, m, 8 if dt == "f64" else 4, sms)[1]


def scaled_err(a, b) -> float:
    """max over elements of |a - b| / (|b| + mean |b| of its column, the
    last axis indexing columns)."""
    mag = b.abs()
    floor = mag.reshape(-1, mag.shape[-1]).mean(dim=0)
    # an all-zero column: both zero -> 0, a nonzero kernel value -> huge
    floor = floor.clamp_min(1e-300 if mag.dtype.itemsize == 8 else 1e-37)
    return float(((a - b).abs() / (mag + floor)).max())


def rel_err(a, b) -> float:
    """max |a - b| / max |b| (normwise, so cancellation cannot inflate it)."""
    den = float(b.abs().max())
    return float((a - b).abs().max()) / (den if den > 0 else 1.0)


def time_cuda(fn, reps: int, torch, warmup: int = 2) -> float:
    """Median milliseconds of ``reps`` calls, each between CUDA events,
    after ``warmup`` warm-up calls (host work inside a call counts)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def launches_of(name: str, cfg) -> int:
    """Launches one call of kernel ``name``'s wrapper makes at ``cfg``."""
    if name == "upward":
        from repro_torch.kernels import upward_launches
        return upward_launches(cfg.nlevels)
    return cfg.nlevels if name == "classify" else 1


def staged_launch(name: str, call, launches: int = 1):
    """Run ``call`` once, recording the ``launches`` launches it makes of
    kernel ``name`` (classify: one a tree level); returns a function that
    repeats exactly those launches, in order, on the same staged operands
    and outputs (no wrapper work around them)."""
    from repro_torch.kernels.build import LIBRARIES

    lib = LIBRARIES[name]
    launch, seen = lib.launch, []

    def record(symbol, *args):
        seen.append((symbol, args))
        return launch(symbol, *args)

    lib.launch = record
    try:
        call()
    finally:
        del lib.launch
    check(len(seen) == launches,
          f"{name}: {len(seen)} launches in one call (want {launches})")
    return lambda: [launch(symbol, *args) for symbol, args in seen]


def time_kernel(fn, reps: int, torch, warmup: int = 2) -> float:
    """Milliseconds per launch of ``reps`` back-to-back calls of ``fn``
    between one pair of CUDA events, after ``warmup`` calls. A spin
    kernel (``torch.cuda._sleep``) holds the stream until the host has
    enqueued every call, so no host time between launches is counted;
    the spin is lengthened until the start event is still pending when
    the last call is enqueued."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 22
    while True:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued_first = not a.query()
        b.synchronize()
        if queued_first:
            return a.elapsed_time(b) / reps
        check(cycles < 1 << 34, "the host could not keep ahead of the card")
        cycles *= 4


def work_of(name: str, args, kwargs, dt: str) -> tuple[float, float, float]:
    """(flops, bytes, dense flops) the function needs on these inputs:
    each input read once and each output written once; flops counted on
    the list entries that are actually occupied (transcendentals and
    divisions as one operation each); the dense flops are the part of
    the flops that is a dense matrix product (M2L's product with H).
    The log kernel (G = q log(z - x)) reads and writes what the harmonic
    one does; its operations add a complex log (a log and an atan2, 6
    operations), a product and a sum (14 in all) to each M2L entry, each
    P2L particle and each M2P target, and 2 to each near-field pair
    (``bench/metrics/_work_log.py``); the rest of its work is counted as
    the harmonic kernel's, a lower bound."""
    flops, nbytes, dense = _work_of(name, args, kwargs, dt)
    if name == "m2l" and args[7] == "log":
        flops += LOG_TERM * int((args[0] >= 0).sum())
    elif kwargs.get("kernel") == "log" and name == "p2l":
        flops += LOG_TERM * int((args[0] >= 0).sum()) * args[4].shape[-1]
    elif kwargs.get("kernel") == "log" and name == "eval_fused":
        p2p, m2p, zr = args[0], args[1], args[2]
        n = zr.shape[-1]
        flops += LOG_PAIR * int((p2p >= 0).sum()) * n * n
        if m2p is not None:
            flops += LOG_TERM * int((m2p >= 0).sum()) * n
    return flops, nbytes, dense


def _work_of(name: str, args, kwargs, dt: str) -> tuple[float, float, float]:
    """``work_of`` of the harmonic kernel."""
    sz = 8 if dt == "f64" else 4
    if name == "upward":
        # P2M: w = (x - z0)/rho and q/rho (4 operations), then p complex
        # products and sums a particle; M2M a child box: p ratio powers
        # and scalings (3p), the Pascal pass (p(p-1)/2 complex
        # multiply-adds), the log-source correction (16p) and its share
        # of the parent's sum (2(p+1)). z and q read once, the leaf
        # bounds of the static layout, every box's center and radius,
        # every box's p+1 coefficients written once.
        tree, c, _ = args
        p, B = c.p, tree.z.shape[0]
        leaves = tree.radii[-1].shape[-1]
        boxes = sum(x.numel() for x in tree.radii)
        children = boxes - B
        flops = (tree.z.numel() * (4 + 8 * p)
                 + children * (3 * p + 4 * p * (p - 1) + 16 * p + 2 * (p + 1)))
        nbytes = (4 * tree.z.numel() * sz + 4 * (leaves + 1)
                  + 3 * boxes * sz + 2 * boxes * (p + 1) * sz)
        return float(flops), float(nbytes), 0.0
    if name == "classify":
        # one launch a level: the parent level's strong lists and the
        # level's centres and radii read; the strong and weak lists, the
        # counts (5 a row) and at the leaf the p2p, p2l and m2p lists
        # written; each candidate (4 a parent entry) tested
        from repro_torch.core.topology import build_connectivity
        tree, c = args
        S, W = c.strong_cap, c.weak_cap
        rows = [r.numel() for r in tree.radii[1:]]
        pairs = 4 * sum(int((st >= 0).sum())
                        for st in build_connectivity(tree, c).strong[:-1])
        nbytes = (sum(r * S + 3 * r * sz + 4 * r * (S + W + 5)
                      for r in rows) + 12 * rows[-1] * S)
        return 16.0 * pairs, float(nbytes), 0.0
    if name == "m2l":
        weak, ar = args[0], args[1]
        P = ar.shape[-1]
        p = P - 1
        entries = int((weak >= 0).sum())
        per = 4 * P * P + 6 * P + 12 * p + 8 * P
        # weak lists, multipoles, centers and radii, H; the result
        nbytes = (weak.numel() * 4 + 2 * ar.numel() * sz
                  + 3 * args[3].numel() * sz + P * P * sz
                  + 2 * ar.numel() * sz)
        return float(per * entries), float(nbytes), 4.0 * P * P * entries
    if name == "p2l":
        lists, xr = args[0], args[4]
        p = kwargs["p"]
        n = xr.shape[-1]
        entries = int((lists >= 0).sum())
        per_particle = 14 + 8 * (p + 1)
        # the particle planes of the distinct source leaves the lists
        # reference, per problem: no other leaf's particles are read
        sources = sum(int(row[row >= 0].unique().numel()) for row in lists)
        nbytes = (lists.numel() * 4 + 3 * args[1].numel() * sz
                  + 4 * sources * n * sz + 2 * args[1].numel() * (p + 1) * sz)
        return float(entries * n * per_particle), float(nbytes), 0.0
    if name == "p2p":
        lists, zr = args[0], args[1]
        B, nb, n = zr.shape
        pairs = int((lists >= 0).sum()) * n * n
        nbytes = lists.numel() * 4 + 6 * zr.numel() * sz + args[5].numel() * 4
        return 14.0 * pairs, float(nbytes), 0.0
    if name == "l2p":
        br, tr, rk = args[0], args[2], args[4]
        p = kwargs["p"]
        nbytes = 2 * br.numel() * sz + 4 * tr.numel() * sz + rk.numel() * 4
        return float(tr.numel() * 8 * p), float(nbytes), 0.0
    if name == "nbody":
        n, m = args[0].numel(), args[2].numel()
        # the targets are sources too: each target's own pair drops out
        return 14.0 * (n * m - n), float((4 * n + 4 * m) * sz), 0.0
    # eval_fused
    p2p, m2p, zr = args[0], args[1], args[2]
    p = kwargs["p"]
    B, nb, n = zr.shape
    targets = B * nb * n
    pairs = int((p2p >= 0).sum()) * n * n
    flops = targets * 8 * p + pairs * 14
    nbytes = (p2p.numel() * 4 + 6 * zr.numel() * sz + args[6].numel() * 4
              + 2 * args[9].numel() * sz + 2 * zr.numel() * sz)
    if m2p is not None:
        flops += int((m2p >= 0).sum()) * n * (8 * p + 14)
        nbytes += (m2p.numel() * 4 + 2 * kwargs["ar"].numel() * sz
                   + 3 * kwargs["mrho"].numel() * sz)
    return float(flops), float(nbytes), 0.0


def ops_seconds(flops: float, dense: float, dt: str) -> float:
    """Least time of ``flops`` operations of which ``dense`` are a dense
    matrix product (each part at its own peak)."""
    return (flops - dense) / PEAK_FLOPS[dt] + dense / PEAK_DENSE[dt]


def capture(cfg, z, q, torch):
    """Build and evaluate one plan through the kernel hooks, raising the
    caps until no list overflows. Returns the config used, each kernel's
    operands (positional, keyword; "m2l_levels": the M2L operands of each
    level, as the per-phase path stages them) and the occupied list
    entries."""
    from repro_torch.core.fmm import effective_radii, fmm_build, fmm_evaluate
    from repro_torch.core.topology import MARGIN_CLASSES
    from repro_torch.kernels import (eval_fused_apply, eval_operands,
                                     fused_levels, l2p_operands,
                                     level_classify_cuda, m2l_fused_apply,
                                     m2l_operands, p2l_apply, p2l_operands,
                                     p2p_operands)
    from repro_torch.kernels.m2l.ops import m2l_planes
    from repro_torch.solver.guard import grow_caps

    cap = {}

    def m2l_rec(mult, weak, centers, c, rho):
        cap["m2l"] = (m2l_operands(mult, weak, centers, c, rho)[0], {})
        # the per-phase path's operands: one level a launch
        cap["m2l_levels"] = [m2l_planes(mult[l], weak[l], centers[l], c,
                                        rho[l]) for l in fused_levels(c)]
        return m2l_fused_apply(mult, weak, centers, c, rho)

    def p2l_rec(tree, conn, c, rho):
        cap["p2l"] = p2l_operands(tree, conn, c, rho)
        return p2l_apply(tree, conn, c, rho)

    def eval_rec(local, mult_leaf, tree, conn, c):
        cap["eval_fused"] = eval_operands(local, mult_leaf, tree, conn, c)
        cap["p2p"] = p2p_operands(tree, conn, c)
        cap["l2p"] = l2p_operands(local, tree, c)
        return eval_fused_apply(local, mult_leaf, tree, conn, c)

    while True:
        plan = fmm_build(z[None], q[None], cfg,
                         leaf_classify_impl=level_classify_cuda)
        if int(plan.conn.overflow.max()) == 0:
            break
        margins = dict(zip(MARGIN_CLASSES,
                           plan.conn.margins.min(dim=0).values.tolist()))
        cfg = grow_caps(cfg, margins)
    cap["classify"] = ((plan.tree, cfg), {})
    cap["upward"] = ((plan.tree, cfg, effective_radii(plan.tree, cfg)), {})
    fmm_evaluate(plan, cfg, m2l_fused_impl=m2l_rec, p2l_impl=p2l_rec,
                 eval_fused_impl=eval_rec)
    # the direct N-body sum: N_SAMPLE of the particles (in rank order) as
    # targets against all of them as sources, in the config's precision
    t = plan.tree
    pick = torch.randperm(cfg.n, generator=torch.Generator().manual_seed(
        SEED))[:N_SAMPLE].to(t.z.device)
    zr, zi, qr, qi = (x.to(cfg.torch_real).contiguous() for x in (
        t.z[0].real, t.z[0].imag, t.q[0].real, t.q[0].imag))
    cap["nbody"] = ((zr[pick], zi[pick], zr, zi, qr, qi), {})
    torch.cuda.synchronize()
    conn = plan.conn
    occupied = {"pairs": 4 * sum(int((s >= 0).sum())
                                 for s in conn.strong[:-1]),
                "weak": sum(int((w >= 0).sum()) for w in conn.weak),
                "p2p": int((conn.p2p >= 0).sum()),
                "p2l": int((conn.p2l >= 0).sum()),
                "m2p": int((conn.m2p >= 0).sum()),
                "p2l_leaf_max": int((conn.p2l >= 0).sum(-1).max()),
                "m2p_leaf_max": int((conn.m2p >= 0).sum(-1).max()),
                "pairs_nbody": N_SAMPLE * cfg.n - N_SAMPLE}
    return cfg, cap, occupied


def kernel_impls(cfg) -> dict:
    """Per kernel, (its wrapper, its plain version), each called as
    ``f(args, kwargs)`` on the operands that ``capture`` records."""
    from repro_torch import kernels
    from repro_torch.core.fmm import upward
    from repro_torch.core.topology import build_connectivity
    from repro_torch.kernels import (eval_fused_cuda, eval_fused_plain,
                                     l2p_cuda, l2p_plain, level_classify_cuda,
                                     m2l_cuda, m2l_plain, nbody_cuda,
                                     nbody_plain, p2l_cuda, p2l_plain,
                                     p2p_cuda, p2p_plain)

    impls = {
        # a whole connectivity build (operands: the tree and its config):
        # the kernel path against the plain path, every list, the margins
        # and the overflow
        "classify": (lambda a, k: leaves(build_connectivity(
                         *a, leaf_classify_impl=level_classify_cuda)),
                     lambda a, k: leaves(build_connectivity(*a))),
        "m2l": (lambda a, k: m2l_cuda(*a), lambda a, k: m2l_plain(*a)),
        "p2l": (lambda a, k: p2l_cuda(*a, **k),
                lambda a, k: p2l_plain(*a, **k)),
        "eval_fused": (lambda a, k: eval_fused_cuda(*a, **k),
                       lambda a, k: eval_fused_plain(*a, **k)),
        "p2p": (lambda a, k: p2p_cuda(*a, **k),
                lambda a, k: p2p_plain(*a, **k)),
        "l2p": (lambda a, k: l2p_cuda(*a, **k),
                lambda a, k: l2p_plain(*a, **k)),
        "nbody": (lambda a, k: nbody_cuda(*a), lambda a, k: nbody_plain(*a)),
        # the whole pass (operands: the tree, its config and the radii):
        # every box of every level, (real, imag)
        "upward": (lambda a, k: upward_planes(kernels.upward_cuda(*a)),
                   lambda a, k: upward_planes(upward(*a))),
    }
    if not hasattr(kernels, "upward_cuda"):  # a tree from before the kernel
        del impls["upward"]
    return impls


def upward_planes(levels) -> tuple:
    """Per-level (B, 4**l, P) multipoles -> the (real, imag) planes of
    every box, levels root first."""
    import torch

    flat = torch.cat(levels, dim=1)
    return flat.real.contiguous(), flat.imag.contiguous()


def magnitude_sum(tzr, tzi, szr, szi, qr, qi, torch) -> "torch.Tensor":
    """S_i = sum_{j : x_j != y_i} |q_j| / |x_j - y_i| per target, in f64
    (the scale of an all-pairs sum's rounding error)."""
    tzr, tzi = tzr.double(), tzi.double()
    qa = torch.hypot(qr.double(), qi.double())
    out = torch.zeros_like(tzr)
    chunk = max(1, (1 << 24) // tzr.numel())
    for s in range(0, szr.numel(), chunk):
        dx = szr[None, s:s + chunk].double() - tzr[:, None]
        dy = szi[None, s:s + chunk].double() - tzi[:, None]
        r = torch.hypot(dx, dy)
        out += torch.where(r > 0, qa[None, s:s + chunk] / r.clamp_min(1e-300),
                           torch.zeros_like(r)).sum(dim=-1)
    return out


def upcast(args, kwargs, torch):
    """The same operands with every f32 (complex64) tensor widened to f64
    (complex128), inside tuples and lists too, and a config's dtype
    f64."""
    import dataclasses

    from repro_torch.core.config import FmmConfig

    wide = {torch.float32: torch.float64, torch.complex64: torch.complex128}

    def up(a):
        if isinstance(a, torch.Tensor):
            return a.to(wide.get(a.dtype, a.dtype))
        if isinstance(a, FmmConfig):
            return dataclasses.replace(a, dtype="f64")
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            return type(a)(*map(up, a))
        if isinstance(a, (tuple, list)):
            return type(a)(map(up, a))
        return a
    return tuple(up(a) for a in args), {k: up(v) for k, v in kwargs.items()}


def log_config(dt: str):
    """The config of the log leg: the main path's at N in ``dt``, with
    G = log and caps LOG_CAPS."""
    import dataclasses

    from repro_torch.configs import fmm_config

    return dataclasses.replace(fmm_config(N, p=P_TERMS, dtype=dt),
                               kernel="log", strong_cap=LOG_CAPS[0],
                               weak_cap=LOG_CAPS[1])


def kernel_phase(dt: str, torch, kernel: str = "harmonic") -> list[dict]:
    """Each kernel against its plain version on the operands of the
    N = 2^20 plans of the three distributions; timings and bounds at the
    uniform plan (the default caps). With ``kernel="log"``: the kernels
    with a log branch (LOG_KERNELS) on the layer plan of ``log_config``,
    timed there; their rows are named ``<kernel>_log_<dt>``."""
    from repro_torch.configs import fmm_config
    from repro_torch.data import particles

    log = kernel == "log"
    dists, timed = (("layer",), "layer") if log else (DISTS, "uniform")
    entries_of = {"classify": ("pairs",), "m2l": ("weak",), "p2l": ("p2l",),
                  "eval_fused": ("p2p", "m2p"), "p2p": ("p2p",),
                  "l2p": (), "nbody": ("pairs_nbody",), "upward": ()}
    rows = {}
    for dist in dists:
        z, q = particles(dist, N, SEED)
        start = log_config(dt) if log else fmm_config(N, p=P_TERMS, dtype=dt)
        cfg, cap, occupied = capture(start, z, q, torch)
        print(f"plan[{kernel}/{dt}/{dist}]: caps strong={cfg.strong_cap} "
              f"weak={cfg.weak_cap}; occupied entries {occupied}", flush=True)
        if log:
            check((cfg.strong_cap, cfg.weak_cap) == LOG_CAPS,
                  f"log plan: caps raised to {cfg.strong_cap}/"
                  f"{cfg.weak_cap} (the matvec cell runs {LOG_CAPS})")
        for name, (kern, plain) in kernel_impls(cfg).items():
            if log and name not in LOG_KERNELS:
                continue
            args, kwargs = cap[name]
            first = kern(args, kwargs)
            second = kern(args, kwargs)
            ref = plain(args, kwargs)
            torch.cuda.synchronize()
            tag = (f"{name}[log/{dt}/{dist}]" if log else
                   f"{name}[{dt}/{dist}]")
            check(all(torch.equal(a, b) for a, b in zip(first, second)),
                  f"{tag}: second launch differs from the first")
            entries = " ".join(f"{k}={occupied[k]}" for k in entries_of[name])
            if name == "classify":
                check(all(torch.equal(a, b) for a, b in zip(first, ref)),
                      f"{tag}: kernel and plain version differ")
                err, abs_err, note = 0.0, 0.0, "bit-identical"
            else:
                kc, pc = torch.complex(*first), torch.complex(*ref)
                scale = None
                if name == "nbody":
                    # one column: every target's |phi| beside the mean
                    kc, pc = kc[:, None], pc[:, None]
                    if dt == "f32":
                        scale = magnitude_sum(*args, torch)[:, None]
                err = (scaled_err(kc, pc) if scale is None else
                       float(((kc - pc).abs() / scale).max()))
                abs_err = float((kc - pc).abs().max())
                tol = F64_TOL if dt == "f64" else F32_KERNEL_TOL[name]
                note = f"scaled_err={err:.3e} (limit {tol:g})"
                if scale is not None:
                    note = ("err/sum|q|/|x-y| = " + f"{err:.3e} (limit "
                            f"{tol:g}), scaled_err={scaled_err(kc, pc):.3e}")
                if dt == "f32":
                    wide = torch.complex(*plain(*upcast(args, kwargs, torch)))
                    if name == "nbody":
                        wide = wide[:, None]
                    lvl = (scaled_err(pc.to(wide.dtype), wide)
                           if scale is None else float(
                               ((pc.to(wide.dtype) - wide).abs()
                                / scale).max()))
                    note += (f", f32 rounding of the plain version "
                             f"{lvl:.3e}")
                    del wide
                check(err <= tol, f"{tag}: kernel vs plain {err:.3e} > {tol}")
            print(f"kernel {tag}: {entries}; {note}; abs_err={abs_err:.3e}",
                  flush=True)
            row = rows.setdefault(name, {
                "name": f"{name}_log_{dt}" if log else f"{name}_{dt}",
                "route": "cuda", "source": KERNELS[name][0],
                "replaces": KERNELS[name][1], "launches": 0,
                "max_abs_err": 0.0})
            row["max_abs_err"] = max(row["max_abs_err"], abs_err)
            if dist != timed:
                continue
            ms = time_kernel(staged_launch(name, lambda: kern(args, kwargs),
                                           launches_of(name, cfg)),
                             KERNEL_REPS, torch)
            plain_ms = time_cuda(lambda: plain(args, kwargs), PLAIN_REPS,
                                 torch, warmup=1)
            flops, nbytes, dense = work_of(name, args, kwargs, dt)
            t_ops, t_bytes = ops_seconds(flops, dense, dt), nbytes / PEAK_BYTES
            row.update(ms=ms, plain_ms=plain_ms,
                       bound_ms=1e3 * max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes",
                       library_ms=None)
            geom = ""
            if name == "nbody":
                # the all-pairs N = 2^20 time and bound replace these in
                # the direct-baseline phase; the plain version only runs
                # at this shape
                splits = nbody_splits(N_SAMPLE, N, dt, torch)
                row.update(plain_shape=[N_SAMPLE, N], ms_plain_shape=ms,
                           splits_plain_shape=splits)
                geom = f" splits={splits}"
            print(f"time {tag}:{geom} ms={ms:.4f} plain_ms={plain_ms:.3f} "
                  f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}; "
                  f"{flops:.3e} flop of which {dense:.3e} dense, {nbytes:.3e} "
                  f"B); share of bound "
                  f"{row['bound_ms'] / ms:.3f}", flush=True)
        del cap, z, q
        torch.cuda.empty_cache()
    return list(rows.values())


def grown_apply(solver_for, cfg, z, q, tag: str):
    """``apply_checked`` on the solver ``solver_for(cfg)`` returns, raising
    the caps until no list overflows. Returns (phi, the ``Calls`` of the
    last apply, the config used, the solver, the host seconds of that
    call)."""
    import torch

    from repro_torch.errors import CapOverflowError
    from repro_torch.solver.guard import grow_caps

    while True:
        solver = solver_for(cfg)
        try:
            phi, calls, secs = counted(lambda: solver.apply_checked(z, q),
                                       torch)
            return phi, calls, cfg, solver, secs
        except CapOverflowError as e:
            cfg = grow_caps(cfg, e.margins)
            print(f"{tag}: caps overflow {e.margins}; raised to "
                  f"strong_cap={cfg.strong_cap} weak_cap={cfg.weak_cap}",
                  flush=True)


def median_apply_s(solver, z, q, phi, tag: str, torch) -> float:
    """Median host seconds of three replayed applies: ``apply`` called
    twice first (a program's first call runs eagerly, its second
    captures), then three times more, each ending in a synchronize and
    each a replay that launches nothing from the host; every call must
    equal ``phi`` bitwise."""
    reps = []
    for i in range(5):
        again, c, secs = counted(lambda: solver.apply(z, q), torch)
        check(torch.equal(again, phi), f"{tag}: apply not bitwise "
              "reproducible")
        if i >= 2:
            check([p.kind for p in c.programs] == ["replay"]
                  and not any(c.host.values())
                  and not any(c.recorded.values()),
                  f"{tag}: apply call {i + 1}: {calls_note(c)} (want a "
                  "replay)")
            reps.append(secs)
    return statistics.median(reps)


def main_path(dt: str, torch) -> tuple[dict, dict]:
    """The served entry point on three distributions; returns the launch
    totals from the host and, per distribution, what the per-phase path
    is held against: the config used (caps raised where needed), the
    problem, the main path's phi and apply time (a replay; the first
    call's beside it), the direct sums at the sampled targets and, in
    f64, the reference backend's phi."""
    from repro_torch.configs import fmm_config
    from repro_torch.core.direct import direct_potential, rel_error_inf
    from repro_torch.data import particles
    from repro_torch.solver import FmmSolver

    cfg = fmm_config(N, p=P_TERMS, dtype=dt)
    totals = {k: 0 for k in KERNELS}
    out = {}
    gen = torch.Generator().manual_seed(SEED)
    sample = torch.randperm(N, generator=gen)[:N_SAMPLE].cuda()
    for dist in DISTS:
        z, q = particles(dist, N, SEED)
        tag = f"main[{dt}/{dist}]"

        def build(c):
            solver = FmmSolver.build(c)
            check(solver.dispatched["apply"] == "cuda",
                  f"dispatched {solver.dispatched}")
            return solver

        phi, calls, cfg, solver, first_s = grown_apply(build, cfg, z, q, tag)
        check(ran(calls, want_counts(cfg)), f"{tag}: launches per apply "
              f"{calls_note(calls)} (want {want_counts(cfg)})")
        for k in KERNELS:
            totals[k] += calls.host[k]
        secs = median_apply_s(solver, z, q, phi, tag, torch)
        # accuracy: f64 direct sum at sampled targets over all sources,
        # both from the positions as given and from the positions as the
        # solver sees them (rounded to the config's precision)
        zs = z.to(cfg.torch_complex).to(torch.complex128)
        d_given = direct_potential(z[sample], z, q)
        d_seen = direct_potential(zs[sample], zs, q)
        got = phi[sample].to(torch.complex128)
        err_given = rel_error_inf(got, d_given)
        err_seen = rel_error_inf(got, d_seen)
        print(f"{tag}: caps strong={cfg.strong_cap} weak={cfg.weak_cap}; "
              f"launches {calls_note(calls)}; apply {1e3 * secs:.1f} ms "
              f"(replayed; the apply_checked above {1e3 * first_s:.1f} ms); "
              f"rel_err_inf "
              f"vs direct: {err_given:.3e} (positions as given), "
              f"{err_seen:.3e} (positions in {dt})", flush=True)
        check(err_seen < ACC_BOUND[dt],
              f"{tag}: accuracy {err_seen:.3e} >= {ACC_BOUND[dt]}")
        ref = None
        if dt == "f64":
            ref = FmmSolver.build(cfg, backend="reference").apply(z, q)
            d = rel_err(phi, ref)
            print(f"{tag}: cuda vs reference backend {d:.3e}", flush=True)
            check(d <= F64_TOL, f"cuda vs reference {d:.3e} > {F64_TOL}")
        out[dist] = dict(cfg=cfg, z=z, q=q, phi=phi, secs=secs,
                         first_s=first_s, sample=sample, d_seen=d_seen,
                         ref=ref)
        del d_given
        torch.cuda.empty_cache()
    return totals, out


def leaves(obj) -> list:
    """The tensors of a nest of tuples (phi, a ``Health``, a plan)."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for o in obj for t in leaves(o)]


def eager_entry(solver, entry: str, *args):
    """What the program of ``entry`` runs, run eagerly: ``fmm_build`` /
    ``fmm_evaluate`` with the solver's backend hooks on (B, N) inputs
    (or a plan), phi unsorted to input order, the health plane beside it
    for ``apply_with_health``; ``apply_charges`` takes a plan and (B, N)
    charges."""
    from repro_torch.core.fmm import (fmm_build, fmm_evaluate, health_of,
                                      unsort, with_charges)

    cfg, be = solver.cfg, solver.backend
    if entry in ("apply_plan", "apply_charges"):
        plan = args[0] if entry == "apply_plan" else with_charges(*args)
        return unsort(fmm_evaluate(plan, cfg, **be.phase_impls()),
                      plan.tree.perm)
    z, q = args
    plan = fmm_build(z, q, cfg, **be.topology_impls())
    if entry == "refresh":
        return plan
    phi = unsort(fmm_evaluate(plan, cfg, **be.phase_impls()), plan.tree.perm)
    return (phi, health_of(plan, z, q, phi)) if entry.endswith("health") \
        else phi


def entry_calls(solver, z, q, zb, qb, plan) -> dict:
    """Per entry point of the graphs phase: (the solver's call, the same
    work run eagerly, the launches one run makes) on one problem (z, q),
    a batch (zb, qb) of GRAPH_B and a plan of (z, q) (``apply_charges``
    evaluates the charges in reverse order on it, ``apply_charges_block``
    BLOCK_K rolls of them at once)."""
    from torch import stack as torch_stack

    cfg = solver.cfg
    zc, qc = (a.to(cfg.torch_complex)[None] for a in (z, q))
    qr = q.flip(0).to(cfg.torch_complex)
    qk = torch_stack([q.roll(17 * k) for k in range(BLOCK_K)]).to(
        cfg.torch_complex)
    zbc, qbc = (a.to(cfg.torch_complex) for a in (zb, qb))
    full = (want_counts(cfg) if solver.backend.name == "cuda"
            else phase_counts(cfg))
    zero = {k: 0 for k in KERNELS}
    return {
        "apply": (lambda: solver.apply(z, q),
                  lambda: eager_entry(solver, "apply", zc, qc)[0], full),
        "apply_with_health": (
            lambda: solver.apply_with_health(z, q),
            lambda: (lambda o: (o[0][0], o[1]))(
                eager_entry(solver, "apply_with_health", zc, qc)), full),
        "apply_batched": (
            lambda: solver.apply_batched(zb, qb),
            lambda: eager_entry(solver, "apply_batched", zbc, qbc), full),
        "refresh": (lambda: solver.refresh(z, q),
                    lambda: eager_entry(solver, "refresh", zc, qc),
                    dict(zero, classify=cfg.nlevels)),
        "apply_plan": (lambda: solver.apply_plan(plan),
                       lambda: eager_entry(solver, "apply_plan", plan)[0],
                       dict(full, classify=0)),
        "apply_charges": (lambda: solver.apply_charges(plan, qr),
                          lambda: eager_entry(solver, "apply_charges", plan,
                                              qr[None])[0],
                          dict(full, classify=0)),
        # BLOCK_K densities on the plan: the per-phase path's L2P and
        # P2P launch once a density
        "apply_charges_block": (
            lambda: solver.apply_charges(plan, qk),
            lambda: eager_entry(solver, "apply_charges", plan, qk),
            dict(full, classify=0, l2p=BLOCK_K * full["l2p"],
                 p2p=BLOCK_K * full["p2p"])),
    }


def program_of(solver, entry: str):
    """The program of an ``entry_calls`` entry (``apply_charges_block``:
    the ``apply_charges`` program of BLOCK_K densities)."""
    if entry == "apply_charges_block":
        return next(p for k, p in solver.programs().items()
                    if k[0] == "apply_charges" and k[1] == (1, BLOCK_K))
    return next(p for k, p in solver.programs().items()
                if k[0] == entry and not isinstance(k[1], tuple))


def entry_phase(tag: str, solver, call, eager, want: dict, torch) -> None:
    """One entry point as a captured program (``call``: the solver's
    call; ``eager``: the same pipeline run eagerly; ``want``: the launches
    one run makes): GRAPH_REPS eager runs, the first call (eager: ``want``
    from the host) and the second (capture and replay: ``want``
    recorded, none from the host) with their ms and the pool bytes the
    capture charged, GRAPH_REPS replays (none launching from the host)
    and one more traced by the profiler (the kernels it ran on the card,
    by name, ``want``), every call bitwise the eager pipeline's output;
    prints the medians (host clock ending in a synchronize)."""
    eager_s = []
    for _ in range(GRAPH_REPS):
        ref, secs = host_s(eager, torch)
        eager_s.append(secs)

    def same(got):
        return len(leaves(got)) == len(leaves(ref)) and all(
            torch.equal(a, b) for a, b in zip(leaves(got), leaves(ref)))

    charged = solver._programs.bytes
    first_ms = []
    for kind in ("eager", "capture"):
        got, c, secs = counted(call, torch)
        first_ms.append(1e3 * secs)
        check(ran(c, want) and [p.kind for p in c.programs] == [kind]
              and same(got),
              f"{tag}: {kind} call {calls_note(c)} (want {want}), bitwise "
              f"eager {same(got)}")
        del got
    pool = solver._programs.bytes - charged
    replay_s = []
    for _ in range(GRAPH_REPS):
        got, c, secs = counted(call, torch)
        check(ran(c, want) and [p.kind for p in c.programs] == ["replay"]
              and same(got),
              f"{tag}: replay {calls_note(c)}, bitwise eager {same(got)}")
        replay_s.append(secs)
        del got
    (got, traced), c, _ = counted(lambda: replay_kernels(call, torch), torch)
    check(traced == want and same(got) and not any(c.host.values()),
          f"{tag}: a traced replay ran {traced} on the card, "
          f"{calls_note(c)} (want {want})")
    del got, ref
    ms = {k: 1e3 * statistics.median(v) for k, v in
          (("replay", replay_s), ("eager", eager_s))}
    print(f"{tag}: first call (eager) {first_ms[0]:.2f} ms, second "
          f"(capture + replay) {first_ms[1]:.2f} ms, replay "
          f"{ms['replay']:.2f} ms, eager pipeline {ms['eager']:.2f} ms "
          f"(medians of {GRAPH_REPS}, host clock): "
          f"{ms['eager'] / ms['replay']:.2f}x; every call bitwise eager; "
          f"recorded {want}, a traced replay ran the same; pool charged "
          f"{pool} B", flush=True)


def graphs_phase(dt: str, main: dict, torch) -> None:
    """Each solver entry point as a captured program, at the main path's
    configs on uniform, normal and layer particles (and the per-phase
    backend on uniform), on a fresh solver: per entry point the first
    call (eager: one run's launches from the host) and the second (the
    capture: one run's launches recorded, none from the host, then a
    replay) with their ms and the pool bytes the capture charged,
    GRAPH_REPS replays (none launching from the host) and as many eager
    runs of the same pipeline on the same inputs (host clock ending in a
    synchronize; medians), one more replay traced by the profiler (the
    kernels it ran on the card, by name, equal to one run's), every
    call bitwise the eager pipeline's output; then the programs held, and
    the memory back after ``_release_executables``."""
    from repro_torch.data import particles
    from repro_torch.solver import FmmSolver

    others = [particles(d, N, s) for d, s in
              (("normal", 1), ("layer", 1), ("uniform", 2))]
    for dist in DISTS:
        m = main[dist]
        cfg, z, q = m["cfg"], m["z"], m["q"]
        zb = torch.stack([z] + [o[0] for o in others[:GRAPH_B - 1]])
        qb = torch.stack([q] + [o[1] for o in others[:GRAPH_B - 1]])
        for backend in ("cuda", PHASES) if dist == "uniform" else ("cuda",):
            tag = f"graphs[{dt}/{dist}/{backend}]"
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            r_start = torch.cuda.memory_reserved()
            solver = FmmSolver(cfg, backend)          # uncached, no programs
            plan = eager_entry(solver, "refresh",
                               *(a.to(cfg.torch_complex)[None]
                                 for a in (z, q)))
            calls = entry_calls(solver, z, q, zb, qb, plan)
            for entry, (call, eager, want) in calls.items():
                entry_phase(f"{tag}/{entry}", solver, call, eager, want,
                            torch)
            count = solver._compiled_program_count()
            check(count == len(calls),
                  f"{tag}: {count} programs (want {len(calls)})")
            torch.cuda.synchronize()
            held, charged = torch.cuda.memory_reserved(), \
                solver._programs.bytes
            solver._release_executables()
            del solver, plan, calls, call, eager
            torch.cuda.empty_cache()
            back = torch.cuda.memory_reserved()
            print(f"{tag}: {count} programs, pools charged {charged} B, "
                  f"reserved {held - r_start} B over the start; after "
                  f"_release_executables + empty_cache reserved {back} B "
                  f"(before the first call {r_start} B)", flush=True)
            check(back - r_start <= 0.01 * (held - r_start),
                  f"{tag}: release returned {held - back} of "
                  f"{held - r_start} B")


def log_phase(torch) -> list[dict]:
    """The log kernel (G = q log(z - x)) at the shapes of the held-plan
    matvec (``log_config``: layer particles at N, f64, caps LOG_CAPS):
    (a) ``kernel_phase``'s gates and times on M2L, P2L, the fused
    evaluation and the upward pass in their log branches; (b)
    ``apply_charges`` on a held plan of those particles on a fresh
    solver, as the graphs phase runs
    an entry point (``entry_phase``: the main-path kernels but classify
    once a call, every call bitwise its eager pipeline); Re phi against
    the f64 direct log sum at N_SAMPLE targets (ACC_BOUND) and against
    the reference backend's ``apply`` of the same charges (F64_TOL).
    Real parts only: the imaginary part q arg(z - x) may take another
    branch in another order of evaluation (multiples of 2 pi q, no error;
    the kernels' own gates in (a) compare both parts, operand for
    operand). Prints the fused evaluation's log-branch time beside its
    bound, and the launches of ``eval_fused`` (here its f64 log branch)
    that the ``apply_charges`` program counted in (b): one in its eager
    first call, one recorded in its capture (a replay launches none).
    Returns the kernel rows, with their launches in one
    ``apply_charges``."""
    from repro_torch.core.direct import direct_potential
    from repro_torch.data import particles
    from repro_torch.solver import FmmSolver

    dt = "f64"
    rows = kernel_phase(dt, torch, kernel="log")
    ev = next(r for r in rows if r["name"] == f"eval_fused_log_{dt}")
    print(f"log branch: eval_fused {dt} {ev['ms']:.4f} ms, bound "
          f"{ev['bound_ms']:.4f} ms ({ev['bound_by']}), "
          f"{100 * ev['bound_ms'] / ev['ms']:.2f}% of it", flush=True)
    cfg = log_config(dt)
    z, q = particles("layer", N, SEED)
    tag = f"log[{dt}/layer]"
    solver = FmmSolver(cfg, "cuda")
    zc, qc = (a.to(cfg.torch_complex)[None] for a in (z, q))
    plan = eager_entry(solver, "refresh", zc, qc)
    check(int(plan.conn.overflow.max()) == 0,
          f"{tag}: lists overflow caps {LOG_CAPS}")
    call, eager, want = entry_calls(solver, z, q, zc, qc,
                                    plan)["apply_charges"]
    entry_phase(f"{tag}/apply_charges", solver, call, eager, want, torch)
    prog = next(p for k, p in solver.programs().items()
                if k[0] == "apply_charges")
    first, captured = (prog.launches.get("eval_fused"),
                       prog.recorded.get("eval_fused"))
    print(f"{tag}: apply_charges program: eval_fused launched {first} in "
          f"the first call, recorded {captured} in the capture, "
          f"{prog.replays} replays", flush=True)
    check(first == 1 and captured == 1,
          f"{tag}: eval_fused launched {first} / recorded {captured} "
          f"(want 1 / 1)")
    phi = call()
    qr = q.flip(0)
    sample = torch.randperm(N, generator=torch.Generator().manual_seed(
        SEED))[:N_SAMPLE].cuda()
    direct = direct_potential(z[sample], z, qr, kernel="log").real
    err = rel_err(phi[sample].real, direct)
    ref = FmmSolver.build(cfg, backend="reference").apply(z, qr)
    d = rel_err(phi.real, ref.real)
    print(f"{tag}: Re phi rel_err_inf vs the f64 direct log sum "
          f"{err:.3e} (limit {ACC_BOUND[dt]:g}); vs the reference backend "
          f"{d:.3e} (limit {F64_TOL:g})", flush=True)
    check(err < ACC_BOUND[dt], f"{tag}: accuracy {err:.3e}")
    check(d <= F64_TOL, f"{tag}: cuda vs reference {d:.3e} > {F64_TOL}")
    for row in rows:
        row["launches"] = want[row["name"].split("_log_")[0]]
    solver._release_executables()
    del solver, plan, phi, ref, direct, call, eager
    torch.cuda.empty_cache()
    return rows


def block_config():
    """The config of the block leg: the f64-log-mtl8-block cell's at N
    (f64, G = log, p = 17, caps BLOCK_CAPS)."""
    import dataclasses

    from repro_torch.configs import fmm_config

    return dataclasses.replace(fmm_config(N, p=P_TERMS, dtype="f64"),
                               kernel="log", strong_cap=BLOCK_CAPS[0],
                               weak_cap=BLOCK_CAPS[1])


def block_phase(torch) -> list[dict]:
    """BLOCK_K densities on one held plan at the block cell's shapes (N
    nodes on the eight wire contours, f64, G = log, ``block_config``):
    (a) each K-density kernel (upward, level-fused M2L, P2L, fused
    evaluation) on its staged operands against its plain version
    (F64_TOL), a second launch bitwise equal to the first, timed as the
    kernel phase times (back-to-back launches on the staged operands)
    beside the same kernel's single-density launch on density 0, with
    its share of the bound of ``bench/metrics/_work_block.py``; (b)
    ``apply_charges`` with the (BLOCK_K, N) block against BLOCK_K
    single-density calls on the same plan, each program warmed until it
    replays, the block program's eager call launching and its capture
    recording one main-path apply's kernels (``want_counts``, classify
    none; counted by the wrappers): every row within F64_TOL of its
    single call, then BLOCK_REPS replays of each (the block call; the
    BLOCK_K single calls back to back), host-clock medians ending in a
    synchronize, and each side's phase split (device marks, medians over
    its replays). Returns the kernel rows, named
    ``<kernel>_block<K>_f64``, with the launches the block program's
    first call made of each. (The wire plan has no P2L entry at caps
    BLOCK_CAPS: its P2L launch is a no-op, timed as such.)"""
    from bench.metrics import _work_block
    from bench.traffic.block_matvec import block_work
    from repro_torch import trace
    from repro_torch.core import fmm as F
    from repro_torch.data.synthetic import particles_numpy
    from repro_torch.kernels import (eval_fused_cuda, eval_fused_plain,
                                     eval_operands, m2l_cuda, m2l_operands,
                                     m2l_plain, p2l_cuda, p2l_operands,
                                     p2l_plain, upward_cuda, upward_plain)
    from repro_torch.solver import FmmSolver

    cfg, K = block_config(), BLOCK_K
    counts = want_counts(cfg, classify=0)     # one call's launches, any K
    tag = f"block[f64/wires8/K={K}]"
    z, q0 = (torch.from_numpy(a).cuda()
             for a in particles_numpy("wires8", N, SEED))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    Q = torch.randn((K, N), generator=gen, device="cuda",
                    dtype=torch.float64).to(cfg.torch_complex)
    plan = F.fmm_build(z[None], q0[None], cfg)
    check(int(plan.conn.overflow.max()) == 0,
          f"{tag}: lists overflow caps {BLOCK_CAPS}")
    work = block_work(plan, cfg, K)
    one_work = dict(work, densities=1)
    print(f"{tag}: occupied entries {work}", flush=True)
    plan = F.with_charges(plan, Q)
    tree, conn = plan.tree, plan.conn
    rho = F.effective_radii(tree, cfg)
    mult = upward_plain(tree, cfg, rho)
    local = F.downward(mult, tree, conn, cfg)
    ev_args, ev_kw = eval_operands(local, mult[-1], tree, conn, cfg)
    m2_args = m2l_operands(mult, conn.weak, tree.centers, cfg, rho)[0]
    pl_args, pl_kw = p2l_operands(tree, conn, cfg, rho[-1])

    def first(a, k0=0):
        """The single-density operands of density k0: each K-row plane
        cut to its row."""
        return [x[k0:k0 + 1].contiguous() if isinstance(x, torch.Tensor)
                and x.dim() and x.shape[0] == K else x for x in a]

    single_tree = tree._replace(q=tree.q[:1].contiguous())
    cases = {
        "upward": (lambda: (torch.cat(upward_cuda(tree, cfg, rho), 1),),
                   lambda: (torch.cat(upward_plain(tree, cfg, rho), 1),),
                   lambda: upward_cuda(single_tree, cfg, rho),
                   _work_block.upward_block),
        "m2l": (lambda: m2l_cuda(*m2_args), lambda: m2l_plain(*m2_args),
                lambda: m2l_cuda(*first(m2_args)), _work_block.m2l_block),
        "p2l": (lambda: p2l_cuda(*pl_args, **pl_kw),
                lambda: p2l_plain(*pl_args, **pl_kw),
                lambda: p2l_cuda(*first(pl_args), **pl_kw),
                _work_block.p2l_block),
        "eval_fused": (
            lambda: eval_fused_cuda(*ev_args, **ev_kw),
            lambda: eval_fused_plain(*ev_args, **ev_kw),
            lambda: eval_fused_cuda(*first(ev_args), **{
                k: first([v])[0] for k, v in ev_kw.items()}),
            _work_block.eval_block),
    }
    rows = []
    for name, (kern, plain, single, count) in cases.items():
        launches = counts[name]
        a, b = kern(), kern()
        ref = plain()
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"{tag}/{name}: second launch differs from the first")
        got = a[0] if len(a) == 1 else torch.complex(*a)
        want = ref[0] if len(ref) == 1 else torch.complex(*ref)
        err = scaled_err(got, want)
        check(err <= F64_TOL, f"{tag}/{name}: kernel vs plain {err:.3e}")
        ms = time_kernel(staged_launch(name, kern, launches), KERNEL_REPS,
                         torch)
        ms1 = time_kernel(staged_launch(name, single, launches
                                        if name == "upward" else 1),
                          KERNEL_REPS, torch)
        flops, dense, nbytes = count(work)
        t_ops = ops_seconds(flops, dense, "f64")
        bound = 1e3 * max(t_ops, nbytes / PEAK_BYTES)
        by = "operations" if t_ops >= nbytes / PEAK_BYTES else "bytes"
        f1, d1, b1 = count(one_work)
        bound1 = 1e3 * max(ops_seconds(f1, d1, "f64"), b1 / PEAK_BYTES)
        print(f"time {tag}/{name}: K={K} {ms:.4f} ms ({launches} "
              f"launches), K=1 {ms1:.4f} ms (x{K} = {K * ms1:.4f}); bound "
              f"{bound:.4f} ms ({by}; {flops:.3e} flop of which "
              f"{dense:.3e} dense, {nbytes:.3e} B), share "
              f"{100 * bound / ms:.2f}% (K=1: {100 * bound1 / ms1:.2f}%); "
              f"scaled_err vs plain {err:.3e}", flush=True)
        rows.append({"name": f"{name}_block{K}_f64", "route": "cuda",
                     "source": KERNELS[name][0], "replaces": KERNELS[name][1],
                     "launches": None, "ms": ms, "single_ms": ms1,
                     "bound_ms": bound, "bound_by": by, "library_ms": None,
                     "max_abs_err": float((got - want).abs().max())})
    del cases, ev_args, ev_kw, m2_args, pl_args, mult, local, plan, tree
    torch.cuda.empty_cache()

    # (b) one block call against K single calls on the same held plan
    solver = FmmSolver(cfg, "cuda")
    held = solver.refresh(z, q0)
    for kind in ("eager", "capture", "replay"):
        block, c, _ = counted(lambda: solver.apply_charges(held, Q), torch)
        check(ran(c, counts) and [p.kind for p in c.programs] == [kind],
              f"{tag}: {kind} call {calls_note(c)} (want {counts})")
        singles = [solver.apply_charges(held, Q[k]) for k in range(K)]
    torch.cuda.synchronize()
    prog = program_of(solver, "apply_charges_block")
    check(prog.launches == counts and prog.recorded == counts,
          f"{tag}: the K={K} program launched {prog.launches} in its "
          f"first call, recorded {prog.recorded} (want {counts})")
    for row in rows:                        # launches in one block call
        row["launches"] = prog.launches[row["name"].split("_block")[0]]
    errs = [scaled_err(block[k], singles[k]) for k in range(K)]
    check(max(errs) <= F64_TOL, f"{tag}: block rows vs single calls {errs}")
    split = {}
    for side, call in (("block", lambda: solver.apply_charges(held, Q)),
                       ("singles", lambda: [solver.apply_charges(held, Q[k])
                                            for k in range(K)])):
        trace.reset()
        secs = [host_s(call, torch)[1] for _ in range(BLOCK_REPS)]
        readings = trace.snapshot()["phases"]["apply_charges"]
        phases = {k: statistics.median(r[k] for r in readings)
                  for k in readings[0]}
        split[side] = (1e3 * statistics.median(secs), phases, len(readings))
    (bms, bph, bn), (sms, sph, sn) = split["block"], split["singles"]
    print(f"{tag}: apply_charges K={K} {bms:.3f} ms against {K} K=1 calls "
          f"{sms:.3f} ms (medians of {BLOCK_REPS}, replayed, host clock): "
          f"{bms / sms:.3f} of it; rows vs single calls scaled_err "
          f"{max(errs):.2e}; phases (device ms, medians over {bn} / {sn} "
          f"replays) block {json.dumps(bph)}, a single call "
          f"{json.dumps(sph)}", flush=True)
    check(bms <= 0.5 * sms, f"{tag}: a block call {bms:.3f} ms is not at "
          f"most half of {K} single calls {sms:.3f} ms")
    solver._release_executables()
    trace.reset()
    del solver, held, block, singles, Q
    torch.cuda.empty_cache()
    return rows


def wide_m2l_operands(W: int, dt: str, torch, seed: int = SEED,
                      device: str = "cuda"):
    """Operands of ``m2l_cuda`` with W-wide weak rows: 3,000 source boxes
    in the unit square (their own rows empty) and 1,099 target boxes 1.5
    to 3.5 units away, each row (5% of them empty) holding runs of 1-64
    source boxes separated by gaps of 0-192 slots (about a quarter of the
    slots occupied), radii 0.1-0.5, N(0, 1) multipoles; p = 17."""
    import numpy as np

    from repro_torch.core.fmm import m2l_mat

    ns, nt = WIDE_BOXES
    nb, P = ns + nt, P_TERMS + 1
    rng = np.random.default_rng([seed, W])
    weak = np.full((1, nb, W), -1, np.int32)
    for t in range(ns, nb):
        if rng.uniform() < 0.05:
            continue
        s = int(rng.integers(0, 64))
        while s < W:
            run = min(int(rng.integers(1, 65)), W - s)
            weak[0, t, s:s + run] = rng.integers(0, ns, run)
            s += run + int(rng.integers(0, 193))
    cr = np.concatenate([rng.uniform(0, 1, ns), rng.uniform(2.5, 3.5, nt)])
    ci = rng.uniform(0, 1, nb)
    rdt = torch.float64 if dt == "f64" else torch.float32

    def dev(a):
        return torch.as_tensor(a).to(device, rdt).contiguous()

    return (torch.as_tensor(weak).to(device),
            dev(rng.normal(size=(1, nb, P))), dev(rng.normal(size=(1, nb, P))),
            dev(cr[None]), dev(ci[None]), dev(rng.uniform(0.1, 0.5, (1, nb))),
            m2l_mat(P_TERMS, rdt, torch.device(device)), "harmonic")


def spread_rows(weak, W: int, seed: int = SEED):
    """The weak rows spread over W slots in slot order (the same sorted
    random W-subset of positions for every row), -1 elsewhere."""
    import numpy as np
    import torch

    pos = np.sort(np.random.default_rng(seed).choice(W, weak.shape[-1],
                                                     replace=False))
    out = torch.full(weak.shape[:-1] + (W,), -1, dtype=weak.dtype,
                     device=weak.device)
    out[..., torch.as_tensor(pos, device=weak.device)] = weak
    return out


def m2l_wide_phase(dt: str, torch) -> dict:
    """The M2L kernel at each width of ``WIDE_W``: against its plain
    version, twice bitwise equal, the 128-wide rows spread over the
    widest W bitwise the packed rows' result, shared memory and time.
    Returns per W its ms, shared memory and error."""
    from repro_torch.kernels import m2l_cuda, m2l_plain
    from repro_torch.kernels.build import LIBRARIES

    sz = 8 if dt == "f64" else 4
    tol = F64_TOL if dt == "f64" else F32_KERNEL_TOL["m2l"]
    out = {}
    for W in WIDE_W:
        tag = f"m2l_wide[{dt}/W={W}]"
        args = wide_m2l_operands(W, dt, torch)
        first = m2l_cuda(*args)
        second = m2l_cuda(*args)
        ref = m2l_plain(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(first, second)),
              f"{tag}: second launch differs from the first")
        err = scaled_err(torch.complex(*first), torch.complex(*ref))
        check(err <= tol, f"{tag}: kernel vs plain {err:.3e} > {tol}")
        weak = args[0]
        empty = ~(weak >= 0).any(-1)
        check(bool((first[0][empty] == 0).all()
                   and (first[1][empty] == 0).all()),
              f"{tag}: an empty box is not exactly 0")
        note = ""
        if W == WIDE_W[0]:
            wide = (spread_rows(weak, WIDE_W[-1]),) + tuple(args[1:])
            spread = m2l_cuda(*wide)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(spread, first)),
                  f"{tag}: rows spread over {WIDE_W[-1]} slots differ")
            note = f"; spread over {WIDE_W[-1]} slots: bitwise equal"
        smem = LIBRARIES["m2l"].smem_bytes(sz, 64, P_TERMS + 1, W)
        ms = time_kernel(staged_launch("m2l", lambda: m2l_cuda(*args)), 5,
                         torch)
        entries = int((weak >= 0).sum())
        print(f"{tag}: {entries} occupied entries, {int(empty.sum())} "
              f"empty boxes; scaled_err={err:.3e} (limit {tol:g}); "
              f"smem {smem} B; {ms:.4f} ms{note}", flush=True)
        out[W] = dict(ms=ms, smem_bytes=smem, scaled_err=err,
                      entries=entries)
    smems = [out[W]["smem_bytes"] for W in WIDE_W]
    check(smems[1] == smems[2] and smems[0] <= smems[1],
          f"m2l_wide[{dt}]: shared memory grows with W: {smems}")
    return out


def perturbed(z, step: int, eps: float = SEAM_EPS):
    """``tests/test_solver.py:_perturbed``: positions moved by eps N(0, 1)
    per component (numpy seed ``step``), clamped to the unit square."""
    import numpy as np
    import torch

    zn = z.cpu().numpy()
    rng = np.random.default_rng(step)
    zd = zn + eps * (rng.normal(size=zn.shape)
                     + 1j * rng.normal(size=zn.shape))
    return torch.from_numpy(np.clip(zd.real, 0, 1)
                            + 1j * np.clip(zd.imag, 0, 1)).to(z.device)


def plan_counts(conn) -> dict:
    """``connectivity_stats``' pair counts and row maxima from a numpy
    count of each list, moved to the host one by one."""
    lists = {k: [t.cpu().numpy()] for k, t in
             (("p2p", conn.p2p), ("p2l", conn.p2l), ("m2p", conn.m2p))}
    weak = [w.cpu().numpy() for w in conn.weak]
    strong = [s.cpu().numpy() for s in conn.strong]
    out = {f"{k}_pairs": int((v[0] >= 0).sum()) for k, v in lists.items()}
    out["m2l_pairs"] = sum(int((w >= 0).sum()) for w in weak)
    out["strong_max"] = max(int((s >= 0).sum(-1).max()) for s in strong)
    out["weak_max"] = max(int((w >= 0).sum(-1).max()) for w in weak)
    return out


def seam_phase(dt: str, main: dict, torch) -> None:
    """refresh + apply_plan on moved particles, the main path's uniform
    config: bitwise apply, launches per half (from the host at a
    program's first call, recorded at its second, a replay of a graph
    that recorded them after), trace_counts, stats, the median times;
    and one step on the per-phase backend."""
    from repro_torch.solver import FmmSolver

    m = main["uniform"]
    cfg, z, q = m["cfg"], m["z"], m["q"]
    zero = {k: 0 for k in KERNELS}
    want_refresh = dict(zero, classify=cfg.nlevels)
    want_plan = dict(want_counts(cfg), classify=0)
    solver = FmmSolver(cfg)                  # fresh: its own trace_counts
    times = {"refresh": [], "apply_plan": [], "apply": []}

    def timed(name, fn, step, want):
        out, c, secs = counted(fn, torch)
        times[name].append(secs)
        check(ran(c, want), f"seam[{dt}/step {step}]: {name} {calls_note(c)} "
              f"(want {want})")
        return out, calls_note(c)

    for step in range(SEAM_STEPS):
        tag = f"seam[{dt}/step {step}]"
        zk = perturbed(z, step)
        plan, c_refresh = timed("refresh", lambda: solver.refresh(zk, q),
                                step, want_refresh)
        phi, c_plan = timed("apply_plan", lambda: solver.apply_plan(plan),
                            step, want_plan)
        ref, _ = timed("apply", lambda: solver.apply(zk, q), step,
                       want_counts(cfg))
        check(torch.equal(phi, ref), f"{tag}: refresh + apply_plan is not "
              "bitwise apply")
        stats = solver.stats(zk, q)
        counted_lists = plan_counts(plan.conn)
        check(stats["overflow"] == 0, f"{tag}: overflow {stats}")
        check(all(stats[k] == v for k, v in counted_lists.items()),
              f"{tag}: stats {stats} != numpy count {counted_lists}")
        print(f"{tag}: refresh {1e3 * times['refresh'][-1]:.2f} ms, "
              f"apply_plan {1e3 * times['apply_plan'][-1]:.2f} ms, apply "
              f"{1e3 * times['apply'][-1]:.2f} ms; bitwise apply; "
              f"launches {c_refresh} / {c_plan}; stats {stats}", flush=True)
    check(solver.trace_counts == {"build": 1, "evaluate": 1},
          f"seam[{dt}]: trace_counts {solver.trace_counts}")
    ms = {k: 1e3 * statistics.median(v[2:]) for k, v in times.items()}
    print(f"seam[{dt}] N={N}: refresh {ms['refresh']:.2f} ms + apply_plan "
          f"{ms['apply_plan']:.2f} ms (replays, median of steps "
          f"3-{SEAM_STEPS}; step 1, eager: "
          f"{1e3 * times['refresh'][0]:.2f} + "
          f"{1e3 * times['apply_plan'][0]:.2f} ms); apply on the same "
          f"steps {ms['apply']:.2f} ms; main-path apply "
          f"{1e3 * m['secs']:.2f} ms; trace_counts {solver.trace_counts}",
          flush=True)

    phases = FmmSolver(cfg, backend=PHASES)
    zk = perturbed(z, SEAM_STEPS)
    plan, c_refresh, _ = counted(lambda: phases.refresh(zk, q), torch)
    phi, c_plan, _ = counted(lambda: phases.apply_plan(plan), torch)
    want = phase_counts(cfg)
    check(ran(c_refresh, want_refresh)
          and ran(c_plan, dict(want, classify=0)),
          f"seam[{dt}/{PHASES}]: launches {calls_note(c_refresh)} / "
          f"{calls_note(c_plan)}")
    check(torch.equal(phi, phases.apply(zk, q)),
          f"seam[{dt}/{PHASES}]: refresh + apply_plan is not bitwise apply")
    print(f"seam[{dt}/{PHASES}]: launches {calls_note(c_refresh)} / "
          f"{calls_note(c_plan)}; bitwise apply", flush=True)


def host_s(fn, torch):
    """(fn(), host seconds around it, ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def tune_phase(dt: str, main: dict, torch) -> None:
    """``FmmSolver.tune`` on each distribution at the main path's size,
    from the default caps: its trials, tuned caps and host time, one
    classify launch a level and probe; then ``apply_checked`` on the tuned
    solver: the main path's launches, the accuracy bound against the
    main path's direct sums, its apply time beside the main path's."""
    from repro_torch.configs import fmm_config
    from repro_torch.core.direct import rel_error_inf
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.solver import FmmSolver

    zero = {k: 0 for k in KERNELS}
    for dist in DISTS:
        m = main[dist]
        tag = f"tune[{dt}/{dist}]"
        z, q = m["z"], m["q"]
        solver = FmmSolver.build(fmm_config(N, p=P_TERMS, dtype=dt))
        reset_launch_counts()
        tuned, secs = host_s(lambda: solver.tune(z, q), torch)
        counts, res = launch_counts(), tuned.tune_result
        probes = len(res.trials)
        levels = solver.cfg.nlevels
        check(counts == dict(zero, classify=probes * levels),
              f"{tag}: launches {counts} for {probes} probes (want "
              f"classify {levels} a probe)")
        check(res.stats["overflow"] == 0 and res.trials[-1][2] == 0,
              f"{tag}: tuned caps overflow: {res.trials}")
        phi, c, _ = counted(lambda: tuned.apply_checked(z, q), torch)
        check(ran(c, want_counts(tuned.cfg)),
              f"{tag}: tuned apply_checked launches {calls_note(c)}")
        err = rel_error_inf(phi[m["sample"]].to(torch.complex128),
                            m["d_seen"])
        check(err < ACC_BOUND[dt], f"{tag}: accuracy {err:.3e} >= "
              f"{ACC_BOUND[dt]}")
        apply_s = median_apply_s(tuned, z, q, phi, tag, torch)
        print(f"{tag}: trials {res.trials}; tuned caps strong="
              f"{tuned.cfg.strong_cap} weak={tuned.cfg.weak_cap} (tile "
              f"fields {tuned.cfg.tile_boxes}/{tuned.cfg.stage_width}); tune "
              f"{1e3 * secs:.1f} ms host for {probes} probes, "
              f"{1e3 * secs / probes:.1f} ms a probe, classify launches a "
              f"probe {levels}; tuned apply_checked launches {calls_note(c)}, "
              f"rel_err_inf "
              f"{err:.3e}; tuned apply {1e3 * apply_s:.1f} ms (main path "
              f"{1e3 * m['secs']:.1f} ms at caps {m['cfg'].strong_cap}/"
              f"{m['cfg'].weak_cap})", flush=True)
        del phi, tuned
        torch.cuda.empty_cache()


def guard_phase(dt: str, main: dict, torch) -> None:
    """The guarded entry points on the real cap drift at the main path's
    size: (a) ``apply_guarded`` from the default caps on normal and
    layer particles walks primary -> caps*... and ends ok without
    degrading, at the accuracy bound (in f64, at the main path's caps,
    within F64_TOL of its phi); the host ms of the walk; at the final
    caps the plain apply, ``apply_with_health`` and the promoted guard in
    rounds of alternating order, and one ``host_health`` read; (b)
    ``refresh_guarded`` + ``apply_plan`` on the layer particles: one
    escalation that promotes, then steps on moved particles without
    retries, refresh_guarded ms beside refresh ms and beside refresh
    plus the guard's host read (order rotated, no plan kept between
    timed calls)."""
    from repro_torch.configs import fmm_config
    from repro_torch.core.direct import rel_error_inf
    from repro_torch.solver import FmmSolver, host_health

    cfg0 = fmm_config(N, p=P_TERMS, dtype=dt)
    for dist in ("normal", "layer"):
        m = main[dist]
        tag = f"guard[{dt}/{dist}]"
        z, q = m["z"], m["q"]
        g = FmmSolver.build(cfg0).guarded()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            (phi, rep), c, walk_s = counted(
                lambda: g.apply_guarded(z, q), torch)
        check(caught == [], f"{tag}: the walk warned "
              f"{[str(w.message) for w in caught]}")
        rungs = [a.rung for a in rep.attempts]
        check(rep.ok and rep.degradations == () and len(rungs) > 1
              and rungs[0] == "primary"
              and all(r.startswith("caps*") for r in rungs[1:]),
              f"{tag}: {rep.summary()}")
        check(ran(c, want_counts(cfg0), len(rungs)),
              f"{tag}: launches {calls_note(c)} (want {want_counts(cfg0)} "
              "a rung)")
        err = rel_error_inf(phi[m["sample"]].to(torch.complex128),
                            m["d_seen"])
        check(err < ACC_BOUND[dt], f"{tag}: accuracy {err:.3e}")
        note = ""
        if dt == "f64" and g.cfg == m["cfg"]:
            d = rel_err(phi, m["phi"])
            check(d <= F64_TOL, f"{tag}: vs main path {d:.3e}")
            note = f"; vs main path's phi at its caps {d:.3e}"
        # the promoted guard beside the plain apply and apply_with_health
        # at the final caps, in rounds of alternating order
        solver = FmmSolver.build(g.cfg)
        runs = {"apply": lambda: solver.apply(z, q),
                "apply_with_health": lambda: solver.apply_with_health(z, q),
                "apply_guarded": lambda: g.apply_guarded(z, q)}
        times = {k: [] for k in runs}
        for r in range(GUARD_ROUNDS):
            for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                out, secs = host_s(runs[k], torch)
                times[k].append(secs)
                if k == "apply_guarded":
                    check(out[1].retries == 0 and torch.equal(out[0], phi),
                          f"{tag}: promoted guard {out[1].summary()}")
                elif k == "apply":
                    check(torch.equal(out, phi), f"{tag}: apply differs")
        _, health = solver.apply_with_health(z, q)
        read = [host_s(lambda: host_health(health), torch)[1]
                for _ in range(GUARD_ROUNDS)]
        ms = {k: 1e3 * statistics.median(v) for k, v in times.items()}
        print(f"{tag}: {rep.summary()}; caps {g.cfg.strong_cap}/"
              f"{g.cfg.weak_cap} (main path {m['cfg'].strong_cap}/"
              f"{m['cfg'].weak_cap}); launches {calls_note(c)}; rel_err_inf "
              f"{err:.3e}{note}; walk {1e3 * walk_s:.1f} ms; at the final "
              f"caps (host, median of {GUARD_ROUNDS}, alternating order): "
              f"apply {ms['apply']:.1f} ms, apply_with_health "
              f"{ms['apply_with_health']:.1f} ms, promoted apply_guarded "
              f"{ms['apply_guarded']:.1f} ms; host_health alone "
              f"{1e3 * statistics.median(read):.3f} ms", flush=True)
        del phi, out, health
        torch.cuda.empty_cache()

    m = main["layer"]
    tag = f"guard[{dt}/refresh]"
    z, q = m["z"], m["q"]
    g = FmmSolver.build(cfg0).guarded()
    (plan, rep), c, secs = counted(lambda: g.refresh_guarded(z, q), torch)
    check(rep.ok and rep.retries >= 1 and g.cfg != cfg0
          and rep.attempts[-1].rung == f"caps*{g.cfg.strong_cap}/"
          f"{g.cfg.weak_cap}", f"{tag}: {rep.summary()}")
    check(ran(c, {k: cfg0.nlevels * (k == "classify") for k in KERNELS},
              len(rep.attempts)), f"{tag}: launches {calls_note(c)}")
    phi = g.apply_plan(plan)
    check(torch.equal(phi, g.solver.apply(z, q)),
          f"{tag}: apply_plan is not bitwise the promoted apply")
    print(f"{tag}: {rep.summary()} in {1e3 * secs:.1f} ms; launches "
          f"{calls_note(c)}", flush=True)

    def read(plan):
        # the guard's own host read of one plan's margins and overflow
        torch.cat([plan.conn.margins.reshape(-1),
                   plan.conn.overflow.reshape(-1)]).tolist()
        return plan

    runs = {"refresh": lambda zk: g.solver.refresh(zk, q),
            "refresh+read": lambda zk: read(g.solver.refresh(zk, q)),
            "refresh_guarded": lambda zk: g.refresh_guarded(zk, q)}
    times = {k: [] for k in (*runs, "apply_plan")}
    del plan, phi
    for step in range(REFRESH_STEPS):
        zk = perturbed(z, step)
        names = list(runs)[step % 3:] + list(runs)[:step % 3]
        for k in names:
            # no plan outlives its call: each timed call finds the same
            # memory free
            out, t = host_s(lambda: runs[k](zk), torch)
            if k == "refresh_guarded":
                check(out[1].ok and out[1].retries == 0,
                      f"{tag}/step {step}: {out[1].summary()}")
            times[k].append(t)
            del out
        plan, _ = g.refresh_guarded(zk, q)
        phi, t = host_s(lambda: g.apply_plan(plan), torch)
        times["apply_plan"].append(t)
        check(bool(torch.isfinite(phi).all()), f"{tag}: phi not finite")
        del plan, phi
    ms = {k: 1e3 * statistics.median(v[1:]) for k, v in times.items()}
    print(f"{tag}: steps on moved particles without retries; "
          f"refresh_guarded {ms['refresh_guarded']:.2f} ms, refresh "
          f"{ms['refresh']:.2f} ms, refresh + the guard's host read "
          f"{ms['refresh+read']:.2f} ms, apply_plan {ms['apply_plan']:.2f} "
          f"ms (median of steps 2-{REFRESH_STEPS}, order rotated)",
          flush=True)


def fault_walk(torch) -> None:
    """The five cases of ``repro_torch.testing.faults``' smoke walk on
    the card at N = 2^16, f64, "cuda" backend, uniform particles: each
    case's rungs, its launches and host ms per rung (the guard's
    ``rung_hook``; each rung's solver is new, so its program runs
    eagerly and launches from the host; the direct rung's ms is its card
    cost), a
    ``BackendDowngradeWarning`` exactly where a plain rung serves the
    answer, phi against the f64 direct sum."""

    from repro_torch.configs import fmm_config
    from repro_torch.core.direct import direct_potential
    from repro_torch.data import particles
    from repro_torch.errors import NonFiniteInputError
    from repro_torch.kernels import nbody_direct
    from repro_torch.solver import FmmSolver
    from repro_torch.testing.faults import smoke_cases

    cfg = fmm_config(FAULT_N, p=P_TERMS, dtype="f64")
    z, q = particles("uniform", cfg.n, SEED)
    oracle = direct_potential(z, z, q)
    margins = FmmSolver.build(cfg).stats(z, q)["margins"]
    # the strong lists overflow at cfg and fit after one doubling
    drop = min(margins[c] for c in ("strong", "p2p", "p2l", "m2p")) + 4
    S, W = cfg.strong_cap, cfg.weak_cap
    zero = {k: 0 for k in KERNELS}
    fmm = want_counts(cfg)
    want = {
        "healthy": (["primary"], "cuda", [fmm]),
        "truncate->caps*2": (["primary", f"caps*{2 * S}/{W}"], "cuda",
                             [fmm, fmm]),
        "nan-kernel->degrade": (["primary", "degrade:cuda+ref-eval"],
                                "cuda+ref-eval",
                                [fmm, dict(zero, classify=cfg.nlevels,
                                           m2l=1)]),
        "forced-overflow->direct": (
            ["primary", f"caps*{2 * S}/{min(2 * W, 8 * S)}", "direct"],
            "direct", [fmm, fmm, zero]),
    }
    log = []

    @contextlib.contextmanager
    def per_rung(rung):
        with counting(torch) as box:
            yield
        log.append((rung, 1e3 * box["secs"], box["calls"]))

    print(f"faults N={cfg.n} f64 uniform: caps {S}/{W}, margins {margins}, "
          f"truncation drop {drop}", flush=True)
    for case, expect, run in smoke_cases(cfg, drop=drop, rung_hook=per_rung):
        tag = f"faults[{case}]"
        log.clear()
        if expect is None:
            try:
                run(z, q)
            except NonFiniteInputError as e:
                print(f"{tag}: NonFiniteInputError ({e}); primary "
                      f"{log[0][1]:.1f} ms, launches {calls_note(log[0][2])}",
                      flush=True)
                continue
            check(False, f"{tag}: a poisoned input did not raise")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            phi, rep = run(z, q)
        rungs, backend, launches = want[case]
        got = [a.rung for a in rep.attempts]
        check(expect in got and got == rungs and rep.ok
              and rep.final_backend == backend,
              f"{tag}: {rep.summary()} (want {rungs}, {backend})")
        check([r for r, _, _ in log] == got
              and all(ran(c, w, int(r != "direct"))
                      for (r, _, c), w in zip(log, launches)),
              f"{tag}: launches per rung "
              f"{[(r, calls_note(c)) for r, _, c in log]} (want {launches})")
        # one warning for each rung served by plain torch, naming the
        # rung that failed before it
        plain = [(got[i - 1], r) for i, r in enumerate(got)
                 if r.startswith("degrade:") or r == "direct"]
        said = downgrades(caught)
        check(len(said) == len(plain)
              and all(f"rung {f!r}" in m and f"serving from {r!r}" in m
                      for (f, r), m in zip(plain, said)),
              f"{tag}: downgrade warnings {said} (want one for {plain})")
        # the smoke walk's own bounds (``faults._smoke``), normwise
        # over all targets
        err, tol = rel_err(phi, oracle), (F64_TOL if expect == "direct"
                                          else 1e-6)
        check(err <= tol, f"{tag}: vs direct {err:.3e} > {tol}")
        per = ", ".join(f"{r} {ms:.1f} ms {calls_note(c)}" for r, ms, c in log)
        print(f"{tag}: {rep.summary()}; vs direct {err:.3e}; per rung: "
              f"{per}; {len(said)} downgrade warning(s)", flush=True)
        if expect == "direct":
            rung_ms = log[-1][1]
    # the direct rung's plain sum beside the CUDA N-body kernel's
    phi = nbody_direct(z, z, q)
    err = scaled_err(phi[:, None], oracle[:, None])
    check(err <= F64_TOL, f"faults: nbody_direct vs direct {err:.3e}")
    ms = time_cuda(lambda: nbody_direct(z, z, q), 3, torch, warmup=1)
    print(f"faults N={cfg.n}: direct rung (plain torch, host clock) "
          f"{rung_ms:.1f} ms; nbody_direct {ms:.3f} ms (CUDA events, "
          f"scaled_err vs the rung {err:.3e})", flush=True)


@contextlib.contextmanager
def dispatch_log(torch):
    """Record every guarded batched dispatch (the serving plane's one
    call a dispatch, ``GuardedSolver.apply_batched_guarded``): its shape
    class, guard report, ``Calls``, the guard's trace counts before and
    after, whether the primary solver stayed, the leaf layouts built
    during it and its host ms (ending in a synchronize). Restores the
    method on exit."""
    from repro_torch.core.topology import layout_builds
    from repro_torch.solver import GuardedSolver

    real = GuardedSolver.apply_batched_guarded
    log = []

    def logged(self, z, q):
        solver, before, builds = self.solver, dict(self.trace_counts), \
            layout_builds()
        (phi, rep), c, secs = counted(lambda: real(self, z, q), torch)
        log.append(dict(key=(self.cfg.n, z.shape[0]), cfg=self.cfg,
                        report=rep, calls=c, ms=1e3 * secs,
                        trace=(before, dict(self.trace_counts)),
                        same_solver=self.solver is solver,
                        builds=layout_builds() - builds))
        return phi, rep

    GuardedSolver.apply_batched_guarded = logged
    try:
        yield log
    finally:
        GuardedSolver.apply_batched_guarded = real


def serve_counts(cfg) -> dict:
    """Launches per kernel of one guard attempt of a serving dispatch: the
    main path's, without P2L on a one-box tree (nlevels 0: no level to
    classify, no P2L pass)."""
    return want_counts(cfg, p2l=int(cfg.nlevels > 0))


def serve_wave(plane, wave, tag: str, torch, seen=None, full_acc=True):
    """Serve one wave of ``(n, z, q, kind)`` requests on ``plane`` and
    hold it to the serve gates: no ``BackendDowngradeWarning``; every
    clean request "ok" or "recovered" on "cuda", its phi within the
    accuracy bound of the f64 direct sum on the card (positions rounded
    as the solver sees them; every target when ``full_acc``, else
    N_SAMPLE sampled ones); every poisoned request rejected with the
    reference's typed error for its kind; each dispatch launching
    ``serve_counts`` once a guard attempt and the other kernels never.
    With ``seen`` (the shape classes dispatched before), a dispatch is a
    cache hit exactly when its shape class was seen, a hit leaves the
    guard's trace counts and primary solver as they were, and a bucket
    seen before builds no leaf layout. Prints the wave's numbers;
    returns them."""
    import numpy as np

    from repro_torch.core.direct import direct_potential, rel_error_inf
    from repro_torch.core.topology import layout_builds
    from repro_torch.serve import Request

    before = {b: s._asdict() for b, s in plane.cache.info().items()}
    builds = layout_builds()
    with warnings.catch_warnings(record=True) as caught, \
            dispatch_log(torch) as log:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        results = plane.serve([Request(z, q) for _, z, q, _ in wave])
        wall = time.perf_counter() - t0
    builds = layout_builds() - builds
    said = downgrades(caught)
    check(said == [], f"{tag}: downgrade warnings {said}")
    gen = torch.Generator().manual_seed(SEED)
    worst, clean, lat = 0.0, 0, []
    for (n, z, q, kind), (phi, rep) in zip(wave, results):
        if kind != "ok":
            check(rep.status == "rejected" and phi is None
                  and rep.error == POISON_ERRORS[kind],
                  f"{tag}: poison {kind}: {rep.summary()}")
            continue
        clean += 1
        lat.append(rep.latency_s)
        check(rep.status in ("ok", "recovered") and rep.backend == "cuda"
              and phi is not None and phi.shape == (n,)
              and bool(np.isfinite(phi).all()), f"{tag}: {rep.summary()}")
        cfg = plane.cfg_factory(rep.bucket)
        zs = torch.as_tensor(z.astype(cfg.complex_dtype),
                             device=plane.device).to(
            torch.complex128)
        qs = torch.as_tensor(q, device=plane.device)
        idx = (torch.arange(n) if full_acc or n <= N_SAMPLE else
               torch.randperm(n, generator=gen)[:N_SAMPLE]).to(plane.device)
        ref = direct_potential(zs[idx], zs, qs)
        err = rel_error_inf(torch.as_tensor(phi, device=plane.device)[idx]
                            .to(torch.complex128), ref)
        worst = max(worst, err)
        check(err < ACC_BOUND[cfg.dtype],
              f"{tag}: {rep.summary()} rel_err_inf {err:.3e}")
    for d in log:
        want = serve_counts(d["cfg"])
        check(ran(d["calls"], want, len(d["report"].attempts))
              and d["report"].degradations == (),
              f"{tag}: dispatch {d['key']} {d['report'].summary()} "
              f"launches {calls_note(d['calls'])} (want {want} an attempt)")
    if seen is not None:
        for phi, rep in results:
            if rep.bucket is not None:
                known = (rep.bucket, rep.batch) in seen
                check(rep.cache == ("hit" if known else "miss"),
                      f"{tag}: {rep.summary()} (shape class seen: {known})")
        for d in log:
            if d["key"] in seen:
                check(d["trace"][0] == d["trace"][1] and d["same_solver"],
                      f"{tag}: a cache hit {d['key']} re-prepared: trace "
                      f"{d['trace']}, same solver {d['same_solver']}")
            if d["key"][0] in {b for b, _ in seen}:
                check(d["builds"] == 0, f"{tag}: bucket {d['key'][0]} "
                      f"rebuilt {d['builds']} leaf layouts")
    rows = sum(k[0] * k[1] for k in (d["key"] for d in log))
    real = sum(r.n for _, r in results if r.bucket is not None
               and r.status != "rejected")
    after = plane.cache.info()
    counters = {b: tuple(v - before.get(b, {}).get(k, 0)
                         for k, v in s._asdict().items())
                for b, s in after.items()}
    hits = sum(c[0] for c in counters.values())
    kinds = [p.kind for d in log for p in d["calls"].programs]
    kinds = {k: kinds.count(k) for k in ("eager", "capture", "replay")}
    out = dict(requests=len(wave), clean=clean, dispatches=len(log),
               rps=clean / wall, p50=1e3 * float(np.percentile(lat, 50)),
               p99=1e3 * float(np.percentile(lat, 99)),
               dispatch_ms=statistics.median(d["ms"] for d in log),
               padded=(rows - real) / rows if rows else 0.0, worst=worst,
               builds=builds, keys={d["key"] for d in log}, wall=wall,
               attempts=sum(len(d["report"].attempts) for d in log),
               kinds=kinds)
    print(f"{tag}: {out['requests']} requests ({clean} clean), "
          f"{out['dispatches']} dispatches ({out['attempts']} guard "
          f"attempts; {hits} cache hits), per bucket (hits, misses, "
          f"evictions) {counters}; padded-row share {out['padded']:.4f}; "
          f"{out['rps']:.2f} clean requests/s ({wall:.3f} s); latency p50 "
          f"{out['p50']:.2f} ms, p99 {out['p99']:.2f} ms; median dispatch "
          f"{out['dispatch_ms']:.2f} ms (host); layouts built {builds}; "
          f"worst rel_err_inf {worst:.3e}; program calls by kind {kinds}; "
          f"programs held {programs_held()}, reserved "
          f"{torch.cuda.memory_reserved()} B",
          flush=True)
    return out


def serve_phase(torch) -> None:
    """The serving plane on the card: (a) the default ``ServePlane()``
    (lattice 64 .. 16,384, f32, p = 17, caps 48/128) on two waves of 64
    ragged requests with poison (cold, then a second wave on the warm
    cache), the 9-size wave served twice (no cache miss, no re-prepare,
    no layout built the second time), and a naive loop of one
    unpadded ``FmmSolver.apply`` a request beside the warm wave; (b)
    requests of 10^5-10^6 particles on the lattice 2^17 .. 2^20 in f32
    and f64; (c) ``repro_torch.testing.serve_faults``' soak on the card,
    every clean request served by the kernels but the designed
    ``oversize->direct`` ones, each of which warns once."""
    import functools

    from repro_torch.data import particles_numpy, ragged_requests
    from repro_torch.serve import (BucketLattice, ServePlane,
                                   default_cfg_factory)
    from repro_torch.solver import FmmSolver
    from repro_torch.testing.serve_faults import run_soak

    t_phase = time.perf_counter()
    # (a) the default plane at full width
    plane = ServePlane()
    check(plane.lattice.sizes == tuple(64 << k for k in range(9))
          and plane.max_batch == 8 and plane.cache.max_entries == 16,
          f"serve: default plane {plane.lattice.sizes}")
    seen: set = set()
    waves = []
    for s in SERVE_SEEDS:
        wave = list(ragged_requests(SERVE_REQUESTS, seed=s,
                                    median_n=SERVE_MEDIAN, sigma=1.0,
                                    n_max=1 << 14, poison_rate=0.1))
        out = serve_wave(plane, wave, f"serve[a/wave {s}]", torch,
                         seen=seen if waves else None)
        seen |= out["keys"]
        waves.append((wave, out))
    nine = [(n, *particles_numpy("uniform", n, i), "ok")
            for i, n in enumerate(plane.lattice.sizes)]
    for rep in range(2):
        out = serve_wave(plane, nine, f"serve[a/9 sizes, pass {rep}]",
                         torch, seen=seen if rep else None)
        seen |= out["keys"]
    check(out["dispatches"] == 9, f"serve: the 9-size wave took "
          f"{out['dispatches']} dispatches")
    # the naive loop: one unpadded, unbatched apply a clean request
    wave, steady = waves[-1]
    clean = [(z, q) for _, z, q, kind in wave if kind == "ok"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for z, q in clean:
        cfg = default_cfg_factory(z.size)
        FmmSolver.build(cfg).apply(z.astype(cfg.complex_dtype),
                                   q.astype(cfg.complex_dtype)).cpu()
    naive = len(clean) / (time.perf_counter() - t0)
    print(f"serve[a]: naive loop (FmmSolver.build(default_cfg_factory(n))"
          f".apply per request, unpadded) {naive:.2f} requests/s; the plane"
          f" on the warm wave {steady['rps']:.2f} requests/s: "
          f"{steady['rps'] / naive:.2f}x", flush=True)
    del plane

    # (b) requests at the users' scale, f32 and f64
    big = list(ragged_requests(8, **BIG_WAVE))
    for dt in ("f32", "f64"):
        plane = ServePlane(BucketLattice.geometric(*BIG_LATTICE),
                           max_batch=4, cfg_factory=functools.partial(
                               default_cfg_factory, dtype=dt))
        serve_wave(plane, big, f"serve[b/{dt}]", torch, full_acc=False)
        del plane
        torch.cuda.empty_cache()

    # (c) the soak on the card
    gates = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        failures, served = run_soak(
            log=lambda s: s.startswith("    ") or gates.append(s))
        secs = time.perf_counter() - t0
    print("\n".join(f"serve[c]: {g}" for g in gates), flush=True)
    check(failures == [], f"serve[c]: soak gates failed: {failures}")
    said = downgrades(caught)
    direct = [rep for _, _, phi, rep in served
              if rep.path[:1] == ("oversize->direct",)]
    for phase, kind, phi, rep in served:
        if phi is not None:
            want = ("direct" if rep.path[:1] == ("oversize->direct",)
                    else "cuda")
            check(rep.backend == want, f"serve[c/{phase}]: {rep.summary()}")
    one_warning_each(direct, said, "serve[c]")
    print(f"serve[c]: soak on the card in {secs:.1f} s: "
          f"{sum(phi is not None for _, _, phi, _ in served)} served "
          f"({len(direct)} oversize->direct, one warning each), "
          f"{sum(phi is None for _, _, phi, _ in served)} rejected",
          flush=True)
    print(f"serve: phase {time.perf_counter() - t_phase:.1f} s (host)",
          flush=True)


def degenerate_layouts(n: int) -> dict:
    """``tests/test_torch_helpers.py:_layouts`` without the reference: the
    same numpy draws (``particles_numpy`` is the reference's generator,
    number for number), so the card runs the layouts that the CPU tests
    hold to the reference."""
    import numpy as np

    from repro_torch.data import particles_numpy

    rng = np.random.default_rng(42)
    ones = np.ones(n, np.complex128)
    normal = rng.normal(size=n) + 0j
    cluster = np.full(n, 0.25 + 0.25j)
    cluster[0] = 0.75 + 0.75j
    uz, uq = particles_numpy("uniform", n, 42)
    out = {
        "all-coincident": (np.full(n, 0.3 + 0.6j), ones),
        "one-distinct-in-a-cluster": (cluster, ones),
        "collinear": (rng.uniform(0, 1, n) + 0.4j, normal),
        "empty-quadrants": (rng.uniform(0, 0.25, n)
                            + 1j * rng.uniform(0, 0.25, n), normal),
        "zero-charges": (uz, np.zeros(n, np.complex128)),
    }
    for e in (-9, -3, 6):
        out[f"scale-1e{e}"] = (uz * 10.0 ** e, uq)
    return out


def bits(t):
    """A tensor's bits as integers (NaNs compare equal when their bits
    do)."""
    import torch

    r = torch.view_as_real(t) if t.is_complex() else t
    return r.contiguous().view(
        {8: torch.int64, 4: torch.int32, 1: torch.uint8}[r.element_size()])


def degenerate_phase(torch) -> None:
    """The degenerate layouts through ``apply_with_health`` on the card,
    each on a fresh "cuda" solver: the first call (eager) and the third
    (a replay) against the port's run of the layout on the CPU (the
    kernels' plain versions, which ``tests/test_torch_helpers.py`` holds
    to the reference): the same ``host_health``, the same finite and NaN
    pattern, phi within F64_TOL where finite; the replay bitwise the
    eager call."""
    from repro_torch.core.config import FmmConfig
    from repro_torch.solver import FmmSolver, host_health

    t0 = time.perf_counter()
    cfg = FmmConfig(**DEGENERATE)
    for name, (z, q) in degenerate_layouts(cfg.n).items():
        tag = f"degenerate[{name}]"
        phi_cpu, h_cpu = FmmSolver(cfg, "cuda", "cpu").apply_with_health(z, q)
        h_cpu = host_health(h_cpu)
        solver = FmmSolver(cfg, "cuda")
        runs = [counted(lambda: solver.apply_with_health(z, q), torch)
                for _ in range(3)]
        kinds = [p.kind for _, c, _ in runs for p in c.programs]
        check(kinds == ["eager", "capture", "replay"],
              f"{tag}: program calls {kinds}")
        check(ran(runs[0][1], want_counts(cfg)),
              f"{tag}: eager launches {calls_note(runs[0][1])}")
        (phi, health), _, _ = runs[0]
        (phi_r, health_r), _, _ = runs[2]
        h = host_health(health)
        check(h == h_cpu, f"{tag}: host_health {h} != the CPU's {h_cpu}")
        got, ref = phi.cpu(), phi_cpu
        check(torch.equal(got.isfinite(), ref.isfinite())
              and torch.equal(got.isnan(), ref.isnan()),
              f"{tag}: finite / NaN pattern differs from the CPU's")
        ok = ref.isfinite()
        d = (rel_err(got[ok], ref[ok]) if ok.any() and ref[ok].abs().max() > 0
             else float(not torch.equal(got[ok], ref[ok])))
        check(d <= F64_TOL, f"{tag}: phi vs the CPU's {d:.3e}")
        check(torch.equal(bits(phi_r), bits(phi))
              and all(torch.equal(bits(a), bits(b)) for a, b in
                      zip(leaves(health_r), leaves(health))),
              f"{tag}: the replay is not bitwise the eager call")
        print(f"{tag}: host_health {h}; finite {int(ok.sum())}/{cfg.n}, NaN "
              f"{int(ref.isnan().sum())}; vs CPU {d:.3e}; replay bitwise "
              f"eager; eager launches {calls_note(runs[0][1])}", flush=True)
    print(f"degenerate: phase {time.perf_counter() - t0:.1f} s (host)",
          flush=True)


def load_example(name: str):
    """``examples/<name>.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def method_log(cls, names, torch):
    """Count and time every call of ``cls``'s methods ``names`` (host
    seconds ending in a synchronize): the yielded list gets one dict a
    call, with its ``name``, ``calls`` (``Calls``) and ``ms``. Restores
    the methods on exit."""
    log, real = [], {n: getattr(cls, n) for n in names}

    def wrap(name):
        def logged(self, *args, **kw):
            out, c, secs = counted(lambda: real[name](self, *args, **kw),
                                   torch)
            log.append(dict(name=name, calls=c, ms=1e3 * secs))
            return out
        return logged

    for n in names:
        setattr(cls, n, wrap(n))
    try:
        yield log
    finally:
        for n, fn in real.items():
            setattr(cls, n, fn)


def kernel_runs(calls) -> dict:
    """Runs of each kernel over counted calls, all measured: launched
    from the host, recorded into a capture, or run by the replay of a
    graph whose capture recorded it."""
    out = dict.fromkeys(KERNELS, 0)
    for c in calls:
        for k in KERNELS:
            out[k] += c.host[k] + c.recorded[k] + sum(
                p.recorded.get(k, 0) for p in c.programs
                if p.kind == "replay")
    return out


def main_kernels_ran(runs: dict, tag: str) -> None:
    want = ("classify", "upward", "m2l", "p2l", "eval_fused")
    check(all(runs[k] > 0 for k in want),
          f"{tag}: main-path kernels run {runs} (want each of {want})")


def program_kinds(programs, tag: str) -> dict:
    """Gate: per program (solver and key), no call after its first
    capture or replay runs eagerly or captures again (a release would
    make it). Returns the calls by kind."""
    seen: dict = {}
    for p in programs:
        kinds = seen.setdefault(p.program, [])
        check(p.kind == "replay" or all(k == "eager" for k in kinds),
              f"{tag}: {p.entry} ran {kinds + [p.kind]}")
        kinds.append(p.kind)
    every = [p.kind for p in programs]
    return {k: every.count(k) for k in ("eager", "capture", "replay")}


def one_warning_each(direct: list, said: list, tag: str) -> None:
    """Gate: exactly one downgrade warning for each ``oversize->direct``
    report, in order, naming its request and the step."""
    check(len(said) == len(direct) and all(
        f"request {rep.rid} " in m and "'oversize->direct'" in m
        for rep, m in zip(direct, said)),
        f"{tag}: downgrade warnings {said} (want one a direct request: "
        f"{[r.rid for r in direct]})")


def downgrades(caught) -> list:
    from repro_torch.errors import BackendDowngradeWarning
    return [str(w.message) for w in caught
            if issubclass(w.category, BackendDowngradeWarning)]


def vortex_example(vortex, torch) -> None:
    """The vortex twin at N, p = P_TERMS, f32: the first step's velocity
    against the f64 direct sum at N_SAMPLE targets, then ``run`` for
    VORTEX_STEPS RK2 steps (its drift assert and its trace-count
    assert), every guard report on "cuda" without degradation, no
    downgrade warning, the four main-path kernels run, every program
    replaying from its third call; re-plans, caps, the steps'
    ``refresh_guarded`` and ``apply_plan`` replay ms and the program
    calls by kind."""
    import math

    from repro_torch.core.direct import direct_potential, rel_error_inf
    from repro_torch.solver import GuardedSolver, program_memory

    t0 = time.perf_counter()
    released = program_memory()["released_sets"]
    with warnings.catch_warnings(record=True) as caught, \
            method_log(GuardedSolver, ("refresh_guarded", "apply_plan"),
                       torch) as log:
        warnings.simplefilter("always")
        z, g, guard, _, _ = vortex.setup(N, P_TERMS)
        (u, rep), _, first_s = counted(lambda: vortex.velocity(z, g, guard),
                                       torch)
        gen = torch.Generator().manual_seed(SEED)
        idx = torch.randperm(N, generator=gen)[:N_SAMPLE].to(z.device)
        z64, g64 = z.to(torch.complex128), g.to(torch.complex128)
        u_ref = torch.conj_physical(
            direct_potential(z64[idx], z64, g64) / (2j * math.pi))
        err = rel_error_inf(u[idx].to(torch.complex128), u_ref)
        check(err < ACC_BOUND["f32"] and rep.ok and rep.degradations == (),
              f"vortex: first step velocity {err:.3e} (bound "
              f"{ACC_BOUND['f32']}), {rep.summary()}")
        del u, u_ref, z, g, guard
        out = vortex.run(N, VORTEX_STEPS, VORTEX_DT, P_TERMS,
                         log=lambda s: print(s, flush=True))
    said = downgrades(caught)
    check(said == [], f"vortex: downgrade warnings {said}")
    reps = out["reports"]
    check(len(reps) == 2 * VORTEX_STEPS and all(
        r.ok and r.final_backend == "cuda" and r.degradations == ()
        for r in reps), "vortex: a guard report off 'cuda' or degraded: "
        f"{[r.summary() for r in reps if r.final_backend != 'cuda']}")
    calls = [d["calls"] for d in log]
    main_kernels_ran(kernel_runs(calls), "vortex")
    kinds = program_kinds([p for c in calls for p in c.programs], "vortex")
    ms = {}
    for name in ("refresh_guarded", "apply_plan"):
        rep_ms = [d["ms"] for d in log if d["name"] == name and all(
            p.kind == "replay" for p in d["calls"].programs)]
        check(len(rep_ms) >= VORTEX_STEPS, f"vortex: {name} replayed "
              f"{len(rep_ms)} times in {VORTEX_STEPS} steps")
        ms[name] = statistics.median(rep_ms)
    replanned = sorted({(a.strong_cap, a.weak_cap) for r in reps
                        for a in r.attempts[1:]})
    print(f"vortex: N={N}, p={P_TERMS}, f32, {VORTEX_STEPS} RK2 steps on "
          f"cuda: first step velocity rel_err_inf {err:.3e} at {N_SAMPLE} "
          f"targets (f64 direct sum; bound {ACC_BOUND['f32']}) in "
          f"{1e3 * first_s:.1f} ms (eager); tuned caps "
          f"{out['tuned_caps']}, re-plans {out['replans']} (caps tried "
          f"{replanned}, final {out['caps']}); impulse drift "
          f"{out['drift']:.3e} ({out['drifts']}); refresh_guarded "
          f"{ms['refresh_guarded']:.2f} ms, apply_plan "
          f"{ms['apply_plan']:.2f} ms (host, median of the replayed "
          f"calls); {out['s_per_step']:.3f} s a step; program calls by kind "
          f"{kinds}; solvers released by the memory budget meanwhile "
          f"{program_memory()['released_sets'] - released}; trace_counts "
          f"{out['trace_counts']}; phase "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)


def quickstart_example(quickstart, torch) -> None:
    """The quickstart twin at N, normal, p = P_TERMS, f64, B =
    QUICK_BATCH on the default device: its own asserts, its 512-point
    error under the f64 bound, ``apply_batched`` dispatched to "cuda",
    the four main-path kernels run, no downgrade warning; its ms."""
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, \
            counting(torch) as box:
        warnings.simplefilter("always")
        out = quickstart.run(N, P_TERMS, "normal", batch=QUICK_BATCH,
                             log=lambda s: print(s, flush=True))
    said = downgrades(caught)
    check(said == [], f"quickstart: downgrade warnings {said}")
    check(out["err"] < ACC_BOUND["f64"], f"quickstart: 512-point error "
          f"{out['err']:.3e} (bound {ACC_BOUND['f64']})")
    check(out["dispatched"] == "cuda",
          f"quickstart: apply_batched dispatched {out['dispatched']}")
    runs = kernel_runs([box["calls"]])
    main_kernels_ran(runs, "quickstart")
    print(f"quickstart: N={N} normal f64 p={P_TERMS}: caps {out['caps']} "
          f"(batched {out['batched_caps']}); apply first "
          f"{1e3 * out['first_s']:.1f} ms, second "
          f"{1e3 * out['second_s']:.1f} ms; rel err {out['err']:.3e} "
          f"(512 points); apply_batched B={QUICK_BATCH} "
          f"{1e3 * out['batched_s']:.1f} ms on {out['dispatched']}; kernel "
          f"runs {runs}; program calls by kind "
          f"{program_kinds(box['calls'].programs, 'quickstart')}; phase "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)


def serve_example(serve_traffic, torch) -> None:
    """The serve twin at its defaults: every clean request at or below
    the lattice's top "ok" or "recovered" on "cuda", each poison refused
    with the reference's typed error, each ``oversize->direct`` request
    warned once, the four main-path kernels run; requests/s a wave."""
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught, \
            dispatch_log(torch) as log:
        warnings.simplefilter("always")
        out = serve_traffic.run(log=lambda s: None)
    said = downgrades(caught)
    direct = []
    for w, wave in enumerate(out["waves"]):
        for (n, _, _, kind), (phi, rep) in zip(wave["requests"],
                                               wave["results"]):
            tag = f"serve_traffic[wave {w}]: {rep.summary()}"
            if kind != "ok":
                check(phi is None and rep.error == POISON_ERRORS[kind],
                      f"{tag} (poison {kind})")
            elif n <= 1024:
                check(rep.status in ("ok", "recovered")
                      and rep.backend == "cuda" and phi.shape == (n,), tag)
            else:
                check(rep.path[:1] == ("oversize->direct",)
                      and rep.backend == "direct", tag)
                direct.append(rep)
        print(f"serve_traffic[wave {w}]: {len(wave['requests'])} requests "
              f"in {wave['secs']:.3f} s: "
              f"{len(wave['requests']) / wave['secs']:.2f} requests/s; "
              f"statuses {[r.status for _, r in wave['results']]}",
              flush=True)
    one_warning_each(direct, said, "serve_traffic")
    calls = [d["calls"] for d in log]
    runs = kernel_runs(calls)
    main_kernels_ran(runs, "serve_traffic")
    kinds = program_kinds([p for c in calls for p in c.programs],
                          "serve_traffic")
    stats = {k: out["stats"][k] for k in ("requests", "ok", "recovered",
                                          "degraded", "rejected",
                                          "dispatches")}
    print(f"serve_traffic: warm-up {out['warm_s']:.2f} s; {len(direct)} "
          f"oversize->direct (one warning each); cumulative {stats}; "
          f"kernel runs {runs}; program calls by kind {kinds}; phase "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)


def substrate_phase(vortex, torch) -> None:
    """``train_loop`` around the vortex twin's RK2 steps at N on the card:
    the state is z, the loss the impulse drift. Run A checkpoints every
    SUB_EVERY steps and fails at step SUB_FAIL (``FailureInjector``);
    ``restore_latest`` brings the last checkpoint back onto the card
    (bitwise the state it saved) and run B resumes to SUB_STEPS on a
    fresh guard; run C goes 0 .. SUB_STEPS uninterrupted on a fresh
    guard. B's final z is bitwise C's when no run re-planned, else within
    1e-5 relative (displacements). Prints the save (snapshot) and
    restore ms and the checkpoint's bytes."""
    import os
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import FailureInjector, train_loop
    from repro_torch.solver import FmmSolver

    t0 = time.perf_counter()
    z, g, guard, z0, _ = vortex.setup(N, P_TERMS)
    cfg = guard.cfg
    g64 = g.to(torch.complex128)
    imp0 = (g64 * torch.from_numpy(z0).to(z.device)).sum()
    replans, states = [], {}

    def stepper(tag):
        guard = FmmSolver.build(cfg).guarded(max_cap_doublings=3)

        def step_fn(state, batch, step):
            zn, reps = vortex.rk2_step(state, g, guard, VORTEX_DT)
            replans.extend(r.retries for r in reps)
            check(all(r.final_backend == "cuda" and r.degradations == ()
                      for r in reps), f"substrate[{tag}]: {reps}")
            states[(tag, step)] = zn
            drift = ((g64 * zn.to(torch.complex128)).sum() - imp0).abs()
            return zn, {"loss": drift / imp0.abs()}
        return step_fn

    quiet = dict(log_every=SUB_STEPS, log_fn=lambda s: None)
    with tempfile.TemporaryDirectory() as d:
        cm = CheckpointManager(d, keep=2)
        save_ms, real_save = [], cm.save

        def timed_save(step, tree, blocking=False):
            _, secs = host_s(lambda: real_save(step, tree, blocking), torch)
            save_ms.append(1e3 * secs)

        cm.save = timed_save
        try:
            train_loop(stepper("A"), z, lambda s: None, start_step=0,
                       num_steps=SUB_STEPS, ckpt_manager=cm,
                       ckpt_every=SUB_EVERY,
                       failure=FailureInjector(fail_at=(SUB_FAIL,)), **quiet)
            check(False, "substrate: the injected failure did not stop run A")
        except RuntimeError as e:
            check(f"injected node failure at step {SUB_FAIL}" in str(e),
                  f"substrate: run A stopped by {e!r}")
        cm.wait()
        (state, step), restore_s = host_s(cm.restore_latest, torch)
        last = SUB_FAIL - SUB_FAIL % SUB_EVERY
        saved = states[("A", last - 1)]
        check(step == last and state.device == z.device
              and state.dtype == z.dtype
              and torch.equal(bits(state), bits(saved)),
              f"substrate: restored step {step} (want {last}) on "
              f"{state.device} {state.dtype}, not bitwise the saved state")
        with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
            nbytes = sum(m["bytes"] for m in json.load(f)["leaves"].values())
        z_b, sum_b = train_loop(stepper("B"), state, lambda s: None,
                                start_step=step, num_steps=SUB_STEPS,
                                ckpt_manager=cm, ckpt_every=SUB_EVERY,
                                **quiet)
    z_c, sum_c = train_loop(stepper("C"), z, lambda s: None, start_step=0,
                            num_steps=SUB_STEPS, **quiet)
    check(sum_b["last_step"] == sum_c["last_step"] == SUB_STEPS - 1,
          f"substrate: summaries {sum_b} / {sum_c}")
    if any(replans):
        d_rel = rel_err(z_b - z, z_c - z)
        check(d_rel <= 1e-5, f"substrate: resumed vs uninterrupted "
              f"displacement {d_rel:.3e} (re-planned)")
        case = f"re-planned ({sum(replans)} retries): within {d_rel:.3e}"
    else:
        check(torch.equal(bits(z_b), bits(z_c))
              and sum_b["losses"] == sum_c["losses"][step:],
              "substrate: the resumed run is not bitwise the uninterrupted "
              "run")
        case = "no re-plan: bitwise"
    print(f"substrate: N={N} f32, failed at step {SUB_FAIL}, restored step "
          f"{step} onto {state.device} (bitwise the saved state), resumed "
          f"to {SUB_STEPS}; final z vs uninterrupted: {case}; checkpoint "
          f"{nbytes} B; save (snapshot) ms "
          f"{[round(t, 2) for t in save_ms]}; restore "
          f"{1e3 * restore_s:.2f} ms; impulse drift at the end "
          f"{sum_c['losses'][-1]:.3e}; median step "
          f"{1e3 * sum_c['median_step_time']:.1f} ms; phase "
          f"{time.perf_counter() - t0:.1f} s (host)", flush=True)


PAR_SIDE = 1024                 # the parameter tree {"w": (1024, 1024)}: 2^20 f32
PAR_BATCH = 256
PAR_RANKS = 8
PAR_MESH = (2, 2, 2)
PAR_AXES = ("pod", "data", "model")
PAR_REPS = 20
TELESCOPE_STEPS = 3
FEEDBACK_STEPS = 2
RESUME_STEPS = 2


def square_loss(p, b):
    """The loss of the compressed-gradient legs: mean((b @ w)^2)."""
    return ((b @ p["w"]) ** 2).mean()


def reference_loss(p, b):
    """The reference test's loss (``tests/test_runtime_substrate.py``
    ``test_compressed_allreduce_multidevice_subprocess``)."""
    return ((b @ p["w"][:2, :]) ** 2).mean()


def median_ms(fn, reps: int, torch, warmup: int = 2) -> float:
    """Median host milliseconds of ``reps`` calls, each ending in a
    synchronize, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    return statistics.median(1e3 * host_s(fn, torch)[1] for _ in range(reps))


def wire_bytes(fn, torch) -> dict:
    """The collective bytes of one ``fn()`` call, read from a
    ``torch.profiler`` trace (``collective_bytes_traced``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.hlo_analysis import collective_bytes_traced

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    return collective_bytes_traced(prof)


def collective_legs(pod, dev, torch, reps: int = PAR_REPS) -> dict:
    """``ef_allreduce`` against a plain f32 ``all_reduce`` of the 2^20
    f32 parameter tree over the process group ``pod``: median host ms
    of each and the bytes each puts on the wire (profiler trace)."""
    import torch.distributed as dist

    from repro_torch.parallel import ef_allreduce

    g = torch.randn(PAR_SIDE, PAR_SIDE, device=dev,
                    generator=torch.Generator(dev).manual_seed(SEED))
    err = torch.zeros_like(g)
    ef = lambda: ef_allreduce(g, err, pod)  # noqa: E731
    plain = lambda: dist.all_reduce(g.clone(), group=pod)  # noqa: E731
    return {"ef_ms": median_ms(ef, reps, torch),
            "plain_ms": median_ms(plain, reps, torch),
            "ef_bytes": wire_bytes(ef, torch),
            "plain_bytes": wire_bytes(plain, torch)}


def nccl_leg(mesh, torch) -> dict:
    """(a) ``make_compressed_value_and_grad`` on one rank's mesh: the
    2^20 f32 tree's gradient within half a quantum of the exact one (one
    pod: the mean is the dequantized gradient), the loss exact, the
    errors the residual on a leading pod axis; ``ef_allreduce`` against a
    plain ``all_reduce`` (ms, bytes)."""
    from repro_torch.parallel import (init_pod_errors,
                                      make_compressed_value_and_grad)

    dev = torch.device(mesh.device_type)
    gen = torch.Generator(dev).manual_seed(SEED)
    params = {"w": torch.randn(PAR_SIDE, PAR_SIDE, device=dev,
                               generator=gen) / PAR_SIDE ** 0.5}
    batch = torch.randn(PAR_BATCH, PAR_SIDE, device=dev, generator=gen)
    vg = make_compressed_value_and_grad(square_loss, mesh)
    errors = init_pod_errors(params, mesh.shape[0])
    (loss, grads, errors), secs = host_s(lambda: vg(params, batch, errors),
                                         torch)
    _, again = host_s(lambda: vg(params, batch, init_pod_errors(
        params, mesh.shape[0])), torch)
    exact, exact_loss = torch.func.grad_and_value(square_loss)(params, batch)
    scale = float(exact["w"].abs().max()) / 127.0
    tol = 127 * 2.0 ** -22 * scale       # f32 rounding of a code times scale
    gerr = float((grads["w"] - exact["w"]).abs().max())
    resid = (exact["w"] - grads["w"]) - errors["w"].full_tensor()[0]
    check(gerr <= 0.5 * scale + tol and float(resid.abs().max()) <= tol
          and torch.equal(loss, exact_loss)
          and tuple(errors["w"].shape) == (mesh.shape[0], PAR_SIDE, PAR_SIDE),
          f"parallel(a): grad err {gerr:.3e} (quantum {scale:.3e}), "
          f"residual {float(resid.abs().max()):.3e}, loss {float(loss)} vs "
          f"{float(exact_loss)}, errors {tuple(errors['w'].shape)}")
    out = collective_legs(mesh.get_group("pod"), dev, torch)
    out.update(vg_ms=1e3 * secs, vg2_ms=1e3 * again, grad_err=gerr,
               quantum=scale)
    return out


def parallel_rank(rank, world, device_type="cuda"):
    """(b) one of PAR_RANKS ranks on the card's one device over gloo, mesh
    PAR_MESH: the reference test's problem (its bounds against the exact
    gradient and loss), TELESCOPE_STEPS error-feedback steps of the 2^20
    tree over "pod" (what was sent sums to the true mean minus the final
    errors' mean within f32 rounding), and ``ef_allreduce`` against a
    plain ``all_reduce`` (ms, bytes). Returns rank 0's numbers."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import make_test_mesh
    from repro_torch.parallel import (ef_allreduce_tree, init_errors,
                                      init_pod_errors,
                                      make_compressed_value_and_grad)

    mesh = make_test_mesh(PAR_MESH, PAR_AXES, device_type)
    dev = torch.device(device_type)
    vg = make_compressed_value_and_grad(reference_loss, mesh)
    w = torch.ones(8, 8, device=dev)
    b = torch.arange(16.0, device=dev).reshape(8, 2)
    t0 = time.perf_counter()
    # plain tensors (the full arrays on every rank): redistributing CUDA
    # DTensors over gloo crashes torch 2.11 (its functional all_gather)
    loss, grads, _ = vg({"w": w}, b, init_pod_errors({"w": w}, 2))
    torch.cuda.synchronize()
    vg_ms = 1e3 * (time.perf_counter() - t0)
    exact, exact_loss = torch.func.grad_and_value(reference_loss)({"w": w}, b)
    rel = float((grads["w"] - exact["w"]).abs().max()
                / exact["w"].abs().max())
    dloss = abs(float(loss) - float(exact_loss))
    check(rel < 0.02 and dloss < 1e-5,
          f"parallel(b) rank {rank}: grad rel err {rel:.3e} (< 0.02), loss "
          f"{float(loss)} vs {float(exact_loss)} (within 1e-5)")

    pod = mesh.get_group("pod")
    fed_gap, fed_bound = feedback_steps(vg, w, b, mesh, pod, torch)
    check(fed_gap <= fed_bound, f"parallel(b) rank {rank}: errors fed back: "
          f"grad + mean error off the exact mean plus error in by "
          f"{fed_gap:.3e} > {fed_bound:.3e}")
    gen = torch.Generator(dev).manual_seed(SEED + mesh.get_coordinate()[0])
    shapes = {"w": (PAR_SIDE, PAR_SIDE)}
    grads = [{k: torch.randn(s, device=dev, generator=gen) * 10.0 ** (t - 1)
              for k, s in shapes.items()} for t in range(TELESCOPE_STEPS)]
    err = init_errors(grads[0])
    sent = {k: torch.zeros(s, device=dev, dtype=torch.float64)
            for k, s in shapes.items()}
    for g in grads:
        red, err = ef_allreduce_tree(g, err, pod)
        for k in sent:
            sent[k] += red[k].double()
    gap, bound = 0.0, 0.0
    for k in shapes:
        true = sum(g[k].double() for g in grads)
        want = true - err[k].double()
        dist.all_reduce(want, group=pod)
        want /= dist.get_world_size(pod)
        top = true.abs().max()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=pod)
        gap = max(gap, float((sent[k] - want).abs().max()))
        bound = max(bound, 3 * TELESCOPE_STEPS * 2.0 ** -23 * float(top))
    check(gap <= bound, f"parallel(b) rank {rank}: error feedback does not "
          f"telescope: {gap:.3e} > {bound:.3e}")
    out = collective_legs(pod, dev, torch)
    out.update(vg_ms=vg_ms, rel=rel, dloss=dloss, gap=gap, bound=bound,
               fed_gap=fed_gap, fed_bound=fed_bound)
    return out


def feedback_steps(vg, w, b, mesh, pod, torch,
                   steps: int = FEEDBACK_STEPS) -> tuple[float, float]:
    """``steps`` calls of the reference problem's ``vg``, each fed the
    errors the last returned (as the full (npods, ...) array): at each,
    grad + mean_p(new error_p) must equal mean_p(exact pod gradient_p +
    error fed in_p), the identity error feedback keeps, within f32
    rounding (4 eps max |y|). A vg that dropped its incoming errors, or
    took another pod's, is off by up to half a quantum (127 / 2 times
    that). Returns the worst gap and its bound. The pods' rows are
    summed with ``all_reduce`` over ``pod`` (gloo's CUDA DTensor
    collectives are not used)."""
    import torch.distributed as dist

    from repro_torch.parallel import init_pod_errors

    npods, me = mesh.shape[0], mesh.get_coordinate()[0]
    exact = torch.func.grad(reference_loss)(
        {"w": w.double()}, b.double().chunk(npods)[me])["w"]

    def pods_mean(x):
        x = x.clone()
        dist.all_reduce(x, group=pod)
        return x / npods

    errors = init_pod_errors({"w": w}, npods)["w"]
    gap, bound = 0.0, 0.0
    for _ in range(steps):
        _, grads, new = vg({"w": w}, b, {"w": errors})
        y = exact + errors[me].double()
        top = y.abs().max()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=pod)
        mine = new["w"].to_local()[0].double()
        diff = grads["w"].double() + pods_mean(mine) - pods_mean(y)
        gap = max(gap, float(diff.abs().max()))
        bound = max(bound, 4 * 2.0 ** -23 * float(top))
        full = torch.zeros((npods,) + tuple(w.shape), device=w.device)
        full[me] = new["w"].to_local()[0]
        dist.all_reduce(full, group=pod)      # every pod's errors
        errors = full
    return gap, bound


def resume_leg(mesh, vortex, n: int, torch, steps: int = RESUME_STEPS):
    """(c) The vortex state (z and gamma, f32 complex) after ``steps`` RK2
    steps at ``n`` saved, restored with ``shardings=`` as replicated
    DTensors on ``mesh`` (bitwise the saved state), and ``steps`` steps
    resumed from their local tensors through the guard's replayed
    programs: bitwise the uninterrupted run. Returns the save and
    restore ms, the checkpoint's bytes and the resumed steps' kernel runs
    and program calls."""
    import os
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.parallel import NamedSharding, PartitionSpec as PS
    from repro_torch.solver import GuardedSolver

    z, g, guard, _, _ = vortex.setup(n, P_TERMS)
    for _ in range(steps):
        z, _ = vortex.rk2_step(z, g, guard, VORTEX_DT)
    with tempfile.TemporaryDirectory() as d:
        _, save_s = host_s(lambda: save_checkpoint(d, steps, {"z": z,
                                                             "gamma": g}),
                           torch)
        z_ref = z
        for _ in range(steps):
            z_ref, _ = vortex.rk2_step(z_ref, g, guard, VORTEX_DT)
        rep = NamedSharding(mesh, PS())
        (tree, step), restore_s = host_s(lambda: restore_checkpoint(
            d, shardings={"z": rep, "gamma": rep}), torch)
        nbytes = sum(os.path.getsize(os.path.join(d, f"step_{step:08d}", f))
                     for f in ("z.npy", "gamma.npy"))
    check(step == steps and all(
        isinstance(v, DTensor) and v.device_mesh is mesh
        and tuple(v.placements) == rep.placements for v in tree.values()),
        f"parallel(c): restored step {step}, "
        f"{[(type(v).__name__, getattr(v, 'placements', None)) for v in tree.values()]}")
    zr, gr = tree["z"].to_local(), tree["gamma"].to_local()
    check(zr.device == z.device and torch.equal(bits(zr), bits(z))
          and torch.equal(bits(gr), bits(g)),
          "parallel(c): the restored state is not bitwise the saved one")
    with method_log(GuardedSolver, ("refresh_guarded", "apply_plan"),
                    torch) as log:
        for _ in range(steps):
            zr, reps = vortex.rk2_step(zr, gr, guard, VORTEX_DT)
            check(all(r.final_backend == "cuda" and r.degradations == ()
                      and r.retries == 0 for r in reps),
                  f"parallel(c): {[r.summary() for r in reps]}")
    check(torch.equal(bits(zr), bits(z_ref)),
          "parallel(c): the resumed run is not bitwise the uninterrupted one")
    calls = [d["calls"] for d in log]
    kinds = program_kinds([p for c in calls for p in c.programs],
                          "parallel(c)")
    check(kinds["replay"] == 4 * steps and kinds["eager"] + kinds["capture"]
          == 0, f"parallel(c): resumed program calls {kinds} (want "
          f"{4 * steps} replays)")
    return {"save_ms": 1e3 * save_s, "restore_ms": 1e3 * restore_s,
            "bytes": nbytes, "runs": kernel_runs(calls), "kinds": kinds}


def parallel_phase(vortex, torch) -> None:
    """The multi-device substrate on the card: (a) and (c) on one NCCL
    rank (mesh (1, 1, 1)), (b) on PAR_RANKS gloo ranks sharing the card
    (NCCL refuses two ranks on one device)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import make_test_mesh, mesh_info
    from repro_torch.testing.ranks import run_ranks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method=f"file://{d}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_test_mesh((1, 1, 1), PAR_AXES)
            a = nccl_leg(mesh, torch)
            print(f"parallel(a): world 1, nccl, mesh {mesh_info(mesh)}; "
                  f"make_compressed_value_and_grad on 2^20 f32 "
                  f"{a['vg_ms']:.2f} ms (first call, NCCL's communicator "
                  f"made in it), {a['vg2_ms']:.2f} ms (second), grad within "
                  f"{a['grad_err']:.3e} of exact (quantum {a['quantum']:.3e});"
                  f" ef_allreduce {a['ef_ms']:.4f} ms, {a['ef_bytes']} B; "
                  f"plain all_reduce {a['plain_ms']:.4f} ms, "
                  f"{a['plain_bytes']} B (host, median of {PAR_REPS})",
                  flush=True)
            c = resume_leg(mesh, vortex, N, torch)
            main_kernels_ran(c["runs"], "parallel(c)")
            print(f"parallel(c): world 1, nccl; vortex N={N} f32 state "
                  f"(z, gamma; {c['bytes']} B) saved after {RESUME_STEPS} "
                  f"RK2 steps in {c['save_ms']:.2f} ms, restored as "
                  f"replicated DTensors in {c['restore_ms']:.2f} ms (bitwise),"
                  f" {RESUME_STEPS} steps resumed: bitwise the uninterrupted "
                  f"run; kernel runs {c['runs']}, program calls {c['kinds']}",
                  flush=True)
        finally:
            dist.destroy_process_group()
    t1 = time.perf_counter()
    b = run_ranks(parallel_rank, PAR_RANKS, backend="gloo", timeout=600)[0]
    print(f"parallel(b): world {PAR_RANKS}, gloo (CUDA tensors on one card), "
          f"mesh {PAR_MESH}; reference problem: grad rel err {b['rel']:.3e} "
          f"(< 0.02), loss off by {b['dloss']:.3e} (< 1e-5), "
          f"{b['vg_ms']:.2f} ms; {FEEDBACK_STEPS} steps errors fed back: "
          f"grad + mean error - (exact + error in) {b['fed_gap']:.3e} (bound "
          f"{b['fed_bound']:.3e}); {TELESCOPE_STEPS} error-feedback steps of "
          f"2^20: sent - (true - error) {b['gap']:.3e} (bound "
          f"{b['bound']:.3e}); over 'pod' ef_allreduce {b['ef_ms']:.3f} ms, "
          f"{b['ef_bytes']} B; plain all_reduce {b['plain_ms']:.3f} ms, "
          f"{b['plain_bytes']} B (host, median of {PAR_REPS}); spawn and "
          f"run {time.perf_counter() - t1:.1f} s", flush=True)
    print(f"parallel: phase {time.perf_counter() - t0:.1f} s (host)",
          flush=True)


def register_phases(torch):
    """Register the per-phase backend: "cuda" without its fused hooks."""
    import dataclasses

    from repro_torch.solver import get_backend, register_backend
    register_backend(dataclasses.replace(
        get_backend("cuda", torch.device("cuda")), name=PHASES,
        m2l_fused=None, eval_fused=None))


def per_phase_path(dt: str, main: dict, torch) -> dict:
    """The per-phase backend on the main path's problems and configs:
    launches per kernel, accuracy, and agreement with the main path (and
    in f64 with the reference backend). Returns the launch totals from
    the host."""
    from repro_torch.core.direct import rel_error_inf
    from repro_torch.solver import FmmSolver

    totals = {k: 0 for k in KERNELS}
    for dist in DISTS:
        m = main[dist]
        tag = f"phases[{dt}/{dist}]"
        phi, calls, cfg, solver, first_s = grown_apply(
            lambda c: FmmSolver.build(c, backend=PHASES), m["cfg"], m["z"],
            m["q"], tag)
        check(cfg == m["cfg"], f"{tag}: caps differ from the main path's")
        check(solver.dispatched["apply"] == PHASES,
              f"dispatched {solver.dispatched}")
        want = phase_counts(cfg)
        check(ran(calls, want), f"{tag}: launches per apply "
              f"{calls_note(calls)} "
              f"(want {want})")
        for k in KERNELS:
            totals[k] += calls.host[k]
        secs = median_apply_s(solver, m["z"], m["q"], phi, tag, torch)
        err = rel_error_inf(phi[m["sample"]].to(torch.complex128),
                            m["d_seen"])
        vs_main = rel_err(phi, m["phi"])
        note = f"vs main path {vs_main:.3e}"
        if dt == "f64":
            vs_ref = rel_err(phi, m["ref"])
            note += f", vs reference backend {vs_ref:.3e}"
            check(vs_main <= F64_TOL and vs_ref <= F64_TOL,
                  f"{tag}: {note} (limit {F64_TOL})")
        print(f"{tag}: launches {calls_note(calls)}; apply "
              f"{1e3 * secs:.1f} ms "
              f"(replayed; the apply_checked above {1e3 * first_s:.1f} ms; "
              f"main path {1e3 * m['secs']:.1f} ms); rel_err_inf vs "
              f"direct {err:.3e} (positions in {dt}); {note}", flush=True)
        check(err < ACC_BOUND[dt], f"{tag}: accuracy {err:.3e} >= "
              f"{ACC_BOUND[dt]}")
        del phi
        torch.cuda.empty_cache()
    return totals


def batched_phase(cfg, torch, backend: str = "cuda") -> dict:
    """``apply_batched`` at B = 4 on ``backend``: one apply's launches,
    every row bitwise equal to its own ``apply``, the first call (eager),
    the second (its capture) and a replay timed. Returns the launches
    from the host."""
    from repro_torch.data import particles
    from repro_torch.errors import CapOverflowError
    from repro_torch.solver import FmmSolver
    from repro_torch.solver.guard import grow_caps

    probs = [particles(d, N, s) for d, s in
             (("uniform", 0), ("normal", 0), ("layer", 0), ("uniform", 1))]
    zb = torch.stack([z for z, _ in probs])
    qb = torch.stack([q for _, q in probs])
    while True:
        solver = FmmSolver.build(cfg, backend=backend)
        try:
            phib, c, dt_b = counted(
                lambda: solver.apply_batched_checked(zb, qb), torch)
        except CapOverflowError as e:
            cfg = grow_caps(cfg, e.margins)
            print(f"batched[{backend}]: caps overflow {e.margins}; raised "
                  f"to strong_cap={cfg.strong_cap} weak_cap={cfg.weak_cap}",
                  flush=True)
            continue
        break
    want = want_counts(cfg) if backend == "cuda" else phase_counts(cfg)
    check(ran(c, want),
          f"batched[{backend}]: launches {calls_note(c)} (want {want} for "
          "B = 4)")
    worst = 0.0
    for b, (z, q) in enumerate(probs):
        row = solver.apply(z, q)
        worst = max(worst, float((phib[b] - row).abs().max()))
    again = []
    for _ in range(2):
        out, c2, secs = counted(lambda: solver.apply_batched_checked(zb, qb),
                                torch)
        check(torch.equal(out, phib) and ran(c2, want),
              f"batched[{backend}]: {calls_note(c2)}, bitwise "
              f"{torch.equal(out, phib)}")
        again.append((secs, calls_note(c2)))
    print(f"batched[{backend}/{cfg.dtype}] B=4: launches {calls_note(c)}; "
          f"first "
          f"call {1e3 * dt_b:.1f} ms, then {1e3 * again[0][0]:.1f} ms "
          f"({again[0][1]}) and {1e3 * again[1][0]:.1f} ms "
          f"({again[1][1]}); max |row - apply| = {worst:.3e}", flush=True)
    check(worst == 0.0, "batched rows differ from single applies")
    return c.host


def direct_phase(rows: list, main: dict, torch) -> None:
    """The direct baseline: one ``nbody_direct`` all-pairs launch at
    N = 2^20 per dtype, timed by CUDA events beside the FMM apply of the
    same problem, then the paper's Fig. 5.5 sweep and its break-even N."""
    from repro_torch.configs import fmm_config
    from repro_torch.core.config import num_levels_for
    from repro_torch.core.direct import rel_error_inf
    from repro_torch.data import particles
    from repro_torch.kernels import (launch_counts, nbody_direct,
                                     reset_launch_counts)
    from repro_torch.solver import FmmSolver

    for dt in ("f32", "f64"):
        m = main[dt]["uniform"]
        cfg = m["cfg"]
        z = m["z"].to(cfg.torch_complex)
        q = m["q"].to(cfg.torch_complex)
        reset_launch_counts()
        phi = nbody_direct(z, z, q)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == {k: int(k == "nbody") for k in KERNELS},
              f"direct[{dt}]: launches {counts} (want nbody 1)")
        check(bool(torch.isfinite(phi).all()), f"direct[{dt}]: not finite")
        # against the f64 direct sum of the positions as the kernel sees
        # them, per target: scaled as the kernel gate scales it
        got = phi[m["sample"]].to(torch.complex128)[:, None]
        ref = m["d_seen"][:, None]
        if dt == "f64":
            gate, tol = scaled_err(got, ref), F64_TOL
        else:
            zs = z[m["sample"]]
            scale = magnitude_sum(zs.real, zs.imag, z.real, z.imag, q.real,
                                  q.imag, torch)[:, None]
            gate, tol = float(((got - ref).abs() / scale).max()), \
                F32_KERNEL_TOL["nbody"]
        err = rel_error_inf(got, ref)
        check(gate <= tol, f"direct[{dt}]: {gate:.3e} > {tol} against the "
              "f64 direct sum")
        ms = time_kernel(staged_launch("nbody", lambda: nbody_direct(z, z, q)),
                         3, torch, warmup=1)
        fmm_ms = 1e3 * m["secs"]
        print(f"direct[{dt}] N={N}: splits={nbody_splits(N, N, dt, torch)}"
              f"; nbody_direct {ms:.2f} ms (CUDA events, "
              f"3 back-to-back launches); FMM apply {fmm_ms:.2f} ms (host "
              f"clock); direct/FMM = {ms / fmm_ms:.2f}; vs the f64 direct "
              f"sum: gate {gate:.3e} (limit {tol:g}), rel_err_inf {err:.3e}",
              flush=True)
        row = next(r for r in rows if r["name"] == f"nbody_{dt}")
        sz = 8 if dt == "f64" else 4
        t_ops = 14.0 * (N * N - N) / PEAK_FLOPS[dt]
        t_bytes = 8.0 * N * sz / PEAK_BYTES
        row.update(launches=counts["nbody"], ms=ms,
                   bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   splits=nbody_splits(N, N, dt, torch))
        del phi

    for dt in ("f32", "f64"):
        table = []
        for n in SWEEP:
            cfg = fmm_config(n, p=P_TERMS, dtype=dt,
                             nlevels=max(1, num_levels_for(n, 45)))
            z, q = particles("uniform", n, SEED)
            phi, _, cfg, solver, first_s = grown_apply(
                lambda c: FmmSolver.build(c), cfg, z, q, f"sweep[{dt}/{n}]")
            fmm_s = median_apply_s(solver, z, q, phi, f"sweep[{dt}/{n}]",
                                   torch)
            zc, qc = z.to(cfg.torch_complex), q.to(cfg.torch_complex)
            reps = 3 if n >= (1 << 18) else 10
            d_ms = time_cuda(lambda: nbody_direct(zc, zc, qc), reps, torch,
                             warmup=1)
            table.append((n, cfg.nlevels, 1e3 * fmm_s, d_ms))
            print(f"sweep[{dt}] N={n} levels={cfg.nlevels}: FMM apply "
                  f"{1e3 * fmm_s:.3f} ms (replayed; its first "
                  f"apply_checked {1e3 * first_s:.3f} ms), direct "
                  f"{d_ms:.3f} ms",
                  flush=True)
        faster = [fmm < d for _, _, fmm, d in table]
        even = next((table[i][0] for i in range(len(table))
                     if all(faster[i:])), None)
        print(f"sweep[{dt}]: break-even N = "
              + (f"{even}" if even else f"none up to 2^{N.bit_length() - 1}")
              + " (the FMM faster than the direct sum from there on)",
              flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card in this process", file=sys.stderr)
        return 2
    from repro_torch.kernels import build_all
    from repro_torch.kernels.build import LIBRARIES

    card = card_line()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    check(set(LIBRARIES) == set(KERNELS),
          f"kernel libraries {sorted(LIBRARIES)} != {sorted(KERNELS)}")
    for name, log in logs.items():
        print(f"ptxas {name}:")
        print("\n".join(ptxas_summary(log)), flush=True)
    # list widths of the uniform plan: weak 128, the others 48
    smem = {dt: {name: lib.smem_bytes(sz, 64, P_TERMS + 1,
                                      128 if name == "m2l" else 48)
                 for name, lib in LIBRARIES.items()}
            for dt, sz in (("f32", 4), ("f64", 8))}
    print(f"dynamic shared memory per block (bytes, from each launcher), "
          f"p={P_TERMS}, n_max=64, lists 48 (weak 128): {smem}", flush=True)
    code = nbody_code()
    for dt, c in code.items():
        print(f"nbody[{dt}]: K={c['k']} targets a thread, "
              f"{c['registers']} registers, SASS pair loop {c['sass_loop']}",
              flush=True)

    rows = []
    for dt in ("f32", "f64"):
        rows += kernel_phase(dt, torch)
    for dt in ("f32", "f64"):
        wide = m2l_wide_phase(dt, torch)
        next(r for r in rows if r["name"] == f"m2l_{dt}")["wide"] = {
            str(W): v for W, v in wide.items()}
    observe_programs()
    served, paths = {}, {}
    for dt in ("f32", "f64"):
        totals, served[dt] = main_path(dt, torch)
        print(f"main[{dt}]: launches from the host {totals}; apply ms "
              f"(replayed) "
              f"{[round(1e3 * m['secs'], 1) for m in served[dt].values()]}, "
              f"first apply_checked ms "
              f"{[round(1e3 * m['first_s'], 1) for m in served[dt].values()]}",
              flush=True)
        paths[dt] = {k: totals[k] for k in
                     ("classify", "upward", "m2l", "p2l", "eval_fused")}
    memory_line("main", torch)
    register_phases(torch)
    for dt in ("f32", "f64"):
        graphs_phase(dt, served[dt], torch)
    memory_line("graphs", torch)
    rows += log_phase(torch)
    memory_line("log", torch)
    rows += block_phase(torch)
    memory_line("block", torch)
    for dt in ("f32", "f64"):
        seam_phase(dt, served[dt], torch)
    for dt in ("f32", "f64"):
        tune_phase(dt, served[dt], torch)
    memory_line("seam+tune", torch)
    for dt in ("f32", "f64"):
        guard_phase(dt, served[dt], torch)
    memory_line("guard", torch)
    fault_walk(torch)
    serve_phase(torch)
    memory_line("faults+serve", torch)
    degenerate_phase(torch)
    vortex = load_example("torch_vortex_dynamics")
    vortex_example(vortex, torch)
    quickstart_example(load_example("torch_quickstart"), torch)
    serve_example(load_example("torch_serve_traffic"), torch)
    substrate_phase(vortex, torch)
    memory_line("examples+substrate", torch)
    parallel_phase(vortex, torch)
    memory_line("parallel", torch)
    for dt in ("f32", "f64"):
        totals = per_phase_path(dt, served[dt], torch)
        print(f"phases[{dt}]: launches from the host {totals}", flush=True)
        paths[dt].update(p2p=totals["p2p"], l2p=totals["l2p"])
    for backend in ("cuda", PHASES):
        batched_phase(served["f32"][DISTS[-1]]["cfg"], torch, backend)
    memory_line("phases+batched", torch)
    direct_phase(rows, served, torch)
    memory_line("direct", torch)
    for row in rows:
        base, rdt = row["name"].rsplit("_", 1)
        if base.endswith("_log") or "_block" in base:
            pass                    # log_phase, block_phase counted theirs
        elif base != "nbody":
            row["launches"] = paths[rdt][base]
        else:
            row.update((k, code[rdt][k])
                       for k in ("k", "registers", "sass_per_pair"))
        check(row["launches"] > 0, f"{row['name']} never launched on the "
              "path that runs it")
    del served

    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
