#!/usr/bin/env python3
"""Time the port's kernels on one CUDA card, for one source tree.

    python3 scripts/time_kernels.py [--src DIR] [--label TEXT]
                                    [--only NAME,...] [--kernel log]
                                    [--sass] [--p P]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``;
another tree's ``src``, e.g. an earlier commit unpacked with ``git
archive``, compares two versions of a kernel in one call), builds its
kernels, and for the uniform N = 2^20, p = 17 plan in f32 and f64
captures each kernel's operands through the FMM hooks and times the one
launch its wrapper makes the way ``chip_smoke.py`` does: many
back-to-back launches of the recorded launch on the staged operands
between one pair of CUDA events (``chip_smoke.time_kernel``). The
N-body kernel runs at chip_smoke's sampled shape (4096 targets against
all 2^20 sources, "nbody") and as one full all-pairs launch (2^20
targets, "nbody_all", 3 launches). Prints one JSON line per dtype: the
label, the dtype, the plan's occupied list entries, milliseconds per
launch by kernel, a digest of each kernel's output bytes, and the
N-body kernel's source splits at both shapes, targets a thread (K),
registers, SASS instructions a pair in its pair loop, and the SM clock
and power that ``nvidia-smi`` sampled during the all-pairs launches
(``--only`` times the kernels named; "nbody_all" is the all-pairs
launch, "m2l_levels" the per-phase path's M2L, one launch a level,
timed and digested as one, "upward" the upward pass's launches, timed
and digested as one). ``--kernel log`` times the kernels with an
f64 log branch (the fused evaluation, P2P, M2L and P2L) on the log leg's
plan instead (``chip_smoke.log_config``: layer particles, G = log, caps
256/1024). ``--sass`` also prints one JSON line of the code of the fused
evaluation, P2P, M2L, P2L and upward kernels: a digest of each
instantiation's SASS
(``cuobjdump -sass``; equal digests across two trees: the same machine
code), its registers and spills (``-Xptxas -v``) and the opcode mix of
its pair loop (``chip_smoke.sass_pair_loop``: the innermost loop with
the most reciprocal estimates, one a harmonic pair and two a log pair in
f64). The operands come from the seed,
so two trees whose kernel gives bitwise the same output print the same
digest; the fused evaluation and L2P take their local-expansion planes
from the seed too (not from the downward pass, whose M2L and P2L
roundings would otherwise reach them).

``--p`` times either plan at another expansion order (default 17; another
p runs the kernels' generic-P instantiations).

Needs a CUDA card; exits nonzero without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as smoke  # noqa: E402


# Positions of the local-expansion planes (real, imaginary) among the
# operands of the kernels that read them.
LOCAL_PLANES = {"eval_fused": (9, 10), "l2p": (0, 1)}
# The kernels ``--kernel log`` times.
LOG_TIMED = ("eval_fused", "p2p", "m2l", "p2l")
# The libraries whose code ``--sass`` reports (the first two share the
# pair loop).
SASS_LIBS = ("eval_fused", "p2p", "m2l", "p2l", "upward")
# One instruction of ``cuobjdump -sass``: address, text, encoding words.
SASS_LINE = (r"/\*([0-9a-f]{4,})\*/\s+(.*?);\s+/\* (0x[0-9a-f]+) \*/\s*\n"
             r"\s*/\* (0x[0-9a-f]+) \*/")


def output_digest(name: str, kern, args, kwargs, torch) -> str:
    """The first 16 hex digits of the SHA-256 of the kernel's output
    bytes, its local-expansion planes (if it reads any) replaced by
    seeded normal values."""
    args = list(args)
    gen = torch.Generator().manual_seed(smoke.SEED)
    for i in LOCAL_PLANES.get(name, ()):
        args[i] = torch.randn(args[i].shape, generator=gen,
                              dtype=args[i].dtype).to(args[i].device)
    h = hashlib.sha256()
    for out in kern(args, kwargs):
        h.update(out.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def sampled_clock(fn):
    """``fn()`` while ``nvidia-smi`` samples the card every 100 ms: its
    result and the median SM clock (MHz) and power draw (W) of the
    samples (None where none came)."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        out = fn()
    finally:
        proc.terminate()
        text = proc.communicate()[0]
    samples = []
    for row in text.splitlines():
        try:
            samples.append([float(v) for v in row.split(",")])
        except ValueError:
            continue
    med = (lambda i: statistics.median(r[i] for r in samples)
           if samples else None)
    return out, {"sm_mhz": med(0), "power_w": med(1), "samples": len(samples)}


def sass_report(logs: dict) -> dict:
    """Per instantiation of each kernel of SASS_LIBS: a digest of its
    SASS instructions, its ``-Xptxas -v`` line and its pair loop."""
    from repro_torch.kernels.build import LIBRARIES, nvcc_path

    tool = Path(nvcc_path()).parent / "cuobjdump"
    out = {}
    for lib in SASS_LIBS:
        sass = subprocess.run([str(tool), "-sass",
                               str(LIBRARIES[lib].target())],
                              capture_output=True, text=True,
                              check=True).stdout
        ptxas = {line.split(":", 1)[0].strip(): line.split(":", 1)[1].strip()
                 for line in smoke.ptxas_summary(logs.get(lib, ""))}
        loops = smoke.sass_pair_loop(sass, f"{lib}_kernel")
        for block in re.split(r"\n\s*Function : ", sass)[1:]:
            name = smoke.demangle(block.split("\n", 1)[0].strip())
            # each instruction and its two encoding words, without the
            # padding, which follows the longest line of the whole file
            code = "\n".join(" ".join(" ".join(part.split()) for part in ins)
                             for ins in re.findall(SASS_LINE, block))
            out[f"{lib}:{name}"] = dict(
                sass=hashlib.sha256(code.encode()).hexdigest()[:16],
                ptxas=ptxas.get(name), loop=loops.get(name))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory that holds the repro_torch package")
    ap.add_argument("--label", default="", help="tag of the printed lines")
    ap.add_argument("--reps", type=int, default=smoke.KERNEL_REPS)
    ap.add_argument("--only", default="",
                    help="comma-separated kernels to time (default: all)")
    ap.add_argument("--kernel", choices=("harmonic", "log"),
                    default="harmonic",
                    help="log: the f64 log branches on the log leg's plan")
    ap.add_argument("--sass", action="store_true",
                    help="also print the SASS digests and pair loops")
    ap.add_argument("--p", type=int, default=smoke.P_TERMS,
                    help="expansion order of the plan")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA card in this process", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.configs import fmm_config
    from repro_torch.data import particles
    from repro_torch.kernels import build_all

    print(f"{args.label}: repro_torch from {Path(repro_torch.__file__).parent}"
          f"; {smoke.card_line()}", flush=True)
    logs = build_all()
    if args.sass:
        print(json.dumps({"label": args.label, "sass": sass_report(logs)}),
              flush=True)
    log = args.kernel == "log"
    code = None if log else smoke.nbody_code()
    for dt in ("f64",) if log else ("f32", "f64"):
        z, q = particles("layer" if log else "uniform", smoke.N, smoke.SEED)
        start = (dataclasses.replace(smoke.log_config(dt), p=args.p) if log
                 else fmm_config(smoke.N, p=args.p, dtype=dt))
        cfg, cap, occupied = smoke.capture(start, z, q, torch)
        ms, digest = {}, {}
        only = (set(filter(None, args.only.split(",")))
                or (set(LOG_TIMED) if log else set()))
        for name, (kern, _) in smoke.kernel_impls(cfg).items():
            if only and name not in only:
                continue
            a, k = cap[name]
            call = smoke.staged_launch(name, lambda: kern(a, k),
                                       smoke.launches_of(name, cfg))
            ms[name] = smoke.time_kernel(call, args.reps, torch)
            digest[name] = output_digest(name, kern, a, k, torch)
        if not only or "m2l_levels" in only:
            from repro_torch.kernels import m2l_cuda
            calls = [smoke.staged_launch("m2l", lambda a=a: m2l_cuda(*a))
                     for a in cap["m2l_levels"]]
            ms["m2l_levels"] = smoke.time_kernel(
                lambda: [c() for c in calls], args.reps, torch)
            h = hashlib.sha256()
            for a in cap["m2l_levels"]:
                for out in m2l_cuda(*a):
                    h.update(out.cpu().numpy().tobytes())
            digest["m2l_levels"] = h.hexdigest()[:16]
        line = {"label": args.label, "dtype": dt, "kernel": args.kernel,
                "occupied": occupied, "ms": ms, "digest": digest}
        if not only or "nbody_all" in only:
            # every particle a target: the direct baseline's launch
            kern = smoke.kernel_impls(cfg)["nbody"][0]
            a, k = cap["nbody"]
            full = a[2:4] + a[2:]
            call = smoke.staged_launch("nbody", lambda: kern(full, k))
            ms["nbody_all"], clock = sampled_clock(
                lambda: smoke.time_kernel(call, 3, torch, warmup=1))
            digest["nbody_all"] = output_digest("nbody", kern, full, k, torch)
            line["nbody"] = dict(code[dt], clock_during_all=clock, splits={
                "sample": smoke.nbody_splits(smoke.N_SAMPLE, smoke.N, dt,
                                             torch),
                "all": smoke.nbody_splits(smoke.N, smoke.N, dt, torch)})
        print(json.dumps(line), flush=True)
        del cap, z, q
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
