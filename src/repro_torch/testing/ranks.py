"""Run a function on a group of spawned ranks, one process each, joined
in one ``torch.distributed`` process group — how the port's multi-rank
paths (``repro_torch.parallel``, ``repro_torch.launch.mesh``) are driven
on one machine: the CPU tests over gloo, and several ranks sharing one
card.

    results = run_ranks(fn, 4, *args)      # fn(rank, world, *args)

The rendezvous is a file in a fresh temporary directory
(``file://``), so concurrent runs on one machine never collide on a port.
"""
from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback


def _rank_main(fn, rank, world, store, backend, timeout, args, results):
    import faulthandler

    import torch.distributed as dist

    faulthandler.enable()     # a rank that crashes prints its stack
    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, backend: str = "gloo",
              timeout: float = 300.0) -> list:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks; returns
    their results (picklable: numbers, numpy arrays) by rank. ``fn``
    must be importable by name (a module-level function).

    The first rank that raises fails the run: ``RuntimeError`` with its
    traceback, every other rank killed. So does a run that has not
    finished after ``timeout`` seconds. Every process started is gone
    when this returns."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, store, backend, timeout,
                                   args, results), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        out: dict = {}
        failed = None
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world and failed is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failed = f"timed out after {timeout} s with ranks " \
                        f"{sorted(set(range(world)) - set(out))} unfinished"
                    break
                try:
                    rank, ok, val = results.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        failed = f"rank {dead[0]} exited with " \
                            f"{procs[dead[0]].exitcode} and no result"
                    continue
                if ok:
                    out[rank] = val
                else:
                    failed = f"rank {rank} raised:\n{val}"
        finally:
            for p in procs:
                p.join(timeout=10 if failed is None else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    if failed is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}, "
                           f"{world}, {backend}): {failed}")
    return [out[r] for r in range(world)]
