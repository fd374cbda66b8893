"""Fault-tolerant checkpointing of a pytree of tensors (nested dicts,
lists and tuples; leaves are tensors, numpy arrays or scalars).

The twin of ``repro.checkpoint``, on its on-disk format, so a checkpoint
written by either package restores in the other:

  * atomic: state is written to ``<dir>/tmp-<step>-<pid>`` and
    ``os.replace``d to ``<dir>/step_<8 digits>`` only after every leaf
    and the manifest hit disk — a crash mid-write can never corrupt the
    restore set;
  * one ``.npy`` a leaf, named by its path (``a/w`` -> ``a__w.npy``);
    lists and tuples are paths of indices, so they come back as dicts
    keyed "0", "1", ... (as in the reference);
  * self-describing: ``manifest.json`` carries ``step``, ``leaves``
    (file, shape, dtype, bytes: the integrity check on restore),
    ``time`` and ``format: 1``;
  * async: ``CheckpointManager.save`` copies every leaf to host memory
    before it returns, then hands the disk I/O to a background thread
    (the next save waits on the previous one).

Departures from the reference:

  * Torch tensors are mutable: a caller may update the state in place
    right after ``save`` returns, so the snapshot is a copy of every
    leaf (a CPU tensor's ``.numpy()`` shares its storage; a CUDA
    tensor's copy to the host is a blocking one).
  * A leaf numpy cannot hold (``torch.bfloat16``) raises ``DTypeError``;
    it is not widened.
  * Restore returns tensors, on ``device`` (default: the CUDA card;
    ``device="cpu"`` for the CPU). ``shardings`` is one placement for
    every leaf, or a pytree of placements matching the saved tree
    (leaves it does not name go to ``device``); a placement is a
    ``torch.device`` or a ``repro_torch.parallel.NamedSharding``.
  * Elastic: a leaf restored with a ``NamedSharding`` comes back as a
    ``DTensor`` on its mesh (every rank of the mesh restores), whatever
    mesh it was saved from. A ``DTensor`` leaf is saved as its full
    logical array (``full_tensor()``, a collective: every rank of its
    mesh saves); with more than one rank, rank 0 alone copies the leaves
    to the host and writes, and ``save_checkpoint`` returns on every rank
    once the files are on disk.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..errors import DTypeError
from ..parallel.sharding import NamedSharding, to_sharding


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict[str, Any]):
    if set(flat) == {""}:          # bare-leaf tree
        return flat[""]
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _is_dtensor(leaf) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _host(key: str, leaf, copy: bool) -> np.ndarray:
    """A leaf as a numpy array on the host; with ``copy`` never sharing
    memory with the leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=copy)
        try:
            return t.numpy()
        except TypeError as e:
            raise DTypeError(f"checkpoint leaf {key!r}: numpy cannot hold "
                             f"{leaf.dtype}; cast it first") from e
    return np.array(leaf) if copy else np.asarray(leaf)


def _write(ckpt_dir: str, step: int, flat: dict[str, np.ndarray]) -> str:
    """Write host leaves atomically as ``step``; returns the directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp-{step}-{os.getpid()}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "time": time.time(),
                "format": 1}
    for key, arr in flat.items():
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "bytes": int(arr.nbytes),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _snapshot(flat: dict, copy: bool) -> tuple[dict | None, bool]:
    """(the leaves on the host, or None on a rank that does not write;
    whether the ranks meet after the write). A ``DTensor`` leaf is
    gathered to its full logical array on every rank of its mesh
    (``full_tensor()``, a collective); with ``DTensor`` leaves on more
    than one rank only rank 0 writes, so only rank 0 copies to the
    host."""
    shared = (any(_is_dtensor(v) for v in flat.values())
              and dist.is_initialized() and dist.get_world_size() > 1)
    writes = not shared or dist.get_rank() == 0
    host = {}
    for k, v in flat.items():
        if _is_dtensor(v):
            v = v.full_tensor()
        if writes:
            host[k] = _host(k, v, copy)
    return (host if writes else None), shared


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Atomic, synchronous save. Returns the final directory."""
    host, shared = _snapshot(_flatten(tree), copy=False)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if host is not None:
        final = _write(ckpt_dir, step, host)
    if shared:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int | None = None,
                       shardings=None, *, device=None):
    """Load a checkpoint (the latest when ``step`` is None) as a pytree of
    tensors. Returns ``(tree, step)``. Each leaf goes to its placement in
    ``shardings`` (one for all, or a pytree): a device, or a
    ``NamedSharding`` (a ``DTensor`` on its mesh: the elastic path, the
    mesh may differ from save time); else to ``device`` (default: the
    CUDA card)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for key, meta in manifest["leaves"].items():
        path = os.path.join(d, meta["file"])
        if os.path.getsize(path) < meta["bytes"]:
            raise IOError(f"corrupt checkpoint leaf {key}")
        flat[key] = np.load(path)
    if shardings is None or isinstance(shardings, (str, torch.device,
                                                   NamedSharding)):
        placed = dict.fromkeys(flat, shardings)
    else:
        named = _flatten(shardings)
        placed = {k: named.get(k) for k in flat}

    def place(a, where):
        if isinstance(where, NamedSharding):
            dev = resolve_device(where.mesh.device_type)
            return to_sharding(torch.from_numpy(a).to(dev), where)
        return torch.from_numpy(a).to(resolve_device(
            where if where is not None else device))

    tree = _unflatten({k: place(a, placed[k]) for k, a in flat.items()})
    return tree, step


class CheckpointManager:
    """Async saves + retention (the ``keep`` newest steps) +
    restore-latest."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree, blocking: bool = False):
        """Snapshot ``tree`` to host memory (a copy of every leaf: the
        caller may change its tensors in place as soon as this returns),
        then write it in a background thread (with ``DTensor`` leaves on
        more than one rank: rank 0's thread; the other ranks only join
        the gather)."""
        self.wait()
        host, _ = _snapshot(_flatten(tree), copy=True)
        if host is None:
            return

        def work():
            try:
                _write(self.dir, step, host)
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        """Join the pending save; raise the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                       if d.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, shardings=None, *, device=None):
        self.wait()
        return restore_checkpoint(self.dir, None, shardings, device=device)
