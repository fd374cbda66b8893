"""Mesh axes, logical->physical sharding rules, and constraint helpers —
the twin of ``repro.parallel.sharding`` on ``torch.distributed``.

Physical mesh axes:
  "pod"    cross-pod data parallelism (multi-pod runs only)
  "data"   in-pod data parallelism / FSDP
  "model"  tensor / expert / sequence parallelism

Logical param axes map through ``Rules``; activations use ``batch`` /
``act``. ``maybe_shard`` is a no-op outside a mesh context so
single-device runs need no mesh.

The reference's sharding vocabulary, on DTensor:

  * ``PartitionSpec``: a tuple whose entries are ``None``, a mesh-axis
    name or a tuple of names (a one-name tuple is kept as the name, as
    jax's ``PartitionSpec`` keeps it);
  * ``NamedSharding(mesh, spec)``: its ``placements`` are ``Shard(d)`` on
    each mesh dimension named in entry ``d`` and ``Replicate()`` on the
    rest. Two names in one entry split that tensor dimension over both
    mesh dimensions with the first name major, which is jax's row-major
    device order; names out of mesh order cannot be expressed as DTensor
    placements and raise ``ValueError``.

Departure: the active mesh. The reference reads jax's mesh context;
torch keeps its "current mesh" private, so the port keeps its own stack
behind ``set_mesh(mesh)`` (named after ``jax.set_mesh``) and
``active_mesh()`` reads it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch

class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor: ``PartitionSpec("data", None)``,
    ``PartitionSpec(("pod", "data"), None)``. Missing trailing entries
    replicate."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``PartitionSpec`` over a ``DeviceMesh``; ``placements`` is its
    DTensor form."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        dims = list(self.mesh.mesh_dim_names)
        out: list = [Replicate()] * len(dims)
        for d, entry in enumerate(self.spec):
            names = _names(entry)
            idx = [dims.index(n) for n in names]
            if sorted(set(idx)) != idx:
                raise ValueError(
                    f"spec {self.spec}: the axes {names} of dimension {d} "
                    f"are not in the mesh's order {tuple(dims)}")
            for i in idx:
                if not isinstance(out[i], Replicate):
                    raise ValueError(f"spec {self.spec}: mesh axis "
                                     f"{dims[i]!r} used twice")
                out[i] = Shard(d)
        return tuple(out)


def dp_axes(multi_pod: bool):
    return ("pod", "data") if multi_pod else ("data",)


@dataclasses.dataclass(frozen=True)
class Rules:
    """Logical-axis -> mesh-axes table.

    fsdp: additionally shard the "embed" axis of params over the data axes
    (ZeRO-3 style; required for the >100B archs to fit HBM).
    """
    multi_pod: bool = False
    fsdp: bool = True

    def table(self) -> dict[str | None, Any]:
        dp = dp_axes(self.multi_pod)
        t: dict[str | None, Any] = {
            "vocab": "model",
            "heads": "model",
            "kv": "model",
            "ff": "model",
            "experts": "model",
            "layers": None,
            None: None,
        }
        t["embed"] = dp if self.fsdp else None
        return t

    def batch(self) -> PartitionSpec:
        return PartitionSpec(dp_axes(self.multi_pod))

    def act(self, *rest) -> PartitionSpec:
        return PartitionSpec(dp_axes(self.multi_pod), *rest)


ACT_DP = ("pod", "data")   # data axes for activation batch dims

_MESHES = threading.local()


def _stack() -> list:
    if not hasattr(_MESHES, "stack"):
        _MESHES.stack = []
    return _MESHES.stack


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh``) the active mesh of this thread
    inside the block."""
    _stack().append(mesh)
    try:
        yield mesh
    finally:
        _stack().pop()


def active_mesh():
    """The mesh whose axes sharding constraints may reference, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def maybe_shard(x, spec: PartitionSpec):
    """A sharding constraint that degrades gracefully:

    - identity when no mesh is active (single-device runs);
    - axis names absent from the mesh are dropped (e.g. "pod" on the
      single-pod mesh);
    - axis entries whose product does not divide the corresponding
      tensor dim are dropped (e.g. batch 1 on a 16-wide data axis).

    On a mesh it returns a ``DTensor`` with the kept spec's placements:
    ``distribute_tensor`` of a plain tensor (every rank holds the full
    tensor), ``redistribute`` of a ``DTensor``.

    NOTE: a PartitionSpec entry of None *forces replication* of that dim —
    always spell out the data axes on batch dims.
    """
    mesh = active_mesh()
    if mesh is None:
        return x
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))

    def keep(entry, dim):
        if entry is None:
            return None
        if not isinstance(entry, (tuple, list)):
            entry = (entry,)
        kept = tuple(e for e in entry if e in names)
        total = 1
        for e in kept:
            total *= sizes[e]
        if not kept or total == 0 or dim % total:
            return None
        return kept

    spec = PartitionSpec(*[keep(e, d) for e, d in zip(spec, x.shape)])
    return to_sharding(x, NamedSharding(mesh, spec))


def to_sharding(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """``x`` as a ``DTensor`` with ``sharding``'s placements: a plain
    tensor is the full logical array on every rank, which keeps its own
    block (no scatter from one rank)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)
