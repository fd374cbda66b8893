"""Production mesh definitions — the twin of ``repro.launch.mesh`` on
``torch.distributed``.

``make_production_mesh`` is a FUNCTION (not a module-level constant) so
that importing this module never touches the process group.

Topology: pods of 256 devices as a 16x16 ("data", "model") torus;
multi-pod adds a leading "pod" axis over the (slower) inter-pod links —
collectives we place on "pod" are the ones gradient compression targets.

Each mesh is ``init_device_mesh(device_type, shape, mesh_dim_names=axes)``
over the default process group, which the caller initialises
(``torch.distributed.init_process_group``: one process a rank).
``device_type`` defaults to the CUDA card (``resolve_device``). Departure:
a ``DeviceMesh`` covers the whole world, so a world of any other size
than the mesh's raises ``MeshError``; ``jax.make_mesh`` takes the first
devices of a larger set.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from ..device import resolve_device
from ..errors import MeshError


def _make_mesh(shape, axes, device_type=None):
    if not dist.is_initialized():
        raise MeshError(f"a {tuple(shape)} mesh needs the default process "
                        "group: call torch.distributed.init_process_group "
                        "first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise MeshError(f"Number of ranks {world} must equal the product "
                        f"of mesh_shape {tuple(shape)}")
    from torch.distributed.device_mesh import init_device_mesh

    kind = device_type or resolve_device().type
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type=None):
    """Small mesh for tests (gloo ranks on the CPU: ``device_type="cpu"``)."""
    return _make_mesh(shape, axes, device_type)


def mesh_info(mesh) -> dict:
    return {
        "axes": dict(zip(mesh.mesh_dim_names, mesh.shape)),
        "n_devices": int(mesh.size()),
    }
