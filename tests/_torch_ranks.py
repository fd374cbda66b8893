"""Rank functions of the port's multi-rank parity tests
(``tests/test_torch_parallel.py``), run by
``repro_torch.testing.ranks.run_ranks`` over gloo on the CPU. Each runs
several checks in one spawn and returns plain numbers and numpy arrays;
the tests compare them with the JAX reference (``tests/_parallel_ref.py``).
Imports torch and the port only, so a spawned rank starts quickly.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from _parallel_ref import SHARD_CASES, VG_STEPS, inputs, loss_fn

TRACE_N = 1 << 16
TELESCOPE_SHAPES = {"a": (64, 48), "b": (1000,)}
TELESCOPE_STEPS = 3


def _np(t):
    return t.detach().cpu().numpy()


def _spec(dt, mesh):
    """The spec of a DTensor's placements on ``mesh`` (one entry a tensor
    dimension: the mesh axes that shard it), trailing Nones dropped."""
    from torch.distributed.tensor import Shard

    entries: list = [()] * dt.ndim
    for name, pl in zip(mesh.mesh_dim_names, dt.placements):
        if isinstance(pl, Shard):
            entries[pl.dim] = entries[pl.dim] + (name,)
    while entries and not entries[-1]:
        entries.pop()
    return tuple(e or None for e in entries)


def ckpt_tree(mesh=None):
    """The checkpoint of the elastic tests: full arrays, or (on ``mesh``)
    DTensors sharded over both axes, over one, and replicated."""
    from repro_torch.parallel import NamedSharding, PartitionSpec as PS
    from repro_torch.parallel.sharding import to_sharding

    full = {"a": {"w": torch.arange(48, dtype=torch.float32).reshape(8, 6)},
            "b": torch.linspace(-1, 1, 8, dtype=torch.float64),
            "c": torch.tensor([3, 1, 4], dtype=torch.int32)}
    if mesh is None:
        return full
    specs = {"a": {"w": PS("data", "model")}, "b": PS(("data", "model")),
             "c": PS()}
    return {"a": {"w": to_sharding(full["a"]["w"],
                                   NamedSharding(mesh, specs["a"]["w"]))},
            "b": to_sharding(full["b"], NamedSharding(mesh, specs["b"])),
            "c": to_sharding(full["c"], NamedSharding(mesh, specs["c"]))}


def ef_case(rank, world, group) -> dict:
    from repro_torch.parallel import ef_allreduce

    x = inputs()
    m, e = ef_allreduce(torch.from_numpy(x[f"ef{world}_g"][rank]),
                        torch.from_numpy(x[f"ef{world}_err"][rank]), group)
    return {"mean": _np(m), "new_err": _np(e)}


def four(rank, world, ckpt_dir) -> dict:
    """4 ranks: meshes, maybe_shard, ef_allreduce (by group and by axis
    name), traced collective bytes, DTensor checkpoint saves."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import CheckpointManager, save_checkpoint
    from repro_torch.checkpoint import checkpoint as ckpt_mod
    from repro_torch.errors import MeshError
    from repro_torch.launch import (make_production_mesh, make_test_mesh,
                                    mesh_info)
    from repro_torch.launch.hlo_analysis import collective_bytes_traced
    from repro_torch.parallel import (PartitionSpec as PS, ef_allreduce,
                                      maybe_shard, set_mesh)

    out: dict = {}
    mesh = make_test_mesh(device_type="cpu")
    out["mesh_info"] = mesh_info(mesh)
    out["coordinate"] = tuple(mesh.get_coordinate())
    try:
        make_production_mesh(device_type="cpu")
    except MeshError as e:
        out["production_error"] = (type(e).__name__,
                                   isinstance(e, ValueError))
    with set_mesh(mesh):
        for i, (shape, spec) in enumerate(SHARD_CASES):
            x = torch.arange(math.prod(shape),
                             dtype=torch.float32).reshape(shape)
            y = maybe_shard(x, PS(*spec))
            out[f"shard{i}"] = (_spec(y, mesh), _np(y.to_local()),
                                bool(torch.equal(y.full_tensor(), x)))
        y = maybe_shard(maybe_shard(torch.arange(48.0).reshape(8, 6),
                                    PS(("data", "model"))), PS(None, "data"))
        out["reshard"] = (_spec(y, mesh), _np(y.to_local()))
    out["ef_group"] = ef_case(rank, world, dist.group.WORLD)
    with set_mesh(make_test_mesh((4,), ("x",), device_type="cpu")):
        out["ef_named"] = ef_case(rank, world, "x")
    g = torch.randn(TRACE_N, generator=torch.Generator().manual_seed(rank))
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        ef_allreduce(g, torch.zeros_like(g), dist.group.WORLD)
    out["traced_ef"] = collective_bytes_traced(p)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        dist.all_reduce(g.clone())
    out["traced_plain"] = collective_bytes_traced(p)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        dist.all_reduce(g.clone())
        dist.all_gather_into_tensor(torch.empty(4 * 10), torch.ones(10))
    try:
        out["traced_gather"] = collective_bytes_traced(p)
    except ValueError as e:
        out["traced_gather"] = type(e).__name__

    tree = ckpt_tree(mesh)
    # count the leaves each rank copies to the host in the DTensor saves
    host, copied = ckpt_mod._host, []
    ckpt_mod._host = lambda k, v, copy: copied.append(k) or host(k, v, copy)
    try:
        out["saved_to"] = save_checkpoint(os.path.join(ckpt_dir, "dtensor"),
                                          3, tree)
        cm = CheckpointManager(os.path.join(ckpt_dir, "managed"))
        cm.save(5, tree, blocking=True)
    finally:
        ckpt_mod._host = host
    out["host_copies"] = sorted(copied)
    if rank == 0:
        save_checkpoint(os.path.join(ckpt_dir, "full"), 3, ckpt_tree())
    dist.barrier()
    return out


def two(rank, world, ckpt_dir, ref_dir) -> dict:
    """2 ranks: ef_allreduce, and the 4-rank and the reference's
    checkpoints restored onto a (2,) mesh."""
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.launch import make_test_mesh
    from repro_torch.parallel import NamedSharding, PartitionSpec as PS

    out: dict = {"ef_group": ef_case(rank, world, dist.group.WORLD)}
    mesh = make_test_mesh((2,), ("data",), device_type="cpu")
    sh = {"a": {"w": NamedSharding(mesh, PS("data", None))},
          "b": NamedSharding(mesh, PS("data")), "c": NamedSharding(mesh, PS())}
    for tag, d in (("dtensor", os.path.join(ckpt_dir, "dtensor")),
                   ("reference", ref_dir)):
        tree, step = restore_checkpoint(d, shardings=sh)
        leaves = {"a/w": tree["a"]["w"], "b": tree["b"], "c": tree["c"]}
        out[tag] = {"step": step, **{
            k: (_spec(v, mesh), tuple(v.to_local().shape), _np(v.full_tensor()))
            for k, v in leaves.items()}}
    one = NamedSharding(mesh, PS())
    tree, step = CheckpointManager(os.path.join(ckpt_dir, "managed")) \
        .restore_latest(one)
    out["managed"] = (step, _spec(tree["b"], mesh), _np(tree["b"].full_tensor()))
    return out


def eight(rank, world) -> dict:
    """8 ranks, mesh (2, 2, 2): ``make_compressed_value_and_grad`` on the
    reference test's problem and on the seeded one (errors fed back), with
    DTensor and with plain inputs, and with planted feedback faults; error
    feedback telescoping over ``ef_allreduce_tree``."""
    from repro_torch.launch import make_test_mesh, mesh_info
    from repro_torch.parallel import (NamedSharding, PartitionSpec as PS,
                                      ef_allreduce_tree, init_errors,
                                      init_pod_errors,
                                      make_compressed_value_and_grad)
    from repro_torch.parallel.sharding import to_sharding

    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    out: dict = {"mesh_info": mesh_info(mesh)}
    put = lambda x, *spec: to_sharding(x, NamedSharding(mesh, PS(*spec)))
    vg = make_compressed_value_and_grad(loss_fn, mesh)

    w = put(torch.ones(8, 8), None, "model")
    batch = put(torch.arange(16.0).reshape(8, 2), ("pod", "data"), None)
    errors = {"w": put(init_pod_errors({"w": w}, 2)["w"], "pod")}
    loss, grads, errors = vg({"w": w}, batch, errors)
    out["test"] = (_np(loss), _np(grads["w"]), _np(errors["w"].full_tensor()),
                   _spec(errors["w"], mesh))

    x = inputs()
    for tag, dt in (("dtensor", True), ("plain", False)):
        w = torch.from_numpy(x["vg_w"])
        errors = init_pod_errors({"w": w}, 2)
        if dt:
            w = put(w, None, "model")
        steps = []
        for s in range(VG_STEPS):
            b = torch.from_numpy(x["vg_batch"][s])
            loss, grads, errors = vg({"w": w}, put(b, ("pod", "data"), None)
                                     if dt else b, errors)
            steps.append((_np(loss), _np(grads["w"]),
                          _np(errors["w"].full_tensor())))
        out[tag] = steps
    # planted faults: the second step fed zero errors, or pod 0's errors
    # on every pod (what a vg that dropped its incoming errors, or took the
    # wrong pod's slice, would return)
    w = put(torch.from_numpy(x["vg_w"]), None, "model")
    b = put(torch.from_numpy(x["vg_batch"][1]), ("pod", "data"), None)
    e0 = torch.from_numpy(out["dtensor"][0][2])
    for tag, fed in (("zeros", torch.zeros_like(e0)), ("pod0", e0[[0, 0]])):
        _, grads, errors = vg({"w": w}, b, {"w": fed})
        out[f"fault_{tag}"] = (_np(grads["w"]),
                               _np(errors["w"].full_tensor()))

    # error feedback telescopes: sum of what was sent = sum of the true
    # means - the final errors' mean
    pod = mesh.get_group("pod")
    coord = mesh.get_coordinate()[0]
    gen = torch.Generator().manual_seed(100 + coord)
    grads = [{k: torch.randn(s, generator=gen) * 10.0 ** (t - 1)
              for k, s in TELESCOPE_SHAPES.items()}
             for t in range(TELESCOPE_STEPS)]
    err = init_errors(grads[0])
    sent = {k: torch.zeros(s, dtype=torch.float64)
            for k, s in TELESCOPE_SHAPES.items()}
    for g in grads:
        red, err = ef_allreduce_tree(g, err, pod)
        for k in sent:
            sent[k] += red[k].double()
    out["telescope"] = {
        "sent": {k: _np(v) for k, v in sent.items()},
        "true": {k: _np(sum(g[k].double() for g in grads))
                 for k in TELESCOPE_SHAPES},
        "err": {k: _np(v) for k, v in err.items()},
        "pod": coord,
    }
    return out
