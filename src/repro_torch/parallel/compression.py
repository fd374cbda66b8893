"""Gradient compression: int8 error-feedback all-reduce — the twin of
``repro.parallel.compression`` on ``torch.distributed``.

Intended placement (1000+ node design): *intra-pod* gradient reductions
ride the fast "data" axis; the *cross-pod* reduction — the slow hop — goes
through ``ef_allreduce`` over the "pod" axis only, quantized to int8 with
one f32 scale per tensor, with error feedback so the quantization noise
telescopes instead of accumulating (Seide et al. 2014; 1-bit Adam
lineage).

As in the reference, the int8 codes are summed as int32
(``all_reduce`` of ``q.to(int32)``), so the payload on the wire is
4 bytes an element, the same as an f32 all-reduce; the int8 codebook
bounds the error, not the bytes.

Departures from the reference (one process a rank here, one program
over many devices there):

  * ``group`` is a process group, or a mesh dimension's name resolved on
    the active mesh (``repro_torch.parallel.sharding.set_mesh``).
  * ``make_compressed_value_and_grad``: GSPMD partitions a pod's work
    over "data" / "model"; here every rank of a pod computes the pod's
    whole gradient on the pod's share of the batch (the same numbers,
    the compute repeated), then reduces over its "pod" group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                tree_unflatten)

from .sharding import NamedSharding, PartitionSpec, active_mesh


def _group(group):
    if isinstance(group, str):
        mesh = active_mesh()
        if mesh is None:
            raise ValueError(f"mesh axis {group!r} named outside a mesh "
                             "context (repro_torch.parallel.set_mesh)")
        return mesh.get_group(group)
    return group


def quantize_int8(x):
    """Per-tensor symmetric int8. Returns (q, scale)."""
    amax = x.abs().max()
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def ef_allreduce(g, err, group):
    """Error-feedback compressed mean of one tensor over ``group`` (a
    process group or a mesh axis name).

    The quantization scale is agreed up front (MAX all-reduce of the
    local amax — one f32 scalar per tensor on the wire) so the int8
    payloads of all members share one codebook and their integer sum
    dequantizes exactly. Returns (mean-reduced tensor f32, new local
    error).
    """
    pg = _group(group)
    y = g.to(torch.float32) + err
    amax = y.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=pg)
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    # the residual y - q*scale rounded once, as the reference's compiled
    # program computes it (XLA contracts it into a fused multiply-add); in
    # f64 the product of an int8 code and an f32 scale and the difference
    # with y are exact
    new_err = (y.double() - q.double() * scale.double()).float()
    n = dist.get_world_size(pg)
    summed = q.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=pg)
    return summed.to(torch.float32) * scale / n, new_err


def ef_allreduce_tree(grads, errors, group):
    flat_g, spec = tree_flatten(grads)
    out_g, out_e = [], []
    for g, e in zip(flat_g, tree_leaves(errors)):
        rg, re = ef_allreduce(g, e, group)
        out_g.append(rg.to(g.dtype))
        out_e.append(re)
    return tree_unflatten(out_g, spec), tree_unflatten(out_e, spec)


def init_errors(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _local(x, mesh, spec: PartitionSpec):
    """This rank's block of ``x`` under ``spec`` on ``mesh`` (the
    reference's shard_map in_specs): a ``DTensor`` is redistributed, a
    plain tensor is the full logical array on every rank."""
    from torch.distributed.tensor import DTensor, Shard

    pl = NamedSharding(mesh, spec).placements
    if isinstance(x, DTensor):
        return x.redistribute(mesh, pl).to_local()
    for mdim, p in enumerate(pl):
        if isinstance(p, Shard):
            x = x.chunk(mesh.shape[mdim], p.dim)[
                mesh.get_local_rank(mdim)]
    return x


def make_compressed_value_and_grad(loss_fn, mesh):
    """Cross-pod compressed data parallelism.

    Wraps ``loss_fn(params, batch) -> scalar`` so that the gradient is
    computed *per pod* on the pod's share of the batch (dimension 0 split
    over "pod"), then mean-reduced across pods through the int8
    error-feedback collective instead of a full-precision all-reduce.

    ``vg(params, batch, errors) -> (loss, grads, errors)``: the loss
    averaged over pods and the grads, the same on every rank (plain
    tensors); the error-feedback state, per pod: leaves carry a leading
    ``npods`` axis sharded over "pod" (``DTensor``s; init with
    ``init_pod_errors``). Inputs may be ``DTensor``s of any placement on
    ``mesh`` or plain tensors holding the full arrays.
    """
    from torch.distributed.tensor import DTensor

    pod = mesh.get_group("pod")
    out_pl = NamedSharding(mesh, PartitionSpec("pod")).placements

    def vg(params, batch, errors):
        p = tree_map(lambda x: _local(x, mesh, PartitionSpec()), params)
        local_batch = tree_map(
            lambda x: _local(x, mesh, PartitionSpec("pod")), batch)
        err = tree_map(lambda e: _local(e, mesh, PartitionSpec("pod"))[0],
                        errors)
        grads, loss = torch.func.grad_and_value(loss_fn)(p, local_batch)
        grads, err = ef_allreduce_tree(grads, err, pod)
        loss = loss.detach().clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=pod)   # pmean
        loss = loss / dist.get_world_size(pod)
        err = tree_map(lambda e: DTensor.from_local(
            e[None], mesh, out_pl, run_check=False), err)
        return loss, grads, err

    return vg


def init_pod_errors(params, npods: int):
    return tree_map(lambda p: torch.zeros((npods,) + tuple(p.shape),
                                           dtype=torch.float32,
                                           device=p.device), params)
