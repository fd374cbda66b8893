"""Leaf-level strong/weak/swapped-theta classification: CUDA kernel +
its plain torch version.

The kernel (``csrc/classify.cu``) replaces the reference's Pallas kernel
``repro/kernels/topology/classify.py:_classify_pallas``. It is the
``leaf_classify_impl`` hook of ``build_connectivity``: (B, 4**L, 4S)
candidates in, five keyed (B, 4**L, 4S) int32 arrays out (strong, weak,
p2p, p2l, m2p; kept entries carry the candidate id, dropped entries
INT32_MAX). Kernel and plain version compute the same roundings as the
reference (``core/topology/rounding.py``), so all three agree bit for bit.
"""
from __future__ import annotations

import torch

from ...core.config import FmmConfig
from ...core.topology.connectivity import leaf_classify_reference
from ..build import CudaLibrary, D, I, P, check_tensors, on_cpu

LIB = CudaLibrary("classify", {
    f"classify_{s}": [P, P, P, P, I, I, I, D, I, P, P, P, P, P, P]
    for s in ("f32", "f64")})


def leaf_classify_plain(cand, valid, centers, radii, cfg: FmmConfig):
    """Plain torch version: ``connectivity.leaf_classify_reference``,
    the same predicate formulas the kernel evaluates."""
    return leaf_classify_reference(cand, valid, centers, radii, cfg)


def leaf_classify_cuda(cand, valid, centers, radii, cfg: FmmConfig):
    """The ``leaf_classify_impl`` hook: the kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if on_cpu(cand):
        return leaf_classify_plain(cand, valid, centers, radii, cfg)
    rdt = cfg.torch_real
    B, nb, C = cand.shape
    keys = torch.where(valid, cand, torch.full_like(cand, -1)).to(
        torch.int32).contiguous()
    cx = centers.real.to(rdt).contiguous()
    cy = centers.imag.to(rdt).contiguous()
    rad = radii.to(rdt).contiguous()
    check_tensors(cx, cy, rad, dtype=rdt, device=keys.device)
    outs = [torch.empty_like(keys) for _ in range(5)]
    sfx = "f64" if rdt == torch.float64 else "f32"
    LIB.launch(f"classify_{sfx}", keys, cx, cy, rad, B, nb, C,
               float(cfg.theta), int(cfg.use_p2l_m2p), *outs)
    return tuple(outs)
