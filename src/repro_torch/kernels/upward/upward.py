"""The whole upward pass (P2M, then M2M up to the root) in at most two
launches: CUDA kernel + its plain version.

The kernel (``csrc/upward.cu``) replaces no Pallas kernel: the
reference's upward pass is plain jnp (``repro/core/fmm.py:upward``).
Its plain version is the pipeline's own sweep, ``core.fmm.upward``,
which stays the CPU's and the "reference" backend's path. Operands, with
a leading problem axis B:

  z, q      (B, N) complex rank-sorted positions and strengths, read as
            interleaved (real, imag) pairs
  bounds    (4**L + 1,) int32 first rank of each leaf of the static
            leaf layout, then N, shared by the batch
  centers   (B, sum 4**l) complex box centers, every level, root first
  rho       (B, sum 4**l) effective box radii, the same order

Result: (B, sum 4**l, p+1) complex radius-normalized multipoles in the
same order, each box written once; ``upward_cuda`` hands them back as
the per-level (B, 4**l, p+1) views the pipeline reads. K densities on
one plan (B = 1): q and the result carry K rows, the positions,
centres and radii one; the kernel is then ``upward_block_kernel`` (entry
``upward_block_<dtype>``), the density its grid's second axis.
"""
from __future__ import annotations

import torch

from ...core.config import FmmConfig
from ...core.fmm import upward as upward_plain
from ...core.topology import leaf_layout
from ..build import CudaLibrary, I, P, check_tensors, on_cpu
from ..common import geometry_rows

LIB = CudaLibrary("upward", {
    f"upward{k}_{s}": [P] * 5 + [I] * 6 + [P, P]
    for k in ("", "_block") for s in ("f32", "f64")})


def upward_launches(nlevels: int) -> int:
    """Launches of one pass: the leaf stage (P2M and the lowest M2M
    levels, every level up to two), and above two levels the top stage
    (at most the four top levels, one block a problem)."""
    return 1 if nlevels <= 2 else 2


def upward_cuda(tree, cfg: FmmConfig, rho) -> list:
    """Drop-in ``upward_impl`` for ``core.fmm.fmm_evaluate``: the
    per-level (B, 4**l, p+1) normalized multipoles of B problems from the
    per-level effective radii ``rho``. The kernel on CUDA tensors
    (``upward_launches`` launches), the plain ``upward`` on CPU
    tensors."""
    if on_cpu(tree.z):
        return upward_plain(tree, cfg, rho)
    L, dev = cfg.nlevels, tree.z.device
    z, q = tree.z.contiguous(), tree.q.contiguous()
    check_tensors(z, q, dtype=cfg.torch_complex, device=dev)
    bounds = leaf_layout(cfg.n, L, dev).bounds
    centers = torch.cat(tree.centers, dim=1)
    rh = torch.cat(rho, dim=1)
    check_tensors(bounds, dtype=torch.int32, device=dev)
    check_tensors(centers, dtype=cfg.torch_complex, device=dev)
    check_tensors(rh, dtype=cfg.torch_real, device=dev)
    K, N = q.shape
    out = torch.empty((K, centers.shape[1], cfg.p + 1),
                      dtype=cfg.torch_complex, device=dev)
    sfx = "f64" if cfg.dtype == "f64" else "f32"
    entry = "upward_block" if geometry_rows(z, q) else "upward"
    for stage in range(upward_launches(L)):
        LIB.launch(f"{entry}_{sfx}", torch.view_as_real(z),
                   torch.view_as_real(q), bounds, torch.view_as_real(centers),
                   rh, K, N, L, cfg.p + 1,
                   int(cfg.kernel == "log"), stage, torch.view_as_real(out))
    offs = [(4**l - 1) // 3 for l in range(L + 2)]
    return [out[:, offs[l]:offs[l + 1]] for l in range(L + 1)]
