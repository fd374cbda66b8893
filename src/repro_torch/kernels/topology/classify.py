"""Theta classification and compaction of one topology level: CUDA
kernel + its plain torch version.

The kernel (``csrc/classify.cu``) replaces the reference's Pallas kernel
``repro/kernels/topology/classify.py:_classify_pallas`` and, on the
card, the plain-torch theta tests and compaction of
``build_connectivity``.
``level_classify_cuda`` is the backend's topology hook (the
``leaf_classify_impl`` of ``build_connectivity``), called once a level,
l = 1..L in order: the parent level's compacted (B, 4**(l-1), S) strong
lists in, level l's strong (B, 4**l, S) and weak (B, 4**l, W) lists out,
and at the leaf also p2p, p2l and m2p (B, 4**L, S), each padded with -1,
with the (B, 4**l, 5) count of each class a row before clipping.

The card compacts each row in the kernel, with no sort: a box's
candidates are the children of its parent's strong entries in list
order, which ascend, so keeping candidate order gives the sorted lists
(``csrc/classify.cu``). The plain version, ``level_classify_plain``, is
``connectivity.classify_level_reference``: it compacts the same way in
torch, is what ``build_connectivity`` calls with no hook (the
"reference" backend's build), and is what the kernel's lists are held
to. Both compute the reference's roundings
(``core/topology/rounding.py``), so they agree bit for bit.
"""
from __future__ import annotations

import torch

from ...core.config import FmmConfig
from ...core.topology.connectivity import (MARGIN_CLASSES,
                                           classify_level_reference,
                                           count_levels)
from ..build import CudaLibrary, D, I, P, check_tensors, on_cpu

LIB = CudaLibrary("classify", {
    f"classify_level_{s}": [P, P, P, I, I, I, I, D, I, I, P, P, P, P, P, P,
                            P]
    for s in ("f32", "f64")})


#: Plain torch version: the same predicates and the same compaction the
#: kernel computes.
level_classify_plain = classify_level_reference


def level_classify_cuda(parent_strong, centers, radii, cfg: FmmConfig,
                        leaf: bool):
    """The topology hook: one kernel launch for the level on CUDA
    tensors, the plain version on CPU tensors. Returns (lists, counts):
    (strong, weak), or at the leaf (strong, weak, p2p, p2l, m2p), and the
    (B, 4**l, 5) int32 count of each class a row."""
    if on_cpu(parent_strong):
        return level_classify_plain(parent_strong, centers, radii, cfg,
                                    leaf)
    rdt = cfg.torch_real
    B, nb = radii.shape
    S, W = cfg.strong_cap, cfg.weak_cap
    parent = parent_strong.contiguous()
    cxy = torch.view_as_real(centers.contiguous())
    rad = radii.contiguous()
    check_tensors(parent, dtype=torch.int32)
    check_tensors(cxy, rad, dtype=rdt, device=parent.device)
    if parent.shape != (B, nb // 4, S) or cxy.shape != (B, nb, 2):
        raise ValueError(f"classify: parent lists {tuple(parent.shape)} and "
                         f"centres {tuple(cxy.shape)} do not fit level "
                         f"({B}, {nb}) at strong_cap {S}")
    strong = parent.new_empty((B, nb, S))
    weak = parent.new_empty((B, nb, W))
    leaves = tuple(parent.new_empty((B, nb, S)) for _ in range(3)) if leaf \
        else (None, None, None)
    counts = parent.new_empty((B, nb, len(MARGIN_CLASSES)))
    sfx = "f64" if rdt == torch.float64 else "f32"
    LIB.launch(f"classify_level_{sfx}", parent, cxy, rad, B, nb, S, W,
               float(cfg.theta), int(cfg.use_p2l_m2p), int(leaf), strong,
               weak, *leaves, counts)
    count_levels(kernel=1)
    lists = (strong, weak) + (leaves if leaf else ())
    return lists, counts
