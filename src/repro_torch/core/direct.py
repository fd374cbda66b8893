"""Direct O(N^2) evaluation (paper eq. (1.1)/(1.2)) — oracle + baseline.

``direct_potential`` is the accuracy oracle for the FMM. It runs on the
device of its inputs, chunked over the targets so that the (chunk, N)
pairwise block stays within a fixed element budget. Coincident points
are excluded, matching the ``x_j != y_i`` convention of eq. (1.2).
``direct_potential_numpy`` is the same sum in float64 numpy, one target
at a time: an oracle independent of torch for small-N tests.
"""
from __future__ import annotations

import numpy as np
import torch

#: Elements of one (targets, sources) pairwise block.
_BLOCK_ELEMS = 1 << 25


def direct_potential(z_eval: torch.Tensor, z_src: torch.Tensor,
                     q: torch.Tensor, kernel: str = "harmonic",
                     chunk: int | None = None) -> torch.Tensor:
    """Phi(y_i) = sum_{x_j != y_i} G(y_i, x_j), in the dtype of the inputs.

    G is ``q/(x - y)`` ("harmonic") or ``q log(y - x)`` ("log")."""
    if kernel not in ("harmonic", "log"):
        raise ValueError(kernel)
    n = z_eval.shape[0]
    if chunk is None:
        chunk = max(1, _BLOCK_ELEMS // max(1, z_src.shape[0]))
    out = torch.empty_like(z_eval)
    for s in range(0, n, chunk):
        zc = z_eval[s:s + chunk]
        diff = z_src[None, :] - zc[:, None]
        ok = diff != 0
        safe = torch.where(ok, diff, torch.ones_like(diff))
        if kernel == "harmonic":
            c = q[None, :] / safe
        else:
            c = q[None, :] * torch.log(-safe)
        out[s:s + chunk] = torch.where(ok, c, torch.zeros_like(c)).sum(dim=-1)
    return out


def direct_potential_numpy(z_eval, z_src, q, kernel: str = "harmonic"):
    """float64 numpy oracle (independent of torch) for small-N tests."""
    ze = np.asarray(z_eval, dtype=np.complex128)
    zs = np.asarray(z_src, dtype=np.complex128)
    qs = np.asarray(q, dtype=np.complex128)
    out = np.zeros_like(ze)
    for i in range(len(ze)):
        d = zs - ze[i]
        ok = d != 0
        if kernel == "harmonic":
            out[i] = (qs[ok] / d[ok]).sum()
        else:
            out[i] = (qs[ok] * np.log(-d[ok])).sum()
    return out


def rel_error_inf(phi, phi_ref) -> float:
    """Paper eq. (5.3): || (phi - ref) / ref ||_inf  (on nonzero refs)."""
    if isinstance(phi, torch.Tensor):
        phi = phi.detach().cpu().numpy()
    if isinstance(phi_ref, torch.Tensor):
        phi_ref = phi_ref.detach().cpu().numpy()
    phi = np.asarray(phi)
    ref = np.asarray(phi_ref)
    ok = np.abs(ref) > 0
    return float(np.max(np.abs((phi[ok] - ref[ok]) / ref[ok])))
