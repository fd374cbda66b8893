"""The plain reference: the direct O(N^2) sum, and the numbers that
compare an answer with it.

    phi(y_i) = sum_{x_j != y_i} q_j / (x_j - y_i)        (harmonic G)

Plain torch in real arithmetic, on the device of its inputs, in blocks
of targets so that one (targets, sources) block stays within
``BLOCK_ELEMS``. ``dtype`` is the precision of every operand and product:
float64 for the reference; bfloat16 for the control that stands in for
a program computing below float32. Coincident points are left out
(``x_j != y_i``), as the port's own convention. Imports nothing of the
port.
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: Elements of one (targets, sources) block.
BLOCK_ELEMS = 1 << 26


def direct_sum(z_eval: torch.Tensor, z_src: torch.Tensor, q: torch.Tensor,
               dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """phi at ``z_eval`` from sources ``z_src`` of charges ``q`` (complex
    tensors on one device), computed in ``dtype``; returned as
    complex128."""
    xs = z_src.real.to(dtype)
    ys = z_src.imag.to(dtype)
    qr = q.real.to(dtype)
    qi = q.imag.to(dtype)
    tx = z_eval.real.to(dtype)
    ty = z_eval.imag.to(dtype)
    block = max(1, BLOCK_ELEMS // max(1, xs.numel()))
    out = torch.empty(tx.numel(), dtype=torch.complex128, device=tx.device)
    for s in range(0, tx.numel(), block):
        dx = xs[None, :] - tx[s:s + block, None]
        dy = ys[None, :] - ty[s:s + block, None]
        r2 = dx * dx + dy * dy
        inv = torch.where(r2 != 0, 1 / torch.where(r2 != 0, r2,
                                                   torch.ones_like(r2)),
                          torch.zeros_like(r2))
        # q / (dx + i dy) = q (dx - i dy) / r2
        re = ((qr * dx + qi * dy) * inv).sum(dim=-1)
        im = ((qi * dx - qr * dy) * inv).sum(dim=-1)
        out[s:s + block] = torch.complex(re.to(torch.float64),
                                         im.to(torch.float64))
    return out


def velocity(phi: torch.Tensor) -> torch.Tensor:
    """u + iv of point vortices from their harmonic potential:
    conj(phi / (2 pi i))."""
    return torch.conj_physical(phi / (2j * math.pi))


def errors(got, want) -> dict:
    """How far ``got`` lies from the reference ``want`` (complex arrays
    or tensors, compared in float64): ``inf``, the largest pointwise
    relative error over nonzero references (the paper's eq. 5.3), and
    ``rms``, the normwise relative error ||got - want||_2 / ||want||_2.
    A non-finite ``got`` reads infinity."""
    g = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got
                   ).astype(np.complex128)
    w = np.asarray(want.cpu() if isinstance(want, torch.Tensor) else want
                   ).astype(np.complex128)
    if g.shape != w.shape or not np.isfinite(g).all():
        return {"inf": math.inf, "rms": math.inf}
    d = np.abs(g - w)
    ok = np.abs(w) > 0
    norm = math.sqrt(float(np.sum(np.abs(w) ** 2)))
    return {"inf": float(np.max(d[ok] / np.abs(w[ok]))) if ok.any() else 0.0,
            "rms": math.sqrt(float(np.sum(d ** 2))) / norm if norm else
            float(np.max(d))}
