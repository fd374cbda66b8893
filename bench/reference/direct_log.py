"""The plain reference of the log kernel: the real part of the direct
O(N^2) sum for real charges,

    Re phi(y_i) = sum_{x_j != y_i} q_j log|y_i - x_j|          (G = q log)

Plain torch in float64, on the device of its inputs, in blocks of targets
so that one (targets, sources) block stays within ``BLOCK_ELEMS``.
Coincident points are left out (``x_j != y_i``), as the port's own
convention. Imports nothing of the port.

Only the real part is a reference. The imaginary part of q log(y - x) is
q arg(y - x), whose branch an expansion and the principal-value direct
sum take differently: they differ by multiples of 2 pi q, which are no
error of the method. So a log answer is compared by its real part alone
(as the JAX package's own log-kernel test compares it), and the charges
must be real.
"""
from __future__ import annotations

import torch

#: Elements of one (targets, sources) block.
BLOCK_ELEMS = 1 << 26


def direct_log(z_eval: torch.Tensor, z_src: torch.Tensor,
               q: torch.Tensor) -> torch.Tensor:
    """Re phi at ``z_eval`` (complex) from sources ``z_src`` (complex) of
    real charges ``q`` (real, or complex with a zero imaginary part), in
    float64; returned as a float64 tensor."""
    if q.is_complex():
        if bool((q.imag != 0).any()):
            raise ValueError("direct_log is the reference of real charges "
                             "only: Re(q log d) of complex q depends on "
                             "the branch of arg d")
        q = q.real
    qr = q.to(torch.float64)
    xs = z_src.real.to(torch.float64)
    ys = z_src.imag.to(torch.float64)
    tx = z_eval.real.to(torch.float64)
    ty = z_eval.imag.to(torch.float64)
    block = max(1, BLOCK_ELEMS // max(1, xs.numel()))
    out = torch.empty(tx.numel(), dtype=torch.float64, device=tx.device)
    for s in range(0, tx.numel(), block):
        dx = xs[None, :] - tx[s:s + block, None]
        dy = ys[None, :] - ty[s:s + block, None]
        r2 = dx * dx + dy * dy
        ok = r2 != 0
        safe = torch.where(ok, r2, torch.ones_like(r2))
        # log|d| = log(r2) / 2
        lg = torch.where(ok, 0.5 * torch.log(safe), torch.zeros_like(r2))
        out[s:s + block] = (qr * lg).sum(dim=-1)
    return out
