"""Direct particle -> local shifts (P2L): CUDA kernel + plain version.

The kernel (``csrc/p2l.cu``) replaces the reference's Pallas kernel
``repro/kernels/eval/p2l.py:_p2l_pallas``. Operands, with a leading
problem axis B:

  lists          (B, nb, S) int32 leaf p2l lists (-1 masked)
  z0r, z0i, rho  (B, nb) target-leaf centers and effective radii
  xr, xi, qr, qi (B, nb, n) dense leaf particle planes (zero padding)

Result: (outr, outi), (B, nb, p+1) radius-normalized local-coefficient
contributions. A source particle with |x - z0| == 0 is masked, as in the
Pallas kernel (the plain sweep ``core.fmm.p2l_sweep`` goes singular
there instead).

K densities on one plan (B = 1): qr, qi and the result carry K rows,
the lists, centres, radii and positions one; the kernel is then
``p2l_block_kernel`` (entry ``p2l_block_<dtype>``), one launch with the
density as its grid's second axis.
"""
from __future__ import annotations

import torch

from ...core.fmm import rows
from ..build import CudaLibrary, I, P, check_tensors, on_cpu
from ..common import geometry_rows

LIB = CudaLibrary("p2l", {
    f"p2l{k}_{s}": [P] * 8 + [I] * 6 + [P, P, P]
    for k in ("", "_block") for s in ("f32", "f64")})


def p2l_plain(lists, z0r, z0i, rho, xr, xi, qr, qi, *, p: int,
              kernel: str = "harmonic"):
    """Plain torch version of the kernel (same operands and result)."""
    dt = xr.dtype
    zero = torch.zeros((), dtype=dt, device=xr.device)
    cr, ci, rh = z0r[..., None], z0i[..., None], rho[..., None]
    B, nb, S = lists.shape
    outr = torch.zeros((B, nb, p + 1), dtype=dt, device=xr.device)
    outi = torch.zeros_like(outr)
    for s in range(S):
        src = lists[..., s].long()
        bmask = (src >= 0)[..., None]
        srcc = torch.where(src >= 0, src, torch.zeros_like(src))
        px, py = rows(xr, srcc), rows(xi, srcc)
        cq, sq = rows(qr, srcc), rows(qi, srcc)
        dxr, dxi = px - cr, py - ci
        d2 = dxr * dxr + dxi * dxi
        ok = (d2 > 0) & bmask
        k = torch.where(ok, 1.0 / torch.where(ok, d2, zero + 1), zero)
        invr, invi = dxr * k, -dxi * k
        wr, wi = rh * invr, rh * invi
        cols_r, cols_i = [], []
        if kernel == "harmonic":
            pwr, pwi = cq * invr - sq * invi, cq * invi + sq * invr
            for _ in range(p + 1):
                cols_r.append(torch.where(ok, pwr, zero).sum(dim=-1))
                cols_i.append(torch.where(ok, pwi, zero).sum(dim=-1))
                pwr, pwi = pwr * wr - pwi * wi, pwr * wi + pwi * wr
        else:
            lr = torch.where(ok, 0.5 * torch.log(torch.where(ok, d2, zero + 1)),
                             zero)
            li = torch.where(ok, torch.atan2(-dxi, -dxr), zero)
            cols_r.append(torch.where(bmask, cq * lr - sq * li, zero)
                          .sum(dim=-1))
            cols_i.append(torch.where(bmask, cq * li + sq * lr, zero)
                          .sum(dim=-1))
            pwr, pwi = cq * wr - sq * wi, cq * wi + sq * wr
            for l in range(1, p + 1):
                cols_r.append(-torch.where(ok, pwr, zero).sum(dim=-1) / l)
                cols_i.append(-torch.where(ok, pwi, zero).sum(dim=-1) / l)
                pwr, pwi = pwr * wr - pwi * wi, pwr * wi + pwi * wr
        outr = outr + torch.stack(cols_r, dim=-1)
        outi = outi + torch.stack(cols_i, dim=-1)
    return outr, outi


def p2l_cuda(lists, z0r, z0i, rho, xr, xi, qr, qi, *, p: int,
             kernel: str = "harmonic"):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if on_cpu(lists):
        return p2l_plain(lists, z0r, z0i, rho, xr, xi, qr, qi, p=p,
                         kernel=kernel)
    B, nb, S = lists.shape
    n = xr.shape[-1]
    dt = xr.dtype
    check_tensors(lists, dtype=torch.int32)
    check_tensors(z0r, z0i, rho, xr, xi, qr, qi, dtype=dt,
                  device=lists.device)
    K = qr.shape[0]
    outr = torch.empty((K, nb, p + 1), dtype=dt, device=lists.device)
    outi = torch.empty_like(outr)
    sfx = "f64" if dt == torch.float64 else "f32"
    entry = "p2l_block" if geometry_rows(lists, qr) else "p2l"
    LIB.launch(f"{entry}_{sfx}", lists, z0r, z0i, rho, xr, xi, qr, qi, K,
               nb, S, n, p + 1, int(kernel == "log"), outr, outi)
    return outr, outi
