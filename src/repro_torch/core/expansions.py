"""Radius-normalized expansion translations (2D, complex plane).

Conventions (paper §2, eqs (2.2)-(2.3)):

  multipole around z0:  M(z) = a_0 log(z - z0) + sum_{j=1..p} a_j (z - z0)^{-j}
  local     around z0:  L(z) = sum_{j=0..p} b_j (z - z0)^j

Coefficients are stored scaled by the owning box's effective radius rho:
a~_j = a_j rho^-j and b~_l = b_l rho^l. Every translation then multiplies
only bounded ratios (|t|/rho_parent, rho_child/rho_parent, rho/r), so no
power of a small length is ever inverted — which is what lets deep trees
run in f32.

Only what the main path and its plain versions use is here: the constant
Hankel-binomial matrix of M2L, the normalized M2M and L2L Pascal passes,
and the two forms of normalized M2L ("mxu": diag-scale, constant
(p+1)^2 matrix product, diag-scale; "horner": the paper's Algorithm 3.6).
Each is the torch twin of the function of the same name in
``repro.core.expansions``. Coefficient tensors have shape (..., p+1).
"""
from __future__ import annotations

import numpy as np
import torch


def _binom_table(n: int) -> np.ndarray:
    c = np.zeros((n + 1, n + 1))
    c[:, 0] = 1.0
    for i in range(1, n + 1):
        for j in range(1, i + 1):
            c[i, j] = c[i - 1, j - 1] + c[i - 1, j]
    return c


def m2l_matrix(p: int) -> np.ndarray:
    """H with b_hat = H @ a_hat; a_hat_k = a_k r^-k, b_l = b_hat_l (-1)^l r^-l
    (l>=1), b_0 = b_hat_0 + a_0 log r;  r = z_target - z_source.
    H[l,k] = C(l+k-1, k-1) for l>=1,k>=1; H[0,k]=1 (k>=1); H[l,0] = -1/l."""
    c = _binom_table(2 * p)
    h = np.zeros((p + 1, p + 1))
    for k in range(1, p + 1):
        h[0, k] = 1.0
    for l in range(1, p + 1):
        h[l, 0] = -1.0 / l
        for k in range(1, p + 1):
            h[l, k] = c[l + k - 1, k - 1]
    return h


def pows(r: torch.Tensor, p: int) -> torch.Tensor:
    """[r^0, r^1, ..., r^p] stacked on a new trailing axis."""
    out = [torch.ones_like(r)]
    for _ in range(p):
        out.append(out[-1] * r)
    return torch.stack(out, dim=-1)


def m2m_norm(a: torch.Tensor, u: torch.Tensor,
             ratio: torch.Tensor) -> torch.Tensor:
    """Normalized M2M: u = t/rho_parent, ratio = rho_child/rho_parent."""
    p = a.shape[-1] - 1
    c = [a[..., 0]]
    w = torch.ones_like(ratio)
    for j in range(1, p + 1):
        w = w * ratio
        c.append(a[..., j] * w)
    for k in range(p, 1, -1):            # Pascal pass with multiplier u
        for j in range(k, p + 1):
            c[j] = c[j] + u * c[j - 1]
    w = torch.ones_like(u)
    out = [c[0]]
    for j in range(1, p + 1):            # log-source correction
        w = w * u
        out.append(c[j] - c[0] * w / j)
    return torch.stack(out, dim=-1)


def l2l_norm(b: torch.Tensor, v: torch.Tensor,
             ratio: torch.Tensor) -> torch.Tensor:
    """Normalized L2L: v = s/rho_parent, ratio = rho_child/rho_parent."""
    p = b.shape[-1] - 1
    c = [b[..., j] for j in range(p + 1)]
    for k in range(p + 1):               # suffix passes with multiplier v
        for j in range(p - k, p):
            c[j] = c[j] + v * c[j + 1]
    w = torch.ones_like(ratio)
    out = [c[0]]
    for l in range(1, p + 1):
        w = w * ratio
        out.append(c[l] * w)
    return torch.stack(out, dim=-1)


def m2l_norm(a: torch.Tensor, r: torch.Tensor, rho_s: torch.Tensor,
             rho_t: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Normalized M2L with the constant Hankel matrix ``mat`` (real,
    (p+1, p+1)); r = z_target - z_source. All scale vectors are powers of
    rho/r ratios bounded by the theta-criterion."""
    p = a.shape[-1] - 1
    pre = pows(rho_s / r, p)
    pre[..., 0] = 1.0                    # a~_0 = a_0 (log strength)
    a_hat = a * pre
    b_hat = torch.einsum("...k,lk->...l", a_hat, mat.to(a_hat.dtype))
    b = b_hat * pows(-rho_t / r, p)
    b[..., 0] = b[..., 0] + a[..., 0] * torch.log(r)
    return b


def m2l_norm_horner(a: torch.Tensor, r: torch.Tensor, rho_s: torch.Tensor,
                    rho_t: torch.Tensor) -> torch.Tensor:
    """Normalized Algorithm 3.6 (positive-Pascal chain)."""
    p = a.shape[-1] - 1
    ws = rho_s / r
    b = [torch.zeros_like(a[..., 0]) for _ in range(p + 1)]
    w = torch.ones_like(r)
    for j in range(1, p + 1):
        w = w * ws
        b[j - 1] = a[..., j] * w
    for k in range(2, p + 1):
        for j in range(p - k, p):
            b[j] = b[j] + b[j + 1]
    for k in range(p, 0, -1):
        for j in range(k, p + 1):
            b[j] = b[j] + b[j - 1]
    a0 = a[..., 0]
    wt = -rho_t / r
    w = torch.ones_like(r)
    out = [b[0] + a0 * torch.log(r)]
    for j in range(1, p + 1):
        w = w * wt
        out.append((b[j] - a0 / j) * w)
    return torch.stack(out, dim=-1)
