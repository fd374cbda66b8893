"""Radius-normalized expansion translations (2D, complex plane).

Conventions (paper §2, eqs (2.2)-(2.3)):

  multipole around z0:  M(z) = a_0 log(z - z0) + sum_{j=1..p} a_j (z - z0)^{-j}
  local     around z0:  L(z) = sum_{j=0..p} b_j (z - z0)^j

Coefficients are stored scaled by the owning box's effective radius rho:
a~_j = a_j rho^-j and b~_l = b_l rho^l. Every translation then multiplies
only bounded ratios (|t|/rho_parent, rho_child/rho_parent, rho/r), so no
power of a small length is ever inverted — which is what lets deep trees
run in f32.

The pipeline runs the normalized forms (``p2m_norm``, ``m2m_norm``,
``l2l_norm``, ``m2l_norm`` with the constant Hankel-binomial matrix, and
``m2l_norm_horner``). Beside them are the unscaled forms of the paper's
derivation, as the reference keeps them: the constant binomial matrices
(``m2m_matrix``, ``m2l_matrix``, ``l2l_matrix``), the matrix forms
diag-scale -> constant (p+1)^2 product -> diag-scale (``*_apply``), the
paper's Algorithms 3.4(b), 3.5 and 3.6 (``*_horner``), and the direct
constructors and evaluators of one box (``p2m_single``, ``p2l_single``,
``eval_multipole``, ``eval_local``). Each is the torch twin of the
function of the same name in ``repro.core.expansions``; the numpy
matrices are built as the reference builds them. Coefficient tensors
have shape (..., p+1) and shift offsets shape (...), complex.
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


def m2m_matrix(p: int) -> np.ndarray:
    """A with b_hat = A @ a_hat;  a_hat_j = a_j t^-j, b_hat_l = b_l t^-l,
    t = z_child - z_parent.  A[l,j] = C(l-1, j-1) for 1<=j<=l; the a_0
    (log-source) column is A[l,0] = -1/l; A[0,0] = 1."""
    c = _binom_table(p)
    a = np.zeros((p + 1, p + 1))
    a[0, 0] = 1.0
    for l in range(1, p + 1):
        a[l, 0] = -1.0 / l
        for j in range(1, l + 1):
            a[l, j] = c[l - 1, j - 1]
    return a


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


def l2l_matrix(p: int) -> np.ndarray:
    """B with c_hat = B @ b_hat; b_hat_j = b_j s^j, c_hat_l = c_l s^l,
    s = z_child - z_parent.  B[l,j] = C(j, l) for j>=l."""
    c = _binom_table(p)
    b = np.zeros((p + 1, p + 1))
    for l in range(p + 1):
        for j in range(l, p + 1):
            b[l, j] = c[j, l]
    return b


def pows(r: torch.Tensor, p: int) -> torch.Tensor:
    """[r^0, r^1, ..., r^p] stacked on a new trailing axis."""
    out = [torch.ones_like(r)]
    for _ in range(p):
        out.append(out[-1] * r)
    return torch.stack(out, dim=-1)


def inv_pows(r: torch.Tensor, p: int) -> torch.Tensor:
    return pows(1.0 / r, p)


def _mat(mat, like: torch.Tensor) -> torch.Tensor:
    """A constant matrix (numpy or tensor) in the dtype of ``like``."""
    return torch.as_tensor(mat, device=like.device).to(like.dtype)


# --------------------------------------------------------------------------
# matrix forms: diag-scale -> constant (p+1)^2 product -> diag-scale
# --------------------------------------------------------------------------

def m2m_apply(a: torch.Tensor, t: torch.Tensor, mat) -> torch.Tensor:
    """Shift multipole coefficients by t = z_child - z_parent."""
    p = a.shape[-1] - 1
    a_hat = a * inv_pows(t, p)
    b_hat = torch.einsum("...j,lj->...l", a_hat, _mat(mat, a_hat))
    return b_hat * pows(t, p)


def m2l_apply(a: torch.Tensor, r: torch.Tensor, mat) -> torch.Tensor:
    """Multipole around z_source -> local around z_target; r = z_t - z_s."""
    p = a.shape[-1] - 1
    a_hat = a * inv_pows(r, p)
    b_hat = torch.einsum("...k,lk->...l", a_hat, _mat(mat, a_hat))
    b = b_hat * inv_pows(-r, p)
    b[..., 0] = b[..., 0] + a[..., 0] * torch.log(r)   # log-source term
    return b


def l2l_apply(b: torch.Tensor, s: torch.Tensor, mat) -> torch.Tensor:
    """Shift local coefficients by s = z_child - z_parent."""
    p = b.shape[-1] - 1
    b_hat = b * pows(s, p)
    c_hat = torch.einsum("...j,lj->...l", b_hat, _mat(mat, b_hat))
    return c_hat * inv_pows(s, p)


# --------------------------------------------------------------------------
# the paper's scaled-Horner forms (Algorithms 3.4(b), 3.5, 3.6)
# --------------------------------------------------------------------------

def m2m_horner(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Algorithm 3.4(b). t = z_child - z_parent (paper's r)."""
    p = a.shape[-1] - 1
    rinv = 1.0 / t
    c = [a[..., j] for j in range(p + 1)]
    w = torch.ones_like(t)
    for j in range(1, p + 1):            # pre-scale: a_j /= r^j
        w = w * rinv
        c[j] = c[j] * w
    for k in range(p, 1, -1):            # Pascal accumulation (sequential j)
        for j in range(k, p + 1):
            c[j] = c[j] + c[j - 1]
    w = torch.ones_like(t)
    out = [c[0]]
    for j in range(1, p + 1):            # post-scale + log-source correction
        w = w * t
        out.append((c[j] - c[0] / j) * w)
    return torch.stack(out, dim=-1)


def l2l_horner(b: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Algorithm 3.5. Paper's r = z_parent - z_child = -s."""
    p = b.shape[-1] - 1
    r = -s
    c = [b[..., j] for j in range(p + 1)]
    w = torch.ones_like(r)
    for j in range(1, p + 1):            # pre-scale: b_j *= r^j
        w = w * r
        c[j] = c[j] * w
    for k in range(p + 1):               # inner loop is order-independent
        for j in range(p - k, p):
            c[j] = c[j] - c[j + 1]
    w = torch.ones_like(r)
    out = [c[0]]
    for j in range(1, p + 1):            # post-scale: b_j /= r^j
        w = w * r
        out.append(c[j] / w)
    return torch.stack(out, dim=-1)


def m2l_horner(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Algorithm 3.6. r = z_target - z_source: the all-positive Pascal
    chain, the alternating sign folded into the (-r)^-j post-scale (see
    the reference's note)."""
    p = a.shape[-1] - 1
    rinv = 1.0 / r
    b = [torch.zeros_like(a[..., 0]) for _ in range(p + 1)]
    w = torch.ones_like(r)
    for j in range(1, p + 1):            # b_{j-1} := a_j / r^j
        w = w * rinv
        b[j - 1] = a[..., j] * w
    for k in range(2, p + 1):            # first reduction (L^T)
        for j in range(p - k, p):
            b[j] = b[j] + b[j + 1]
    for k in range(p, 0, -1):            # second reduction (L)
        for j in range(k, p + 1):
            b[j] = b[j] + b[j - 1]
    a0 = a[..., 0]
    w = torch.ones_like(r)
    out = [b[0] + a0 * torch.log(r)]
    for j in range(1, p + 1):
        w = w * (-rinv)
        out.append((b[j] - a0 / j) * w)
    return torch.stack(out, dim=-1)


# --------------------------------------------------------------------------
# direct constructors / evaluators of one box
# --------------------------------------------------------------------------

def p2m_single(x: torch.Tensor, q: torch.Tensor, z0, p: int,
               kernel: str) -> torch.Tensor:
    """Multipole coefficients of sources x (strengths q) around z0 (sums
    over the last axis)."""
    t = x - z0
    if kernel == "harmonic":
        # q/(x - z) = -q sum_k (x-z0)^k (z-z0)^-(k+1): a_j = -sum q t^(j-1)
        coeffs = [q.sum(dim=-1) * 0]
        w = q
        for _ in range(p):
            coeffs.append(-w.sum(dim=-1))
            w = w * t
        return torch.stack(coeffs, dim=-1)
    if kernel == "log":
        # q log(z - x): a_0 = sum q; a_j = -sum q t^j / j
        coeffs = [q.sum(dim=-1)]
        w = q
        for j in range(1, p + 1):
            w = w * t
            coeffs.append(-w.sum(dim=-1) / j)
        return torch.stack(coeffs, dim=-1)
    raise ValueError(kernel)


def p2l_single(x: torch.Tensor, q: torch.Tensor, z0, p: int,
               kernel: str) -> torch.Tensor:
    """Local coefficients around z0 from far sources x (strengths q)."""
    w = 1.0 / (x - z0)
    if kernel == "harmonic":
        # q/(x - z) = q sum_l (z-z0)^l (x-z0)^-(l+1): b_l = sum q w^(l+1)
        pw = q * w
        coeffs = []
        for _ in range(p + 1):
            coeffs.append(pw.sum(dim=-1))
            pw = pw * w
        return torch.stack(coeffs, dim=-1)
    if kernel == "log":
        # q log(z - x) = q log(z0 - x) - q sum_l ((z-z0) w)^l / l
        coeffs = [(q * torch.log(z0 - x)).sum(dim=-1)]
        pw = q * w
        for l in range(1, p + 1):
            coeffs.append(-pw.sum(dim=-1) / l)
            pw = pw * w
        return torch.stack(coeffs, dim=-1)
    raise ValueError(kernel)


def eval_multipole(a: torch.Tensor, z0, z: torch.Tensor) -> torch.Tensor:
    """M(z) for coefficients a around z0 (Horner in 1/(z-z0))."""
    p = a.shape[-1] - 1
    w = 1.0 / (z - z0)
    acc = torch.zeros_like(z) + a[..., p]
    for j in range(p - 1, 0, -1):
        acc = acc * w + a[..., j]
    acc = acc * w
    return acc + a[..., 0] * torch.log(z - z0)


def eval_local(b: torch.Tensor, z0, z: torch.Tensor) -> torch.Tensor:
    """L(z) for coefficients b around z0 (Horner)."""
    p = b.shape[-1] - 1
    t = z - z0
    acc = torch.zeros_like(z) + b[..., p]
    for j in range(p - 1, -1, -1):
        acc = acc * t + b[..., j]
    return acc


# --------------------------------------------------------------------------
# radius-normalized forms (what the pipeline runs)
# --------------------------------------------------------------------------

def p2m_norm(w: torch.Tensor, q: torch.Tensor, inv_rho, p: int,
             kernel: str, seg_sum) -> torch.Tensor:
    """Normalized P2M. w = (x - z0)/rho per particle; ``seg_sum``
    reduces a per-particle tensor to per box. Returns (nbox, p+1) scaled
    coefficients."""
    coeffs = []
    if kernel == "harmonic":
        coeffs.append(seg_sum(q) * 0)
        pw = q
        for _ in range(p):
            coeffs.append(-seg_sum(pw) * inv_rho)
            pw = pw * w
    else:
        coeffs.append(seg_sum(q))
        pw = q
        for j in range(1, p + 1):
            pw = pw * w
            coeffs.append(-seg_sum(pw) / j)
    return torch.stack(coeffs, dim=-1)


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
