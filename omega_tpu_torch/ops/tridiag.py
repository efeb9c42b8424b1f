"""Batched tridiagonal solvers for implicit vertical mixing.

Counterpart of base/TriDiagSolvers.h: the reference picks Thomas
(sequential) or PCR (parallel cyclic reduction) at compile time
(TriDiagSolvers.h:28-35). Here both are whole-array algorithms over
(..., K) batches:

  * `thomas`   — a loop along K (two sweeps); minimal flops, serial in K
  * `pcr`      — ceil(log2 K) elementwise sweeps, no K-serial dependency;
                 the arithmetic the column kernel (csrc/vmix.cu) repeats
                 level for level

plus the diffusion-specialized form of the reference
(ThomasDiffusionSolver / PCRDiffusionSolver, TriDiagSolvers.h:262,363):
systems  (H_k + G_k + G_{k-1}) x_k - G_{k-1} x_{k-1} - G_k x_{k+1} = b_k
parameterized by coupling G >= 0 and diagonal mass H > 0, which arise from
implicit vertical diffusion and are solved without cancellation.

All solvers treat the K axis as the LAST axis and batch over any leading
axes.
"""

from __future__ import annotations

import math

import torch


def thomas(dl, d, du, b):
    """Thomas algorithm, batched over leading axes; K is the last axis.

    dl[..., 0] and du[..., K-1] are ignored. Returns x with d*x = b in the
    tridiagonal sense. (ThomasSolver::solve, TriDiagSolvers.h:79-104.)
    """
    dl, d, du, b = torch.broadcast_tensors(dl, d, du, b)
    K = d.shape[-1]
    d_mod, b_mod = [d[..., 0]], [b[..., 0]]
    for k in range(1, K):
        w = dl[..., k] / d_mod[-1]
        d_mod.append(d[..., k] - w * du[..., k - 1])
        b_mod.append(b[..., k] - w * b_mod[-1])
    xs = [b_mod[-1] / d_mod[-1]]
    for k in range(K - 2, -1, -1):
        xs.append((b_mod[k] - du[..., k] * xs[-1]) / d_mod[k])
    return torch.stack(xs[::-1], dim=-1)


def _shift(x, offset, fill):
    """x[..., k + offset] with out-of-range entries replaced by fill."""
    K = x.shape[-1]
    if offset == 0:
        return x
    n = min(abs(offset), K)
    pad = torch.full(x.shape[:-1] + (n,), fill, dtype=x.dtype,
                     device=x.device)
    if offset > 0:
        return torch.cat([x[..., offset:], pad], dim=-1)
    return torch.cat([pad, x[..., :K - n]], dim=-1)


def pcr(dl, d, du, b):
    """Parallel cyclic reduction: log2(K) whole-array sweeps.

    Out-of-range neighbor rows act as identity equations (a=c=0, b=1, d=0),
    so no power-of-two padding is needed. (PCRSolver, TriDiagSolvers.h:138.)
    """
    a, bb, c, x = torch.broadcast_tensors(dl, d, du, b)
    K = x.shape[-1]
    # normalize ignored corners so out-of-range refs are true identities
    a, c = a.clone(), c.clone()
    a[..., 0] = 0.0
    c[..., K - 1] = 0.0
    levels = math.ceil(math.log2(K)) if K > 1 else 0
    s = 1
    for _ in range(levels):
        alpha = -a / _shift(bb, -s, 1.0)
        beta = -c / _shift(bb, +s, 1.0)
        a_new = alpha * _shift(a, -s, 0.0)
        c_new = beta * _shift(c, +s, 0.0)
        b_new = bb + alpha * _shift(c, -s, 0.0) + beta * _shift(a, +s, 0.0)
        x_new = x + alpha * _shift(x, -s, 0.0) + beta * _shift(x, +s, 0.0)
        a, bb, c, x = a_new, b_new, c_new, x_new
        s *= 2
    return x / bb


def implicit_diffusion_matrix(g, h):
    """Map the diffusion form (G, H) to (dl, d, du):
    row k: -G_{k-1} x_{k-1} + (H_k + G_k + G_{k-1}) x_k - G_k x_{k+1}."""
    g_km1 = _shift(g, -1, 0.0)
    dl = -g_km1
    d = h + g + g_km1
    du = -g
    return dl, d, du


def diffusion_solve(g, h, b, method: str = "pcr"):
    """Solve the diffusion-form system (ThomasDiffusionSolver /
    PCRDiffusionSolver). g[..., K-1] must be 0 (no flux through bottom)."""
    dl, d, du = implicit_diffusion_matrix(g, h)
    if method == "thomas":
        return thomas(dl, d, du, b)
    return pcr(dl, d, du, b)
