"""Coded federated aggregation (paper §III-E), main path of the port.

Per round r+1:
  - client j (if it returns by t*) contributes the unnormalized partial
    gradient over its l*_j processed points:  X~_j^T (X~_j theta - Y~_j)
  - the MEC compute unit contributes the coded gradient over the global
    parity set, weighted by 1/(1 - pnr_C):
        g_C = 1/(1-pnr_C) * Xv^T (Xv theta - Yv)           (eq. 28)
  - the server aggregates  g_M = (g_C + g_U) / m            (eq. 30)

On the fused path both come from one ``linreg_grad_masked`` launch over
the dense (n+1, L, q) client+parity tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def batched_client_gradients(x_stack, y_stack, theta, *, mask):
    """All-client unnormalized masked gradients in one kernel launch.

    x_stack: (n, l, q), y_stack: (n, l, c), theta: (q, c), mask: (n, l)
    per-row weights -> (n, q, c).
    """
    return ops.linreg_grad_masked(x_stack, theta, y_stack, mask)


def masked_gradient_sum(client_grads, returned_mask):
    """sum_j 1{T_j<=t*} g_j over a dense (n, q, c) gradient stack."""
    mask = returned_mask.to(client_grads.dtype)[:, None, None]
    return (client_grads * mask).sum(dim=0)


def fused_client_parity_tensors(sub_x, sub_y, mask, parity_x, parity_y, *,
                                pnr_c: float = 0.0,
                                l_target: int | None = None):
    """Append the global parity set as an (n+1)-th pseudo-client row.

    sub_x: (n, l_max, q), sub_y: (n, l_max, c), mask: (n, l_max) validity;
    parity_x: (u, q), parity_y: (u, c).  Returns (fx, fy, fmask) of shapes
    ((n+1, L, q), (n+1, L, c), (n+1, L)) with L = max(l_max, u, l_target).

    The coded-gradient scale 1/(u (1-pnr_C)) (eq. 28, incl. the G^T G / u
    concentration of eq. 31) is folded into the parity row's float32 mask
    entries, so the masked-gradient kernel yields the coded gradient on
    that row from the same launch as the n client gradients.  Zero-mask
    padding contributes nothing.
    """
    n, l_max, q = sub_x.shape
    c = sub_y.shape[-1]
    u = parity_x.shape[0]
    L = max(l_max, u, l_target or 1)
    dev = sub_x.device
    fx = torch.zeros((n + 1, L, q), dtype=sub_x.dtype, device=dev)
    fy = torch.zeros((n + 1, L, c), dtype=sub_y.dtype, device=dev)
    # the mask must be floating so the fractional parity scale survives
    fmask = torch.zeros((n + 1, L), dtype=sub_x.dtype, device=dev)
    fx[:n, :l_max] = sub_x
    fx[n, :u] = parity_x
    fy[:n, :l_max] = sub_y
    fy[n, :u] = parity_y
    fmask[:n, :l_max] = mask.to(sub_x.dtype)
    fmask[n, :u] = 1.0 / (u * (1.0 - pnr_c))
    return fx, fy, fmask
