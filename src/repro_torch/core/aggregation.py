"""Coded federated aggregation (paper §III-E), main path of the port.

Per round r+1:
  - client j (if it returns by t*) contributes the unnormalized partial
    gradient over its l*_j processed points:  X~_j^T (X~_j theta - Y~_j)
  - the MEC compute unit contributes the coded gradient over the global
    parity set, weighted by 1/(1 - pnr_C):
        g_C = 1/(1-pnr_C) * Xv^T (Xv theta - Yv)           (eq. 28)
  - the server aggregates  g_M = (g_C + g_U) / m            (eq. 30)

On the fused path both come from one ``linreg_grad_masked`` launch over
the dense (n+1, L, q) client+parity tensor; with ``fused_embed`` from one
``rff_linreg_grad_masked`` launch over the raw (n, L, d) client tensor.
Unfused (``fused_coded=False``) and in the legacy oracle the coded gradient
is a separate ``linreg_grad`` launch over the (u, q) parity set.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def batched_client_gradients(x_stack, y_stack, theta, *, mask=None,
                             live_rows=None):
    """All-client unnormalized gradients in one kernel launch.

    x_stack: (n, l, q), y_stack: (n, l, c), theta: (q, c) -> (n, q, c).
    With the (n, l) per-row weights `mask` through ``linreg_grad_masked``;
    without, every row weighs 1 (``linreg_grad_batched``).  `live_rows` =
    (l_max, u) of `fused_client_parity_tensors` (masked only): the zero
    padding past them is not read.
    """
    if mask is not None:
        return ops.linreg_grad_masked(x_stack, theta, y_stack, mask,
                                      live_rows=live_rows)
    if live_rows is not None:
        raise ValueError("live_rows needs a mask: the zero padding past "
                         "them is written with mask 0")
    return ops.linreg_grad_batched(x_stack, theta, y_stack)


def masked_gradient_sum(client_grads, returned_mask):
    """sum_j 1{T_j<=t*} g_j over a dense (n, q, c) gradient stack;
    `returned_mask` (n,) is a tensor or a NumPy bool/float array."""
    mask = torch.as_tensor(returned_mask, device=client_grads.device)
    return (client_grads * mask.to(client_grads.dtype)[:, None, None]).sum(
        dim=0)


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
    padding contributes nothing.  Past l_max client rows and past u parity
    rows x, y and mask are zero: the fused round passes live_rows =
    (l_max, u) and the kernel skips them.
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


def fused_embed_client_gradients(x_raw, y_stack, omega, delta, theta, *,
                                 mask, parity_phi=None, live_rows=None):
    """All-client gradients straight from RAW features in one launch.

    x_raw: (n, l, d), y_stack: (rows, l, c), mask: (rows, l) -> (rows, q,
    c): phi(X) = sqrt(2/q) cos(X Omega + delta) is computed inside the
    gradient kernel, so the (n, l, q) embedded tensor is never made.  With
    `parity_phi` (l, q) the parity pseudo-client (already in q-space) is row
    n; its mask entries carry the coded 1/(u (1-pnr_C)) scale.
    `live_rows` = (l_max, u) of `fused_embed_client_parity_tensors`: the
    zero padding past them is not embedded.
    """
    return ops.rff_linreg_grad_masked(x_raw, omega, delta, theta, y_stack,
                                      mask, parity_phi=parity_phi,
                                      live_rows=live_rows)


def fused_embed_client_parity_tensors(sub_x_raw, sub_y, mask, parity_x,
                                      parity_y, *, pnr_c: float = 0.0,
                                      l_target: int | None = None):
    """Raw-space analogue of `fused_client_parity_tensors`.

    sub_x_raw: (n, l_max, d) RAW features, sub_y: (n, l_max, c), mask:
    (n, l_max); parity_x: (u, q) EMBEDDED parity rows, parity_y: (u, c).
    Returns (fx, fy, fmask, pphi): fx (n, L, d) raw client rows only (the
    fused kernel reads the parity row from pphi), fy/fmask (n+1, L, .) with
    the parity labels and its 1/(u (1-pnr_C))-scaled mask row, and pphi
    (L, q) the parity block.  L = max(l_max, u, l_target).  Past l_max
    client rows and past u parity rows x, y, mask and pphi are zero: the
    fused round passes live_rows = (l_max, u) and skips them.
    """
    n, l_max, d = sub_x_raw.shape
    c = sub_y.shape[-1]
    u, q = parity_x.shape
    L = max(l_max, u, l_target or 1)
    dev = sub_x_raw.device
    fx = torch.zeros((n, L, d), dtype=sub_x_raw.dtype, device=dev)
    fy = torch.zeros((n + 1, L, c), dtype=sub_y.dtype, device=dev)
    fmask = torch.zeros((n + 1, L), dtype=fy.dtype, device=dev)
    pphi = torch.zeros((L, q), dtype=parity_x.dtype, device=dev)
    fx[:, :l_max] = sub_x_raw
    fy[:n, :l_max] = sub_y
    fy[n, :u] = parity_y
    fmask[:n, :l_max] = mask.to(fy.dtype)
    fmask[n, :u] = 1.0 / (u * (1.0 - pnr_c))
    pphi[:u] = parity_x
    return fx, fy, fmask, pphi


def client_gradient(x, y, theta):
    """Unnormalized partial gradient X^T (X theta - Y) over processed
    points: one ``linreg_grad`` launch."""
    return ops.linreg_grad(x, theta, y)


def coded_gradient(parity_x, parity_y, theta, pnr_c: float = 0.0):
    """g_C over the global parity set (eq. 28):

        g_C = 1/(1-pnr_C) * (1/u) * Xv^T (Xv theta - Yv)

    one ``linreg_grad`` launch; the 1/u factor is the G^T G / u -> I
    concentration of eq. 31.
    """
    u = parity_x.shape[0]
    g = ops.linreg_grad(parity_x, theta, parity_y)
    return g / (u * (1.0 - pnr_c))


def federated_gradient(coded_g, client_grads, returned_mask, m: int,
                       l2_reg: float = 0.0, theta=None):
    """g_M = (g_C + sum_j 1{T_j<=t*} g_j) / m  (+ optional L2 term).

    coded_g: (q, c) or None; client_grads: list of (q, c) unnormalized
    client gradients; returned_mask: bool per client.
    """
    total = torch.zeros_like(client_grads[0] if client_grads else coded_g)
    for g, ret in zip(client_grads, returned_mask):
        total = total + (g if bool(ret) else torch.zeros_like(g))
    if coded_g is not None:
        total = total + coded_g
    g_m = total / m
    if l2_reg and theta is not None:
        g_m = g_m + l2_reg * theta
    return g_m
