"""Plain PyTorch versions of the port's CUDA kernels.

The counterparts of ``repro.kernels.ref``: each function here computes what
the CUDA kernel of the same name computes, with ordinary tensor ops.
``repro_torch.kernels.ops`` runs them for tensors on the CPU; the tests and
``chip_smoke.py`` hold the kernels against them on the card.
"""
from __future__ import annotations

import math

import torch


def rff_embed(x, omega, delta, q_true: int | None = None):
    """Random Fourier feature map (paper eq. 18).

    x: (m, d), omega: (d, q), delta: (q,) -> (m, q)
      phi(x) = sqrt(2/q_true) * cos(x @ omega + delta),  q_true defaults to q
    """
    q = omega.shape[1] if q_true is None else q_true
    return math.sqrt(2.0 / q) * torch.cos(x @ omega + delta[None, :])


def linreg_grad_masked(x, theta, y, mask):
    """Per-client row-masked gradients (batched-engine form of eq. 7/10).

    x: (n, l, q), theta: (q, c), y: (n, l, c), mask: (n, l) -> (n, q, c)
      g_b = x_b^T diag(mask_b) (x_b @ theta - y_b)
    Rows with mask 0 contribute zero (for finite x, y); fractional entries
    scale a row's gradient (the fused coded round's 1/u factor).
    """
    r = (x @ theta - y) * mask[:, :, None]
    return x.transpose(1, 2) @ r


def parity_encode_batched(g, w, x):
    """All-clients local parity encoding (paper eq. 19).

    g: (n, u, l) generators, w: (n, l) diagonal weights, x: (n, l, q)
    -> (n, u, q) with  parity_b = G_b diag(w_b) X_b
    """
    return (g * w[:, None, :]) @ x
