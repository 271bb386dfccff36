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


def linreg_grad(x, theta, y):
    """Unnormalized squared-loss gradient (paper eq. 7/10).

    x: (m, q), theta: (q, c), y: (m, c) -> (q, c)
      g = x^T (x @ theta - y)
    """
    return x.T @ (x @ theta - y)


def linreg_grad_batched(x, theta, y):
    """Per-client gradients without a mask.

    x: (n, l, q), theta: (q, c), y: (n, l, c) -> (n, q, c)
      g_b = x_b^T (x_b @ theta - y_b)
    """
    return x.transpose(1, 2) @ (x @ theta - y)


def linreg_grad_masked(x, theta, y, mask, live_rows=None):
    """Per-client row-masked gradients (batched-engine form of eq. 7/10).

    x: (n, l, q), theta: (q, c), y: (n, l, c), mask: (n, l) -> (n, q, c)
      g_b = x_b^T diag(mask_b) (x_b @ theta - y_b)
    Rows with mask 0 contribute zero (for finite x, y); fractional entries
    scale a row's gradient (the fused coded round's 1/u factor).
    ``live_rows`` = (clients, last_row) slices rows b < n - 1 to their first
    ``clients`` rows and row n - 1 to its first ``last_row`` rows; where the
    rows past them hold x = 0, y = 0 and mask = 0 the result is the same as
    without it (``ops.linreg_grad_masked`` says why).
    """
    if live_rows is not None:
        n = x.shape[0]
        lc, ll = live_rows
        g_last = linreg_grad_masked(x[n - 1:, :ll], theta, y[n - 1:, :ll],
                                    mask[n - 1:, :ll])
        if n == 1:
            return g_last
        return torch.cat([linreg_grad_masked(x[:n - 1, :lc], theta,
                                             y[:n - 1, :lc],
                                             mask[:n - 1, :lc]), g_last])
    r = (x @ theta - y) * mask[:, :, None]
    return x.transpose(1, 2) @ r


def parity_encode(g, w, x):
    """Local parity encoding of one client (paper eq. 19).

    g: (u, l) generator, w: (l,) diagonal weights, x: (l, q) -> (u, q)
      parity = G diag(w) X
    """
    return (g * w[None, :]) @ x


def parity_encode_batched(g, w, x):
    """All-clients local parity encoding (paper eq. 19).

    g: (n, u, l) generators, w: (n, l) diagonal weights, x: (n, l, q)
    -> (n, u, q) with  parity_b = G_b diag(w_b) X_b
    """
    return (g * w[:, None, :]) @ x


def rff_linreg_grad_masked(x, omega, delta, theta, y, mask, pphi=None, *,
                           n_real: int, q_true: int | None = None,
                           live_rows=None):
    """Fused RFF embedding -> per-row-masked gradients (eq. 18 + 7/10).

    x: (>= n_real, L, d) raw features (rows past n_real are not read),
    omega: (d, q), delta: (q,), theta: (q, c), y: (rows, L, c), mask:
    (rows, L), pphi: (L, q) or None -> (rows, q, c) float32 with
      phi_b = sqrt(2/q_true) cos(x_b @ omega + delta)   for b <  n_real,
      phi_b = pphi                                      for b >= n_real,
      g_b   = phi_b^T diag(mask_b) (phi_b @ theta - y_b).
    ``live_rows`` = (raw, parity) slices each raw client to its first
    ``raw`` rows and the parity rows to their first ``parity`` rows; where
    the rows past them hold x = 0, y = 0 and mask = 0 the result is the
    same as without it (``ops.rff_linreg_grad_masked`` says why).
    Every input is upcast to float32 first (bf16 inputs too), as the
    reference's fallback does.
    """
    f32 = torch.float32
    _, L, d = x.shape
    q = omega.shape[1]
    lr, lp = (L, L) if live_rows is None else live_rows
    extra = y.shape[0] - n_real
    if extra and pphi is None:
        raise ValueError(f"{y.shape[0]} rows of labels for {n_real} raw "
                         "clients need the parity block pphi")
    theta = theta.to(f32)
    phi = rff_embed(x[:n_real, :lr].to(f32).reshape(n_real * lr, d),
                    omega.to(f32), delta.to(f32),
                    q_true).reshape(n_real, lr, q)
    g = linreg_grad_masked(phi, theta, y[:n_real, :lr].to(f32),
                           mask[:n_real, :lr].to(f32))
    if extra:
        phi = pphi[:lp].to(f32).expand(extra, lp, q)
        g = torch.cat([g, linreg_grad_masked(phi, theta,
                                             y[n_real:, :lp].to(f32),
                                             mask[n_real:, :lp].to(f32))])
    return g


def gqa_decode(q, k, v, k_pos, q_pos, window: int = 0):
    """One-token GQA decode attention over a KV cache.

    q: (B, H, hd); k: (B, T, K, hd); v: (B, T, K, hd_v); k_pos: (T,) int
    slot positions (-1 for an empty slot); q_pos: int -> (B, H, hd_v) in
    q's dtype.  A slot is valid where k_pos >= 0, k_pos <= q_pos and, with
    a window, k_pos > q_pos - window; the others score -1e30 (not -inf),
    so a query with no valid slot at all averages v over every slot, as the
    reference does.  Computed in float32.
    """
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, K, G, hd).float() / math.sqrt(hd)
    s = torch.einsum("bkgd,btkd->bkgt", qr, k.float())
    valid = (k_pos >= 0) & (k_pos <= q_pos)
    if window > 0:
        valid = valid & (k_pos > q_pos - window)
    s = torch.where(valid[None, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    return out.reshape(B, H, v.shape[-1]).to(q.dtype)
