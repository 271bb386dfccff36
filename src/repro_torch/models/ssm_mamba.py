"""Mamba-1 selective SSM block, jamba's recurrent mixer, prefill and
decode (the counterpart of ``repro.models.ssm_mamba``).

    h_t = exp(dt_t A) * h_{t-1} + (dt_t u_t) outer B_t ,   y_t = h_t . C_t

`_ssm_scan` takes it token by token (decode always, prefill when S is not
a multiple of 128); `_ssm_chunked` takes 128-token chunks in turn, each
as cumulative sums of log decays (prefill at S % 128 == 0).  They agree
to float32 rounding; the choice between them is the reference's rule
(`mamba_block`).  Plain PyTorch in float32, as the reference's XLA ops.
Under autograd each chunk of `_ssm_chunked` is recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of its
chunk body), so a layer keeps the chunks' inputs, not their
(B, C, d_inner, N) blocks.  The chunked form keeps the reference's
overflow: exp(-cum) passes float32's range where the cumulative log decay
of a chunk passes about -88 (jamba at full width, ROADMAP F4), in
training as in prefill.

A layer's state is {"conv": (B, K - 1, d_inner) in the model's dtype, the
causal convolution's last K - 1 inputs, "h": (B, d_inner, N) float32},
replaced in place.  ``dt_proj_b``, ``A_log`` and ``D`` are float32 leaves
in a bf16 model, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import dense_init


def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def init_mamba(gen, cfg, dtype) -> dict:
    D = cfg.d_model
    s = cfg.ssm
    din = s.expand * D
    N = s.d_state
    R = _dt_rank(cfg)
    f32 = dict(dtype=torch.float32, device=gen.device)
    A = torch.arange(1, N + 1, **f32)[None, :].repeat(din, 1)
    return {
        "in_proj": dense_init(gen, (D, 2 * din), dtype),
        "conv_w": dense_init(gen, (s.d_conv, din), dtype, scale=0.5),
        "conv_b": torch.zeros((din,), dtype=dtype, device=gen.device),
        "x_proj": dense_init(gen, (din, R + 2 * N), dtype),
        "dt_proj_w": dense_init(gen, (R, din), dtype),
        "dt_proj_b": torch.full((din,), -4.6, **f32),   # softplus^-1(0.01)
        "A_log": torch.log(A),
        "D": torch.ones((din,), **f32),
        "out_proj": dense_init(gen, (din, D), dtype),
    }


def init_mamba_state(cfg, batch: int, dtype, device=None) -> dict:
    din = cfg.ssm.expand * cfg.d_model
    return {"conv": torch.zeros((batch, cfg.ssm.d_conv - 1, din),
                                dtype=dtype, device=device),
            "h": torch.zeros((batch, din, cfg.ssm.d_state),
                             dtype=torch.float32, device=device)}


def _conv_causal(x, w, b, conv_state):
    """Depthwise causal convolution.  x: (B, S, din), w: (K, din),
    conv_state: (B, K - 1, din), the inputs before x.  Returns
    (silu(y + b), the last K - 1 inputs)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = torch.cat([conv_state, x], dim=1)                 # (B, S+K-1, din)
    y = xp[:, 0:S, :] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S, :] * w[i]
    return F.silu(y + b), xp[:, -(K - 1):, :]


def _ssm_scan(u, dt, B_t, C_t, A, D, h0):
    """Sequential scan.  u, dt: (B, S, din); B_t, C_t: (B, S, N);
    A: (din, N); D: (din,); h0: (B, din, N).  Returns (y (B, S, din),
    h (B, din, N))."""
    decay = torch.exp(dt[..., None] * A)                   # (B, S, din, N)
    inp = (dt * u)[..., None] * B_t[:, :, None, :]
    h = h0
    ys = []
    for t in range(u.shape[1]):
        h = decay[:, t] * h + inp[:, t]
        ys.append((h @ C_t[:, t, :, None])[..., 0])
    return torch.stack(ys, dim=1) + u * D, h


def _ssm_chunk(h, u_c, dt_c, b_c, c_c, A):
    """One chunk of `_ssm_chunked`: (h at its last token, y (B, C, din))."""
    la = dt_c[..., None] * A                               # (B, C, din, N)
    i_c = (dt_c * u_c)[..., None] * b_c[:, :, None, :]
    cum = torch.cumsum(la, dim=1)
    acc = torch.cumsum(i_c * torch.exp(-cum), dim=1)
    h_all = torch.exp(cum) * (h[:, None] + acc)
    return h_all[:, -1], (h_all @ c_c[..., None])[..., 0]


def _ssm_chunked(u, dt, B_t, C_t, A, D, h0, chunk: int = 128):
    """The chunk-blocked scan: chunks in turn, each as

      h_j = exp(cum_j) (h_0 + sum_{t<=j} exp(-cum_t) i_t),
      cum_j = sum_{t<=j} dt_t A,

    its (C, din, N) blocks built inside the chunk from the (C, din) and
    (C, N) projections; under autograd each chunk is recomputed in the
    backward."""
    B, S, din = u.shape
    assert S % chunk == 0
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (u, dt, B_t, C_t, A, h0))
    h = h0
    ys = []
    for c0 in range(0, S, chunk):
        args = (h, u[:, c0:c0 + chunk], dt[:, c0:c0 + chunk],
                B_t[:, c0:c0 + chunk], C_t[:, c0:c0 + chunk], A)
        if remat:
            h, y = checkpoint(_ssm_chunk, *args, use_reentrant=False)
        else:
            h, y = _ssm_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1) + u * D, h


def mamba_block(p, x, state, cfg, chunked: bool = False):
    """x: (B, S, D) (the normed input); `state` as above, replaced in
    place.  Returns out (B, S, D).  The chunked form runs where the
    reference's does: chunked, S % 128 == 0 and S > 1."""
    s = cfg.ssm
    N = s.d_state
    R = _dt_rank(cfg)
    xz = x @ p["in_proj"]
    u, z = xz.chunk(2, dim=-1)                             # (B, S, din)
    u, conv_state = _conv_causal(u, p["conv_w"], p["conv_b"], state["conv"])
    proj = u @ p["x_proj"]
    dt_r, B_t, C_t = proj.split([R, N, N], dim=-1)
    dt = F.softplus(dt_r.float() @ p["dt_proj_w"].float() + p["dt_proj_b"])
    A = -torch.exp(p["A_log"])                             # (din, N), < 0
    uf = u.float()
    Bf, Cf = B_t.float(), C_t.float()
    if chunked and x.shape[1] % 128 == 0 and x.shape[1] > 1:
        y, h = _ssm_chunked(uf, dt, Bf, Cf, A, p["D"], state["h"])
    else:
        y, h = _ssm_scan(uf, dt, Bf, Cf, A, p["D"], state["h"])
    state["conv"] = conv_state
    state["h"] = h
    return (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
