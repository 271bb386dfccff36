"""RWKV-6 (Finch) token mixing and channel mixing, prefill and decode (the
counterpart of ``repro.models.ssm_rwkv``).

The per-token recurrence, with a data-dependent decay w_t in (0, 1):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t ,
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

`wkv_naive` takes it token by token (decode, and prefill when S is not a
multiple of 64); `wkv_chunked` takes 64-token chunks in turn, each as
products with cumulative-decay rescaling (prefill at S % 64 == 0).  The
two agree to float32 rounding, not bit for bit, so the choice between them
is the reference's rule (`rwkv_mix`).  Both run in float32 and are plain
PyTorch, under autograd too: the reference computes them with XLA ops, no
Pallas kernel.  `wkv_chunked` clamps w and A_j where the reference takes
``jnp.maximum``; the two differ in gradient only at an exact tie with the
floor (1e-12, 1e-30), which decays in (0, 1) do not reach.

A layer's state is {"x_prev_mix": (B, D), "x_prev_ffn": (B, D) in the
model's dtype, "wkv": (B, H, hs, hs) float32}: the last normed input of
the token mix and of the channel mix, and the recurrence's S; prefill and
decode replace its entries in place (training starts each layer from a
zero state of its own, ``transformer.Layer``).  ``w0`` and ``u`` are float32 leaves
in a bf16 model, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init, rms_norm


def init_rwkv_mix(gen, cfg, dtype) -> dict:
    D = cfg.d_model
    hs = cfg.rwkv.head_size
    H = D // hs
    r = cfg.rwkv.decay_lora

    def half():
        return torch.full((D,), 0.5, dtype=dtype, device=gen.device)

    return {
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
        "mu_g": half(),
        "wr": dense_init(gen, (D, D), dtype),
        "wk": dense_init(gen, (D, D), dtype),
        "wv": dense_init(gen, (D, D), dtype),
        "wg": dense_init(gen, (D, D), dtype),
        "wo": dense_init(gen, (D, D), dtype),
        # data-dependent decay LoRA:  w = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full((D,), -5.0, dtype=torch.float32, device=gen.device),
        "wA": dense_init(gen, (D, r), dtype),
        "wB": dense_init(gen, (r, D), dtype, scale=0.01),
        "u": dense_init(gen, (H, hs), torch.float32, scale=0.3),
        "ln_x": torch.ones((D,), dtype=dtype, device=gen.device),
    }


def init_rwkv_ffn(gen, cfg, dtype) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((D,), 0.5, dtype=dtype, device=gen.device),
        "mu_r": torch.full((D,), 0.5, dtype=dtype, device=gen.device),
        "wk": dense_init(gen, (D, Fd), dtype),
        "wv": dense_init(gen, (Fd, D), dtype),
        "wr": dense_init(gen, (D, D), dtype),
    }


def init_rwkv_state(cfg, batch: int, dtype, device=None) -> dict:
    hs = cfg.rwkv.head_size
    H = cfg.d_model // hs
    return {"x_prev_mix": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                      device=device),
            "x_prev_ffn": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                      device=device),
            "wkv": torch.zeros((batch, H, hs, hs), dtype=torch.float32,
                               device=device)}


def _shift(x, x_prev):
    """Token shift: the previous token's row, x_prev for the first."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


def _proj_rkvwg(p, x, x_prev, cfg):
    xs = _shift(x, x_prev)

    def lerp(mu):
        return x + (xs - x) * mu

    r = lerp(p["mu_r"]) @ p["wr"]
    k = lerp(p["mu_k"]) @ p["wk"]
    v = lerp(p["mu_v"]) @ p["wv"]
    g = F.silu(lerp(p["mu_g"]) @ p["wg"])
    lw = lerp(p["mu_w"]).float()
    w = torch.exp(-torch.exp(p["w0"] + torch.tanh(lw @ p["wA"].float())
                             @ p["wB"].float()))
    return r, k, v, g, w          # w in (0, 1), float32


def wkv_naive(r, k, v, w, u, state):
    """Per-token recurrence.  r, k, v, w: (B, S, H, hs); u: (H, hs);
    state: (B, H, hs, hs) float32 -> (out (B, S, H, hs) in r's dtype,
    state)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    s = state
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]     # (B, H, hs, hs)
        o = (rf[:, t, :, None, :] @ (s + u[..., None] * kv))[:, :, 0]
        s = wf[:, t, :, :, None] * s + kv
        outs.append(o)
    return torch.stack(outs, dim=1).to(r.dtype), s


def wkv_chunked(r, k, v, w, u, state, chunk: int = 64):
    """The chunked parallel form.  Within a chunk of length C, with
    A_j = prod_{t<=j} w_t:

      o_j = (r_j A_{j-1}) S_0 + sum_{t<j} (r_j A_{j-1} / A_t . k_t) v_t
            + (r_j u . k_j) v_j
      S_C = diag(A_C) S_0 + sum_t diag(A_C / A_t) k_t^T v_t
    """
    B, S, H, hs = r.shape
    assert S % chunk == 0, (S, chunk)
    C = chunk
    n = S // C
    rf, kf, vf, wf = (t.float().transpose(1, 2).reshape(B, H, n, C, hs)
                      for t in (r, k, v, w))
    s = state
    outs = []
    for i in range(n):
        r_c, k_c, v_c, w_c = (t[:, :, i] for t in (rf, kf, vf, wf))
        logw = torch.log(torch.clamp(w_c, min=1e-12))
        la = torch.cumsum(logw, dim=-2)                # log A_j (inclusive)
        a_incl = torch.exp(la)
        a_excl = torch.exp(la - logw)                  # A_{j-1}
        r_dec = r_c * a_excl
        k_div = k_c * torch.exp(-la)                   # k_t / A_t
        att = torch.tril(r_dec @ k_div.transpose(-1, -2), diagonal=-1)
        intra = att @ v_c
        bonus = (r_c * u[None, :, None, :] * k_c).sum(dim=-1)
        intra = intra + bonus[..., None] * v_c
        inter = r_dec @ s
        a_tot = a_incl[..., -1:, :]                    # (B, H, 1, hs)
        k_scaled = k_c * (a_tot / torch.clamp(a_incl, min=1e-30))
        s = a_tot[:, :, 0, :, None] * s + k_scaled.transpose(-1, -2) @ v_c
        outs.append(intra + inter)
    out = torch.stack(outs, dim=2).reshape(B, H, S, hs)
    return out.transpose(1, 2).to(r.dtype), s


def rwkv_mix(p, x, state, cfg, chunked: bool = True):
    """Token mixing.  x: (B, S, D) (the normed input); `state` as above,
    its x_prev_mix and wkv replaced in place.  Returns out (B, S, D).
    The chunked form runs where the reference's does: chunked, S % 64 == 0
    and S > 1."""
    B, S, D = x.shape
    hs = cfg.rwkv.head_size
    H = D // hs
    r, k, v, g, w = _proj_rkvwg(p, x, state["x_prev_mix"], cfg)
    rh, kh, vh, wh = (t.reshape(B, S, H, hs) for t in (r, k, v, w))
    if chunked and S % 64 == 0 and S > 1:
        out, s = wkv_chunked(rh, kh, vh, wh, p["u"], state["wkv"])
    else:
        out, s = wkv_naive(rh, kh, vh, wh, p["u"], state["wkv"])
    out = rms_norm(out.reshape(B, S, D), p["ln_x"], cfg.norm_eps) * g
    state["x_prev_mix"] = x[:, -1, :]
    state["wkv"] = s
    return out @ p["wo"]


def rwkv_ffn(p, x, x_prev, cfg):
    """Channel mixing.  Returns (out, x_last)."""
    xs = _shift(x, x_prev)
    xk = x + (xs - x) * p["mu_k"]
    xr = x + (xs - x) * p["mu_r"]
    h = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (h @ p["wv"]), x[:, -1, :]
