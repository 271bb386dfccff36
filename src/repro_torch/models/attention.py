"""GQA attention: training, prefill and one-token decode against a KV
cache (the counterparts of ``repro.models.attention``).

Layouts are the reference's: wq (D, H, hd), wk/wv (D, K, hd), wo
(H, hd, D); activations (B, S, H, hd); a cache is {"k": (B, slots, K, hd),
"v": (B, slots, K, hd), "pos": (slots,) int32, -1 for an empty slot},
rolling (slot = pos % slots) when a window is set.

Decode attention is the hand-written ``gqa_decode`` kernel
(``repro_torch.kernels.ops``); prefill attention is plain PyTorch, an
online softmax over 512-slot KV chunks, as the reference computes it
outside any Pallas kernel.  Both compute in float32 and cast back.
Training attention (`attn_train`) is the same `_flash` under autograd,
recomputed in the backward (``torch.utils.checkpoint``) as the reference
recomputes it under ``jax.checkpoint``: the reference's is XLA, not a
Pallas kernel, so there is no hand-written kernel on the training path.

Unlike the reference, which returns a new cache from each call, these
functions write the cache in place: at full width a copy of a layer's
cache every decode step (136 MB for qwen3-4b at 8 x 4160 slots) would move
more bytes than the attention itself.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, dense_init, rms_norm

NEG_INF = -1e30


def init_attn(gen, cfg, dtype) -> dict:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (D, H, hd), dtype),
        "wk": dense_init(gen, (D, K, hd), dtype),
        "wv": dense_init(gen, (D, K, hd), dtype),
        "wo": dense_init(gen, (H, hd, D), dtype),
    }
    if cfg.qk_norm:
        p["qn"] = torch.ones((hd,), dtype=dtype, device=gen.device)
        p["kn"] = torch.ones((hd,), dtype=dtype, device=gen.device)
    return p


def _heads(x, w):
    """x (B, S, D) @ w (D, N, hd) -> (B, S, N, hd)."""
    D, N, hd = w.shape
    return (x @ w.reshape(D, N * hd)).reshape(*x.shape[:-1], N, hd)


def _project_q(p, x, positions, cfg, freqs=None):
    q = _heads(x, p["wq"])
    if cfg.qk_norm:
        q = rms_norm(q, p["qn"], cfg.norm_eps)
    return apply_rope(q, positions, cfg.rope_theta, freqs)


def _project_kv(p, x, positions, cfg, freqs=None):
    k = _heads(x, p["wk"])
    v = _heads(x, p["wv"])
    if cfg.qk_norm:
        k = rms_norm(k, p["kn"], cfg.norm_eps)
    return apply_rope(k, positions, cfg.rope_theta, freqs), v


def _out(p, out):
    """out (B, S, H, hd_v) @ wo (H, hd_v, D) -> (B, S, D)."""
    H, hd_v, D = p["wo"].shape
    return out.reshape(*out.shape[:2], H * hd_v) @ p["wo"].reshape(
        H * hd_v, D)


def _flash(q, k, v, q_pos, k_pos, window: int, chunk: int = 512,
           causal: bool = True):
    """Online-softmax attention, plain PyTorch: prefill (S > 1), and the
    encoder's and the cross-attention's (``causal=False``, any S).

    q: (B, S, H, hd); k, v: (B, T, K, hd / hd_v); q_pos (S,), k_pos (T,)
    int global positions (-1 for an empty slot) -> (B, S, H, hd_v) in q's
    dtype.  The reference's recurrence over `chunk`-slot KV chunks, taken
    for `chunk`-row query tiles in turn; a KV chunk with no valid slot for
    any row of a tile is skipped, which changes no value (for a row that
    has a valid slot somewhere, such a chunk has weight exp(-1e30 - m) = 0;
    a causal row always has one, its own position).  Under autograd a
    skipped chunk changes no gradient either: its weights are exactly 0.
    The tile list read back to the host is a function of the positions
    alone, so a recompute in the backward skips the same chunks.  With
    ``causal=False`` a slot is valid wherever its position is >= 0 (and
    inside the window), and no chunk is skipped: a row without a valid
    slot averages v over every slot, as the reference's does.
    """
    B, S, H, hd = q.shape
    T, K, hd_v = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    # (B, K, S, G, hd) and (B, K, T, hd): one batched product per chunk pair
    qr = (q.float() * scale).reshape(B, S, K, G, hd).permute(0, 2, 1, 3, 4)
    kt = k.permute(0, 2, 1, 3)
    vt = v.permute(0, 2, 1, 3)
    valid = (k_pos[None, :] >= 0).expand(S, T)
    if causal:
        valid = valid & (k_pos[None, :] <= q_pos[:, None])
    if window > 0:
        valid = valid & (k_pos[None, :] > q_pos[:, None] - window)
    out = torch.empty((B, S, H, hd_v), dtype=q.dtype, device=q.device)
    n_q, n_k = -(-S // chunk), -(-T // chunk)
    if causal:
        # which (query tile, KV chunk) pairs hold any valid slot: one
        # host read
        tiles = torch.zeros((n_q * chunk, n_k * chunk), dtype=torch.bool,
                            device=q.device)
        tiles[:S, :T] = valid
        pairs = tiles.reshape(n_q, chunk, n_k, chunk).any(3).any(1).cpu()
    else:
        pairs = torch.ones((n_q, n_k), dtype=torch.bool)
    for i in range(n_q):
        s0, s1 = i * chunk, min(S, (i + 1) * chunk)
        q_i = qr[:, :, s0:s1].reshape(B, K, (s1 - s0) * G, hd)
        m = torch.full((B, K, s1 - s0, G), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, K, s1 - s0, G, hd_v), dtype=torch.float32,
                          device=q.device)
        for j in range(n_k):
            if not pairs[i, j]:
                continue
            t0, t1 = j * chunk, min(T, (j + 1) * chunk)
            s = (q_i @ kt[:, :, t0:t1].float().transpose(2, 3)).reshape(
                B, K, s1 - s0, G, t1 - t0)
            ok = valid[s0:s1, t0:t1][None, None, :, None, :]
            s = torch.where(ok, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = (p.reshape(B, K, (s1 - s0) * G, t1 - t0)
                  @ vt[:, :, t0:t1].float())
            acc = acc * corr[..., None] + pv.reshape(B, K, s1 - s0, G, hd_v)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]      # (B, K, s, G, hd_v)
        out[:, s0:s1] = o.permute(0, 2, 1, 3, 4).reshape(
            B, s1 - s0, H, hd_v).to(q.dtype)
    return out


def _attend_single(q, k, v, q_pos: int, k_pos, window: int):
    """One-token attention (decode): q (B, 1, H, hd) against the cache, the
    ``gqa_decode`` kernel on the card -> (B, 1, H, hd_v)."""
    return ops.gqa_decode(q[:, 0], k, v, k_pos, q_pos, window)[:, None]


def attn_train(p, x, positions, cfg, window: int = 0, freqs=None):
    """Full-sequence causal attention.  x: (B, S, D), positions: (S,) int.

    The attention itself is recomputed in the backward instead of saving
    the per-chunk online-softmax state (the reference's flash backward)."""
    q = _project_q(p, x, positions[None, :], cfg, freqs)
    k, v = _project_kv(p, x, positions[None, :], cfg, freqs)
    win = window if window else cfg.swa_window
    out = checkpoint(_flash, q, k, v, positions, positions, win,
                     use_reentrant=False)
    return _out(p, out)


def init_cache(cfg, batch: int, max_seq: int, dtype, window: int = 0,
               device=None) -> dict:
    """KV cache; rolling when window > 0 (sub-quadratic decode)."""
    slots = min(max_seq, window) if window > 0 else max_seq
    K, hd = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, slots, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, K, hd), dtype=dtype, device=device),
        "pos": torch.full((slots,), -1, dtype=torch.int32, device=device),
    }


def attn_prefill(p, x, positions, cfg, cache, window: int = 0, freqs=None):
    """Full forward over the prompt; fills the cache in place.
    x: (B, S, D), positions: (S,) int; `freqs`: the rope frequencies on
    x's device, if the caller holds them.  Returns (out, cache)."""
    q = _project_q(p, x, positions[None, :], cfg, freqs)
    k, v = _project_kv(p, x, positions[None, :], cfg, freqs)
    win = window if window else cfg.swa_window
    out = _flash(q, k, v, positions, positions, win)
    S = x.shape[1]
    slots = cache["k"].shape[1]
    if slots >= S:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["pos"][:S] = positions
    else:                                     # rolling window: keep the tail
        cache["k"].copy_(k[:, S - slots:])
        cache["v"].copy_(v[:, S - slots:])
        cache["pos"].copy_(positions[S - slots:])
    return _out(p, out), cache


def attn_decode(p, x, pos: int, cfg, cache, window: int = 0, freqs=None):
    """One-token step.  x: (B, 1, D); pos: int position.  Writes the new
    token's K, V and position into its slot in place; returns (out, cache)."""
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = _project_q(p, x, positions, cfg, freqs)
    k, v = _project_kv(p, x, positions, cfg, freqs)
    slots = cache["k"].shape[1]
    win = window if window else cfg.swa_window
    slot = pos % slots if win > 0 else min(pos, slots - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["pos"][slot] = pos
    out = _attend_single(q, cache["k"], cache["v"], pos, cache["pos"], win)
    return _out(p, out), cache
