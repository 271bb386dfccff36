"""DeepSeek-V2 Multi-head Latent Attention, training, prefill and decode
(the counterpart of ``repro.models.mla``).

The cache holds the compressed latent c (B, slots, kv_lora_rank), the
shared rope key kpe (B, slots, qk_rope_head_dim) and the slot positions
pos (slots,) int32 (-1 empty), written in place.  Decode follows the
reference's baseline path: it decompresses every head's K (nope and rope
parts, hd = qk_nope + qk_rope) and V (hd_v = v_head_dim) from the whole
latent cache each step, then attends with the ``gqa_decode`` kernel, one
KV head a query head (G = 1, hd != hd_v).  Prefill attention is the
plain-PyTorch ``attention._flash``, as the reference computes it outside
any Pallas kernel; so is training attention (`mla_train`), over K/V
decompressed from the latent with as many KV heads as query heads,
recomputed in the backward as ``attention.attn_train``'s.

Layouts are the reference's: wq (D, H, qk), w_dkv (D, lora + rope),
kv_norm (lora,), w_uk (lora, H, nope), w_uv (lora, H, v), wo (H, v, D).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.attention import _flash, _heads, _out, _pair
from repro_torch.models.common import apply_rope, dense_init, rms_norm


def init_mla(gen, cfg, dtype) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": dense_init(gen, (D, H, qk), dtype),
        "w_dkv": dense_init(gen, (D, m.kv_lora_rank + m.qk_rope_head_dim),
                            dtype),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype,
                              device=gen.device),
        "w_uk": dense_init(gen, (m.kv_lora_rank, H, m.qk_nope_head_dim),
                           dtype),
        "w_uv": dense_init(gen, (m.kv_lora_rank, H, m.v_head_dim), dtype),
        "wo": dense_init(gen, (H, m.v_head_dim, D), dtype),
    }


def _q_proj(p, x, positions, cfg, freqs=None):
    nope = cfg.mla.qk_nope_head_dim
    q = _heads(x, p["wq"])
    q_pe = apply_rope(q[..., nope:], positions, cfg.rope_theta, freqs)
    return torch.cat([q[..., :nope], q_pe], dim=-1)


def _latent(p, x, positions, cfg, freqs=None):
    """x (B, S, D) -> (c (B, S, lora) normed, k_pe (B, S, rope) roped)."""
    lora = cfg.mla.kv_lora_rank
    ckv = x @ p["w_dkv"]
    c = rms_norm(ckv[..., :lora], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(ckv[..., lora:], positions, cfg.rope_theta, freqs)
    return c, k_pe


def _decompress(p, c, k_pe, cfg):
    """latent -> per-head K (B, T, H, nope + rope) and V (B, T, H, v)."""
    k_nope = _heads(c, p["w_uk"])
    v = _heads(c, p["w_uv"])
    k_pe_b = k_pe[:, :, None, :].expand(*k_nope.shape[:3], k_pe.shape[-1])
    return torch.cat([k_nope, k_pe_b], dim=-1), v


def mla_train(p, x, positions, cfg, window: int = 0, freqs=None,
              host_pos=None):
    """Full-sequence causal MLA.  x: (B, S, D), positions: (S,) int
    (`host_pos` as a NumPy array, if the caller has them).  Returns out
    (B, S, D)."""
    q = _q_proj(p, x, positions[None, :], cfg, freqs)
    c, k_pe = _latent(p, x, positions[None, :], cfg, freqs)
    k, v = _decompress(p, c, k_pe, cfg)
    win = window if window else cfg.swa_window
    out = checkpoint(_flash, q, k, v, positions, positions, win,
                     host_pos=_pair(host_pos),
                     use_reentrant=False)                  # kv heads == H
    return _out(p, out)


def init_mla_cache(cfg, batch: int, max_seq: int, dtype, window: int = 0,
                   device=None) -> dict:
    m = cfg.mla
    slots = min(max_seq, window) if window > 0 else max_seq
    return {"c": torch.zeros((batch, slots, m.kv_lora_rank), dtype=dtype,
                             device=device),
            "kpe": torch.zeros((batch, slots, m.qk_rope_head_dim),
                               dtype=dtype, device=device),
            "pos": torch.full((slots,), -1, dtype=torch.int32,
                              device=device)}


def mla_prefill(p, x, positions, cfg, cache, window: int = 0, freqs=None,
                host_pos=None):
    """Full forward over the prompt; fills the latent cache in place
    (`host_pos`: the positions as a NumPy array, if the caller has them).
    Returns (out (B, S, D), cache)."""
    q = _q_proj(p, x, positions[None, :], cfg, freqs)
    c, k_pe = _latent(p, x, positions[None, :], cfg, freqs)
    k, v = _decompress(p, c, k_pe, cfg)
    win = window if window else cfg.swa_window
    out = _flash(q, k, v, positions, positions, win,
                 host_pos=_pair(host_pos))
    S = x.shape[1]
    slots = cache["c"].shape[1]
    if slots >= S:
        cache["c"][:, :S] = c
        cache["kpe"][:, :S] = k_pe
        cache["pos"][:S] = positions
    else:                                     # rolling window: keep the tail
        cache["c"].copy_(c[:, S - slots:])
        cache["kpe"].copy_(k_pe[:, S - slots:])
        cache["pos"].copy_(positions[S - slots:])
    return _out(p, out), cache


def mla_decode(p, x, pos: int, cfg, cache, window: int = 0, freqs=None):
    """One-token step.  x: (B, 1, D); pos: int.  Writes the token's latent
    into its slot in place, decompresses K/V from the whole cache and runs
    ``gqa_decode`` on them; returns (out (B, 1, D), cache)."""
    positions = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = _q_proj(p, x, positions, cfg, freqs)
    c, k_pe = _latent(p, x, positions, cfg, freqs)
    slots = cache["c"].shape[1]
    win = window if window else cfg.swa_window
    slot = pos % slots if win > 0 else min(pos, slots - 1)
    cache["c"][:, slot] = c[:, 0]
    cache["kpe"][:, slot] = k_pe[:, 0]
    cache["pos"][slot] = pos
    k, v = _decompress(p, cache["c"], cache["kpe"], cfg)     # baseline path
    out = ops.gqa_decode(q[:, 0], k, v, cache["pos"], pos, win)[:, None]
    return _out(p, out), cache
