"""Whisper-style encoder-decoder, training and serving (the counterpart of
``repro.models.encdec``).  The conv/mel frontend is a stub: `frames` are
precomputed frame embeddings (B, T_enc, D).

Encoder: bidirectional self-attention, tanh-GELU FFN, sinusoidal
positions.  Decoder: causal self-attention and cross-attention to the
encoder output.  A decoder layer's cache is {"k", "v": (B, slots, H, hd),
"pos": (slots,) int32 (-1 empty), "xk", "xv": (B, T_enc, H, hd)}: the
self-attention's K/V, written in place, and the cross-attention's,
computed once at prefill.  Decode self-attention is the ``gqa_decode``
kernel (G = 1); encoder, prefill and cross-attention are the plain-PyTorch
``attention._flash`` (``causal=False`` for the encoder and the
cross-attention), as the reference computes them.

Param names and layouts are the reference's: ``embed`` (V, D),
``enc_in_proj`` (D, D), ``enc_norm``, ``dec_norm``, ``lm_head`` (D, V);
encoder layers ``ln1``, ``ln2``, ``attn.{wq, wk, wv, wo}``,
``ffn.{w1, w2}``; decoder layers ``ln1``, ``ln_x``, ``ln2``,
``self.{...}`` (the attribute ``self_attn`` here), ``cross.{...}``,
``ffn``.  Training (`loss_fn`) is plain autograd through the encoder and
the decoder, the decoder layers recomputed in the backward with `remat`
(the reference's ``jax.checkpoint`` over its decoder scan); `prefill`
and `decode_step` run under ``torch.no_grad``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.attention import _flash, _heads, _out
from repro_torch.models.common import (dense_init, dtype_of, embed_init,
                                       frozen_params, generator, rms_norm,
                                       sinusoidal_positions,
                                       softmax_cross_entropy)


def _init_qkvo(gen, cfg, dtype) -> dict:
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    return {"wq": dense_init(gen, (D, H, hd), dtype),
            "wk": dense_init(gen, (D, H, hd), dtype),
            "wv": dense_init(gen, (D, H, hd), dtype),
            "wo": dense_init(gen, (H, hd, D), dtype)}


def _init_ffn(gen, cfg, dtype) -> dict:
    return {"w1": dense_init(gen, (cfg.d_model, cfg.d_ff), dtype),
            "w2": dense_init(gen, (cfg.d_ff, cfg.d_model), dtype)}


def _ffn(p, x):
    return F.gelu(x @ p["w1"], approximate="tanh") @ p["w2"]


class EncLayer(nn.Module):
    norms = ("ln1", "ln2")

    def __init__(self, ln1, ln2, attn: dict, ffn: dict):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.attn = frozen_params(attn)
        self.ffn = frozen_params(ffn)

    @property
    def groups(self) -> dict:
        """{reference key: ParameterDict} of the layer's weight groups."""
        return {"attn": self.attn, "ffn": self.ffn}


class DecLayer(nn.Module):
    norms = ("ln1", "ln_x", "ln2")

    def __init__(self, ln1, ln_x, ln2, self_attn: dict, cross: dict,
                 ffn: dict):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ln_x = nn.Parameter(ln_x, requires_grad=False)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.self_attn = frozen_params(self_attn)
        self.cross = frozen_params(cross)
        self.ffn = frozen_params(ffn)

    @property
    def groups(self) -> dict:
        return {"self": self.self_attn, "cross": self.cross,
                "ffn": self.ffn}


class EncDec(nn.Module):
    """Weights of an encoder-decoder model."""

    def __init__(self, cfg, embed, enc_in_proj, enc_norm, dec_norm, lm_head,
                 enc_layers, dec_layers):
        super().__init__()
        if len(enc_layers) != cfg.n_encoder_layers \
                or len(dec_layers) != cfg.n_layers:
            raise ValueError(
                f"{cfg.name}: {len(enc_layers)} + {len(dec_layers)} layers "
                f"for {cfg.n_encoder_layers} + {cfg.n_layers}")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.enc_in_proj = nn.Parameter(enc_in_proj, requires_grad=False)
        self.enc_norm = nn.Parameter(enc_norm, requires_grad=False)
        self.dec_norm = nn.Parameter(dec_norm, requires_grad=False)
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)
        self.enc = nn.ModuleList(enc_layers)
        self.dec = nn.ModuleList(dec_layers)


def init_params(cfg, seed: int = 0, device=None) -> EncDec:
    """Random weights from a ``torch.Generator`` seeded with `seed` on
    `device` (the reference's initializers and scales); on the ``meta``
    device shapes and dtypes without storage."""
    dtype = dtype_of(cfg)
    gen = generator(seed, device)
    D = cfg.d_model

    def ones():
        return torch.ones((D,), dtype=dtype, device=gen.device)

    embed = embed_init(gen, (cfg.vocab, D), dtype)
    enc_in_proj = dense_init(gen, (D, D), dtype)
    lm_head = dense_init(gen, (D, cfg.vocab), dtype)
    enc = [EncLayer(ones(), ones(), _init_qkvo(gen, cfg, dtype),
                    _init_ffn(gen, cfg, dtype))
           for _ in range(cfg.n_encoder_layers)]
    dec = [DecLayer(ones(), ones(), ones(), _init_qkvo(gen, cfg, dtype),
                    _init_qkvo(gen, cfg, dtype), _init_ffn(gen, cfg, dtype))
           for _ in range(cfg.n_layers)]
    return EncDec(cfg, embed, enc_in_proj, ones(), ones(), lm_head, enc, dec)


def abstract_params(cfg) -> EncDec:
    """The model's parameters on the ``meta`` device (the counterpart of
    the reference's ``eval_shape`` tree), from `init_params` itself."""
    return init_params(cfg, device="meta")


def _qkv(p, x):
    return _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])


def encode(cfg, params, frames):
    """frames: (B, T_enc, D) stub embeddings -> (B, T_enc, D), under
    autograd where the caller has gradients on."""
    B, T, D = frames.shape
    dev = params.embed.device
    x = frames.to(device=dev, dtype=dtype_of(cfg)) @ params.enc_in_proj
    x = x + sinusoidal_positions(T, D, dev).to(x.dtype)[None]
    pos = torch.arange(T, dtype=torch.int32, device=dev)
    for layer in params.enc:
        h = rms_norm(x, layer.ln1, cfg.norm_eps)
        q, k, v = _qkv(layer.attn, h)
        o = _flash(q, k, v, pos, pos, 0, causal=False)
        x = x + _out(layer.attn, o)
        h = rms_norm(x, layer.ln2, cfg.norm_eps)
        x = x + _ffn(layer.ffn, h)
    return rms_norm(x, params.enc_norm, cfg.norm_eps)


def init_cache(cfg, batch: int, max_seq: int, window: int = 0,
               device=None) -> list[dict]:
    dtype = dtype_of(cfg)
    slots = min(max_seq, window) if window > 0 else max_seq
    H, hd, T = cfg.n_heads, cfg.head_dim, cfg.encoder_seq

    def zeros(n):
        return torch.zeros((batch, n, H, hd), dtype=dtype, device=device)

    return [{"k": zeros(slots), "v": zeros(slots),
             "pos": torch.full((slots,), -1, dtype=torch.int32,
                               device=device),
             "xk": zeros(T), "xv": zeros(T)} for _ in range(cfg.n_layers)]


def dec_layer(cfg, layer, x, enc_out, cache, *, positions=None, pos=None,
              window: int = 0):
    """One decoder layer: train with `positions` (S,) and no cache (the
    cross K/V from `enc_out`), prefill with `positions` (fills `cache`,
    the cross K/V from `enc_out`), or decode with int `pos` (the cross K/V
    from the cache).  Returns x."""
    p = layer.self_attn
    h = rms_norm(x, layer.ln1, cfg.norm_eps)
    q, k, v = _qkv(p, h)
    if positions is not None:
        o = _flash(q, k, v, positions, positions, window)
        if cache is not None:
            S = x.shape[1]
            slots = cache["k"].shape[1]
            if slots >= S:
                cache["k"][:, :S] = k
                cache["v"][:, :S] = v
                cache["pos"][:S] = positions
            else:                             # rolling window: keep the tail
                cache["k"].copy_(k[:, S - slots:])
                cache["v"].copy_(v[:, S - slots:])
                cache["pos"].copy_(positions[S - slots:])
    else:
        slots = cache["k"].shape[1]
        slot = pos % slots if window > 0 else min(pos, slots - 1)
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        cache["pos"][slot] = pos
        o = ops.gqa_decode(q[:, 0], cache["k"], cache["v"], cache["pos"],
                           pos, window)[:, None]
    x = x + _out(p, o)

    # cross-attention to the fixed encoder output, never causal
    c = layer.cross
    h = rms_norm(x, layer.ln_x, cfg.norm_eps)
    qx = _heads(h, c["wq"])
    if cache is None:
        kx, vx = _heads(enc_out, c["wk"]), _heads(enc_out, c["wv"])
    else:
        if positions is not None:
            cache["xk"].copy_(_heads(enc_out, c["wk"]))
            cache["xv"].copy_(_heads(enc_out, c["wv"]))
        kx, vx = cache["xk"], cache["xv"]
    t_pos = torch.arange(kx.shape[1], dtype=torch.int32, device=x.device)
    q_pos = torch.zeros((qx.shape[1],), dtype=torch.int32, device=x.device)
    ox = _flash(qx, kx, vx, q_pos, t_pos, 0, causal=False)
    x = x + _out(c, ox)

    h = rms_norm(x, layer.ln2, cfg.norm_eps)
    return x + _ffn(layer.ffn, h)


def _dec_inputs(cfg, params, tokens):
    """Token embeddings plus sinusoidal positions, and the positions."""
    dev = params.embed.device
    x = F.embedding(tokens.long().to(dev), params.embed)
    S = x.shape[1]
    x = x + sinusoidal_positions(S, cfg.d_model, dev).to(x.dtype)[None]
    return x, torch.arange(S, dtype=torch.int32, device=dev)


def loss_fn(cfg, params, batch, window: int = 0, remat: bool = True,
            chunked: bool = True):
    """batch: frames (B, T_enc, D), tokens (B, S), labels (B, S), on any
    device.  The mean cross-entropy over the labels >= 0 (float32; no
    auxiliary loss); with `remat` each decoder layer is recomputed in the
    backward.  `chunked` is the decoder-only models' switch, unused."""
    enc_out = encode(cfg, params, batch["frames"])
    x, positions = _dec_inputs(cfg, params, batch["tokens"])
    for layer in params.dec:
        if remat:
            x = checkpoint(dec_layer, cfg, layer, x, enc_out, None,
                           positions=positions, window=window,
                           use_reentrant=False)
        else:
            x = dec_layer(cfg, layer, x, enc_out, None, positions=positions,
                          window=window)
    x = rms_norm(x, params.dec_norm, cfg.norm_eps)
    logits = x @ params.lm_head
    labels = batch["labels"].to(x.device)
    mask = (labels >= 0).float()
    return softmax_cross_entropy(logits, torch.clamp(labels, min=0), mask)


def pos_embed_at(cfg, pos: int, device=None):
    """The sinusoidal position embedding at `pos`, (1, 1, D) float32,
    computed in float32 as the reference's ``_pos_embed_at``."""
    D = cfg.d_model
    i = torch.arange(D // 2, dtype=torch.float32, device=device)
    ang = torch.tensor(float(pos), dtype=torch.float32, device=device) \
        / torch.pow(torch.tensor(10000.0, device=device), 2.0 * i / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)])[None, None, :]


@torch.no_grad()
def prefill(cfg, params, batch, window: int = 0,
            cache_len: int | None = None):
    """batch: frames (B, T_enc, D), tokens (B, S).  Returns (last-position
    logits (B, V), cache); the cache has `cache_len` self-attention slots
    (default S), those past S at position -1."""
    enc_out = encode(cfg, params, batch["frames"])
    x, positions = _dec_inputs(cfg, params, batch["tokens"])
    B, S = x.shape[:2]
    cache = init_cache(cfg, B, S if cache_len is None else cache_len,
                       window, x.device)
    for layer, c in zip(params.dec, cache):
        x = dec_layer(cfg, layer, x, enc_out, c, positions=positions,
                      window=window)
    x = rms_norm(x, params.dec_norm, cfg.norm_eps)
    return x[:, -1, :] @ params.lm_head, cache


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, pos: int, window: int = 0):
    """One-token decode.  tokens: (B, 1); pos: int.  Returns (logits
    (B, V), cache), the cache updated in place."""
    dev = params.embed.device
    pos = int(pos)
    x = F.embedding(tokens.long().to(dev), params.embed)
    x = x + pos_embed_at(cfg, pos, dev).to(x.dtype)
    for layer, c in zip(params.dec, cache):
        x = dec_layer(cfg, layer, x, None, c, pos=pos, window=window)
    x = rms_norm(x, params.dec_norm, cfg.norm_eps)
    return x[:, -1, :] @ params.lm_head, cache
