"""Decoder-only model, dense family: training (`loss_fn`,
`hidden_states`), prefill and decode (the counterparts of
``repro.models.transformer``).

The reference stacks each stage's layer params on a leading axis and
``lax.scan``s over them; here a `Transformer` module holds a
``ModuleList`` of `DenseLayer`s and runs them in a Python loop.  Param
names and layouts are the reference's (``embed`` (V, D), ``lm_head``
(D, V), per layer ``ln1``, ``ln2``, ``attn.{wq, wk, wv, wo, qn, kn}``,
``ffn.{w1, w3, w2}``), so ``repro_torch.carry`` can hand the reference's
weights over and stack them back.  A cache is a list with one attention
cache per layer.

The parameters are built frozen (``requires_grad=False``); the training
entry points (``repro_torch.launch.train.train``) switch gradients on.
`prefill` and `decode_step` run under ``torch.no_grad`` either way.
`loss_fn` is plain autograd: the reference trains through XLA ops, no
Pallas kernel and no custom gradient.

The port runs the dense stage only: a config whose layers hold MoE, MLA,
RWKV or Mamba mixers, an encoder (enc-dec) or a VLM patch prefix raises
``NotImplementedError`` naming the family, for training as for serving.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention
from repro_torch.models.common import (dense_init, dtype_of, embed_init,
                                       rms_norm, rope_freqs,
                                       softmax_cross_entropy, swiglu)


def stages(cfg) -> list[tuple[tuple[tuple[str, str], ...], int]]:
    """Returns [(pattern, count)] with pattern = ((mixer, ffn), ...)."""
    L = cfg.n_layers
    if cfg.arch_type == "ssm":                      # rwkv6
        return [((("rwkv", "rwkv_ffn"),), L)]
    if cfg.arch_type == "hybrid":                   # jamba: 1:7, alt MoE
        n = cfg.ssm.attn_every_n
        pattern = []
        for i in range(n):
            mixer = "attn" if i == 0 else "mamba"
            ffn = "moe" if (cfg.moe is not None and i % 2 == 1) else "dense"
            pattern.append((mixer, ffn))
        return [(tuple(pattern), L // n)]
    if cfg.mla is not None:                         # deepseek: first dense FFN
        return [((("mla", "dense"),), 1), ((("mla", "moe"),), L - 1)]
    if cfg.moe is not None:                         # mixtral
        return [((("attn", "moe"),), L)]
    return [((("attn", "dense"),), L)]              # dense / vlm


_FAMILIES = {"rwkv": "RWKV", "rwkv_ffn": "RWKV", "mamba": "Mamba",
             "mla": "MLA", "moe": "MoE"}


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a family the port does not serve."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet")
    if cfg.n_prefix_patches:
        raise NotImplementedError(
            f"{cfg.name}: the VLM patch prefix is not ported yet")
    for pattern, _ in stages(cfg):
        for spec in pattern:
            missing = sorted({_FAMILIES[s] for s in spec if s in _FAMILIES})
            if missing:
                raise NotImplementedError(
                    f"{cfg.name}: the {', '.join(missing)} family is not "
                    "ported yet (the port serves dense attention + dense "
                    "FFN layers)")


def _params(tensors: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


class DenseLayer(nn.Module):
    """One (attn, dense) layer: pre-norm attention, pre-norm SwiGLU."""

    def __init__(self, ln1, ln2, attn: dict, ffn: dict):
        super().__init__()
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        self.attn = _params(attn)
        self.ffn = _params(ffn)

    def forward(self, x, cfg, cache, freqs, *, positions=None, pos=None,
                window: int = 0):
        """Train (no cache) or prefill with `positions` (S,), or decode
        with int `pos`; returns x (a cache is updated in place)."""
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if cache is None:
            out = attention.attn_train(self.attn, h, positions, cfg, window,
                                       freqs)
        elif positions is not None:
            out, _ = attention.attn_prefill(self.attn, h, positions, cfg,
                                            cache, window, freqs)
        else:
            out, _ = attention.attn_decode(self.attn, h, pos, cfg, cache,
                                           window, freqs)
        x = x + out
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        return x + swiglu(h, self.ffn["w1"], self.ffn["w3"], self.ffn["w2"])


class Transformer(nn.Module):
    """Weights of a dense decoder-only model, and its rope frequencies
    (a buffer on the weights' device)."""

    def __init__(self, cfg, embed, final_norm, lm_head, layers):
        super().__init__()
        check_supported(cfg)
        if len(layers) != cfg.n_layers:
            raise ValueError(f"{cfg.name}: {len(layers)} layers for "
                             f"n_layers = {cfg.n_layers}")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))
        self.layers = nn.ModuleList(layers)
        self.register_buffer("rope_freqs", torch.from_numpy(
            rope_freqs(cfg.head_dim, cfg.rope_theta)).to(embed.device),
            persistent=False)


def _init_layer(gen, cfg, dtype) -> DenseLayer:
    ones = torch.ones((cfg.d_model,), dtype=dtype, device=gen.device)
    attn = attention.init_attn(gen, cfg, dtype)
    D, F = cfg.d_model, cfg.d_ff
    ffn = {"w1": dense_init(gen, (D, F), dtype),
           "w3": dense_init(gen, (D, F), dtype),
           "w2": dense_init(gen, (F, D), dtype)}
    return DenseLayer(ones, ones.clone(), attn, ffn)


def init_params(cfg, seed: int = 0, device=None) -> Transformer:
    """Random weights from a ``torch.Generator`` seeded with `seed` on
    `device` (the reference's initializers and scales; other numbers than
    its ``jax.random`` draws)."""
    check_supported(cfg)
    dtype = dtype_of(cfg)
    gen = torch.Generator(device=device or "cpu").manual_seed(seed)
    V, D = cfg.vocab_padded, cfg.d_model
    embed = embed_init(gen, (V, D), dtype)
    lm_head = None if cfg.tie_embeddings else dense_init(gen, (D, V), dtype)
    layers = [_init_layer(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    final_norm = torch.ones((D,), dtype=dtype, device=gen.device)
    return Transformer(cfg, embed, final_norm, lm_head, layers)


def abstract_params(cfg) -> Transformer:
    """The model's parameters on the ``meta`` device: shapes and dtypes,
    no storage (the counterpart of the reference's ``eval_shape`` tree)."""
    check_supported(cfg)
    dtype = dtype_of(cfg)

    def empty(*shape):
        return torch.empty(shape, dtype=dtype, device="meta")

    V, D, Fd = cfg.vocab_padded, cfg.d_model, cfg.d_ff
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layers = []
    for _ in range(cfg.n_layers):
        attn = {"wq": empty(D, H, hd), "wk": empty(D, K, hd),
                "wv": empty(D, K, hd), "wo": empty(H, hd, D)}
        if cfg.qk_norm:
            attn["qn"], attn["kn"] = empty(hd), empty(hd)
        ffn = {"w1": empty(D, Fd), "w3": empty(D, Fd), "w2": empty(Fd, D)}
        layers.append(DenseLayer(empty(D), empty(D), attn, ffn))
    lm_head = None if cfg.tie_embeddings else empty(D, V)
    return Transformer(cfg, empty(V, D), empty(D), lm_head, layers)


def init_cache(cfg, batch: int, max_seq: int, window: int = 0,
               device=None) -> list[dict]:
    check_supported(cfg)
    return [attention.init_cache(cfg, batch, max_seq, dtype_of(cfg), window,
                                 device) for _ in range(cfg.n_layers)]


def _embed_tokens(cfg, params, tokens):
    """Rows of the embedding table.  ``F.embedding``'s backward sums the
    rows' gradients by sorted index on the card, in a fixed order."""
    return F.embedding(tokens.long().to(params.embed.device), params.embed)


def _inputs_embeds(cfg, params, batch):
    """Token embeddings (the VLM patch prefix is not ported)."""
    return _embed_tokens(cfg, params, batch["tokens"])


def _logits(cfg, params, x):
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head
    if cfg.vocab_padded != cfg.vocab:
        ids = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(ids < cfg.vocab, logits,
                             torch.tensor(-1e9, dtype=logits.dtype,
                                          device=logits.device))
    return logits


def _run_layers(cfg, params, x, window: int, remat: bool):
    """Every layer over the whole sequence, no cache (the "train" mode);
    with `remat` each layer is recomputed in the backward."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for layer in params.layers:
        if remat:
            x = checkpoint(layer, x, cfg, None, params.rope_freqs,
                           positions=positions, window=window,
                           use_reentrant=False)
        else:
            x = layer(x, cfg, None, params.rope_freqs, positions=positions,
                      window=window)
    return x


def loss_fn(cfg, params, batch, window: int = 0, remat: bool = True,
            chunked: bool = True):
    """batch: tokens (B, S), labels (B, S), on any device.

    Labels are next-token targets aligned with the token positions; label
    -100 masks a position out.  The mean cross-entropy over the unmasked
    positions (float32); a dense model has no auxiliary loss.  `chunked`
    is the reference's switch for the recurrent families, unused here."""
    check_supported(cfg)
    x = _inputs_embeds(cfg, params, batch)
    x = _run_layers(cfg, params, x, window, remat)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = _logits(cfg, params, x)
    labels = batch["labels"].to(x.device)
    mask = (labels >= 0).float()
    return softmax_cross_entropy(logits, torch.clamp(labels, min=0), mask)


def hidden_states(cfg, params, batch, window: int = 0, chunked: bool = True):
    """Final-norm hidden states (B, S, D): the feature extractor of the
    coded linear-probe head (``repro_torch.core.coded_probe``)."""
    check_supported(cfg)
    x = _inputs_embeds(cfg, params, batch)
    x = _run_layers(cfg, params, x, window, remat=False)
    return rms_norm(x, params.final_norm, cfg.norm_eps)


@torch.no_grad()
def prefill(cfg, params, batch, window: int = 0, cache_len: int | None = None):
    """Returns (last-position logits (B, V), cache).

    The cache has `cache_len` positions (default: the prompt length S), so
    that a caller that will decode past S need not grow it: slots past S
    hold position -1, as the reference's grown cache does."""
    x = _inputs_embeds(cfg, params, batch)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    cache = init_cache(cfg, B, S if cache_len is None else cache_len, window,
                       x.device)
    for layer, c in zip(params.layers, cache):
        x = layer(x, cfg, c, params.rope_freqs, positions=positions,
                  window=window)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(cfg, params, x[:, -1, :]), cache


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, pos: int, window: int = 0):
    """One-token decode.  tokens: (B, 1); pos: int.  Returns
    (logits (B, V), cache), the cache updated in place."""
    x = _embed_tokens(cfg, params, tokens)
    for layer, c in zip(params.layers, cache):
        x = layer(x, cfg, c, params.rope_freqs, pos=int(pos),
                  window=window)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(cfg, params, x[:, -1, :]), cache
