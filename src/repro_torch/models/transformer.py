"""Decoder-only model: serving (prefill, decode) and training (`loss_fn`,
`hidden_states`) of every decoder family (dense GQA, MoE, MLA, RWKV-6,
Mamba hybrid, VLM prefix; the counterparts of
``repro.models.transformer``).

Layers come in the reference's *stages* (`stages`): a stage is a pattern
of (mixer, ffn) layer specs repeated its count of times (jamba: one
attention layer and seven Mamba layers, the odd ones with an MoE FFN;
deepseek: a dense-FFN MLA layer, then MoE ones).  The reference stacks
each stage's params on a leading axis and ``lax.scan``s over them; here a
`Transformer` holds every layer in order (`layer_specs`) in a
``ModuleList`` of `Layer`s and runs them in a Python loop.  Param names
and layouts are the reference's (``embed`` (V, D), ``lm_head`` (D, V),
``patch_proj`` (D, D), per layer ``ln1``, ``ln2``, the mixer's group
``attn``/``mla``/``rwkv``/``mamba`` and the FFN's ``ffn``/``moe``), and
so are the leaf dtypes (`FLOAT32_LEAVES` stay float32 in a bf16 model),
so ``repro_torch.carry`` can hand the reference's weights over and stack
them back.  A cache is a list with one entry a layer: an attention cache,
an MLA latent cache, or a recurrent state, each written in place.

The parameters are built frozen (``requires_grad=False``); the training
entry points (``repro_torch.launch.train.train``) switch gradients on.
`prefill` and `decode_step` run under ``torch.no_grad`` either way.
`loss_fn` is plain autograd: the reference trains through XLA ops (its
``_flash``, the scans, the MoE einsums), no Pallas kernel and no custom
gradient.  In the "train" mode (no cache) a layer's recurrent mixer
starts from a zero state made inside the layer's forward, so that a
recompute (``remat``) starts from its own; the MoE layers' load-balance
values are summed over the layers and added to the cross-entropy, as the
reference's ``loss + aux``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, mla, moe, ssm_mamba, ssm_rwkv
from repro_torch.models.common import (dense_init, dtype_of, embed_init,
                                       frozen_params, generator, rms_norm,
                                       rope_freqs, softmax_cross_entropy,
                                       swiglu)


def stages(cfg) -> list[tuple[tuple[tuple[str, str], ...], int]]:
    """Returns [(pattern, count)] with pattern = ((mixer, ffn), ...)."""
    L = cfg.n_layers
    if cfg.arch_type == "ssm":                      # rwkv6
        return [((("rwkv", "rwkv_ffn"),), L)]
    if cfg.arch_type == "hybrid":                   # jamba: 1:7, alt MoE
        n = cfg.ssm.attn_every_n
        assert L % n == 0
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


# the reference's param key of each layer part
FFN_KEYS = {"dense": "ffn", "moe": "moe", "rwkv_ffn": "ffn"}
# the float32 leaves of a bf16 model: {(group key, leaf name)}
FLOAT32_LEAVES = {("moe", "router"), ("rwkv", "w0"), ("rwkv", "u"),
                  ("mamba", "dt_proj_b"), ("mamba", "A_log"),
                  ("mamba", "D")}


def leaf_dtype(cfg, group: str, name: str) -> torch.dtype:
    """The dtype of a layer leaf: float32 for `FLOAT32_LEAVES`, else the
    config's."""
    return (torch.float32 if (group, name) in FLOAT32_LEAVES
            else dtype_of(cfg))


def layer_specs(cfg) -> list[tuple[str, str]]:
    """Every layer's (mixer, ffn) in order: each stage's pattern repeated
    its count of times."""
    return [spec for pattern, count in stages(cfg) for _ in range(count)
            for spec in pattern]


class Layer(nn.Module):
    """One (mixer, ffn) layer: pre-norm mixer, pre-norm FFN.  The mixer's
    weights are the attribute named after it (``attn``, ``mla``, ``rwkv``
    or ``mamba``), the FFN's ``ffn`` (dense, rwkv_ffn) or ``moe``: the
    reference's keys."""

    norms = ("ln1", "ln2")

    def __init__(self, spec, ln1, ln2, mixer: dict, ffn: dict):
        super().__init__()
        self.spec = tuple(spec)
        self.mixer_key, self.ffn_key = spec[0], FFN_KEYS[spec[1]]
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)
        setattr(self, self.mixer_key, frozen_params(mixer))
        setattr(self, self.ffn_key, frozen_params(ffn))

    @property
    def groups(self) -> dict:
        """{reference key: ParameterDict} of the layer's weight groups."""
        return {self.mixer_key: getattr(self, self.mixer_key),
                self.ffn_key: getattr(self, self.ffn_key)}

    def forward(self, x, cfg, cache, freqs, *, positions=None, pos=None,
                window: int = 0, chunked: bool = True, host_pos=None):
        """Train (no cache; `positions` (S,)), prefill (a cache and
        `positions`) or decode (a cache and int `pos`); `host_pos` the
        positions as a NumPy array (attention's tile list).  Returns (x, aux):
        aux the MoE FFN's load-balance value (a float32 scalar), None for
        the other FFNs.  In train mode a recurrent mixer starts from a
        zero state made here (the reference's fresh state), so a
        recompute of the layer makes its own; otherwise the cache or the
        recurrent state is updated in place."""
        mixer, ffn = self.spec
        p = getattr(self, self.mixer_key)
        train = cache is None
        prefill = positions is not None
        if train and mixer == "rwkv":
            cache = ssm_rwkv.init_rwkv_state(cfg, x.shape[0], x.dtype,
                                             x.device)
        elif train and mixer == "mamba":
            cache = ssm_mamba.init_mamba_state(cfg, x.shape[0], x.dtype,
                                               x.device)
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        if mixer == "attn":
            if train:
                out = attention.attn_train(p, h, positions, cfg, window,
                                           freqs, host_pos)
            elif prefill:
                out, _ = attention.attn_prefill(p, h, positions, cfg, cache,
                                                window, freqs, host_pos)
            else:
                out, _ = attention.attn_decode(p, h, pos, cfg, cache, window,
                                               freqs)
        elif mixer == "mla":
            if train:
                out = mla.mla_train(p, h, positions, cfg, window, freqs,
                                    host_pos)
            elif prefill:
                out, _ = mla.mla_prefill(p, h, positions, cfg, cache, window,
                                         freqs, host_pos)
            else:
                out, _ = mla.mla_decode(p, h, pos, cfg, cache, window, freqs)
        elif mixer == "rwkv":
            out = ssm_rwkv.rwkv_mix(p, h, cache, cfg,
                                    chunked=chunked and prefill)
        else:
            out = ssm_mamba.mamba_block(p, h, cache, cfg,
                                        chunked=chunked and prefill)
        x = x + out
        q = getattr(self, self.ffn_key)
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        aux = None
        if ffn == "dense":
            out = swiglu(h, q["w1"], q["w3"], q["w2"])
        elif ffn == "moe":
            out, aux = moe.moe_ffn(q, h, cfg)
        else:
            out, cache["x_prev_ffn"] = ssm_rwkv.rwkv_ffn(
                q, h, cache["x_prev_ffn"], cfg)
        return x + out, aux


def _rope_dim(cfg) -> int:
    return cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.head_dim


class Transformer(nn.Module):
    """Weights of a decoder-only model (every stage's layers in order in
    `layers`), and its rope frequencies (a buffer on the weights'
    device)."""

    def __init__(self, cfg, embed, final_norm, lm_head, layers,
                 patch_proj=None):
        super().__init__()
        if cfg.is_encdec:
            raise ValueError(f"{cfg.name}: an encoder-decoder config "
                             "(repro_torch.models.encdec)")
        specs = layer_specs(cfg)
        if [layer.spec for layer in layers] != specs:
            raise ValueError(f"{cfg.name}: {len(layers)} layers "
                             f"{[layer.spec for layer in layers][:3]}... "
                             f"for the stages' {len(specs)} {specs[:3]}...")
        if (patch_proj is None) != (not cfg.n_prefix_patches):
            raise ValueError(f"{cfg.name}: patch_proj goes with "
                             f"n_prefix_patches = {cfg.n_prefix_patches}")
        self.cfg = cfg
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))
        self.patch_proj = (None if patch_proj is None
                           else nn.Parameter(patch_proj, requires_grad=False))
        self.layers = nn.ModuleList(layers)
        self.register_buffer("rope_freqs", torch.from_numpy(
            rope_freqs(_rope_dim(cfg), cfg.rope_theta)).to(embed.device),
            persistent=False)


def _init_layer(gen, spec, cfg, dtype) -> Layer:
    mixer, ffn = spec
    D, Fd = cfg.d_model, cfg.d_ff
    ones = torch.ones((D,), dtype=dtype, device=gen.device)
    mixer_p = {"attn": attention.init_attn, "mla": mla.init_mla,
               "rwkv": ssm_rwkv.init_rwkv_mix,
               "mamba": ssm_mamba.init_mamba}[mixer](gen, cfg, dtype)
    if ffn == "dense":
        ffn_p = {"w1": dense_init(gen, (D, Fd), dtype),
                 "w3": dense_init(gen, (D, Fd), dtype),
                 "w2": dense_init(gen, (Fd, D), dtype)}
    elif ffn == "moe":
        ffn_p = moe.init_moe(gen, cfg, dtype)
    else:
        ffn_p = ssm_rwkv.init_rwkv_ffn(gen, cfg, dtype)
    return Layer(spec, ones, ones.clone(), mixer_p, ffn_p)


def init_params(cfg, seed: int = 0, device=None) -> Transformer:
    """Random weights from a ``torch.Generator`` seeded with `seed` on
    `device` (the reference's initializers, scales and leaf dtypes; other
    numbers than its ``jax.random`` draws).  On the ``meta`` device the
    weights have shapes and dtypes and no storage (`abstract_params`)."""
    dtype = dtype_of(cfg)
    gen = generator(seed, device)
    V, D = cfg.vocab_padded, cfg.d_model
    embed = embed_init(gen, (V, D), dtype)
    lm_head = None if cfg.tie_embeddings else dense_init(gen, (D, V), dtype)
    patch_proj = (dense_init(gen, (D, D), dtype) if cfg.n_prefix_patches
                  else None)
    layers = [_init_layer(gen, spec, cfg, dtype)
              for spec in layer_specs(cfg)]
    final_norm = torch.ones((D,), dtype=dtype, device=gen.device)
    return Transformer(cfg, embed, final_norm, lm_head, layers, patch_proj)


def abstract_params(cfg) -> Transformer:
    """The model's parameters on the ``meta`` device: shapes and leaf
    dtypes, no storage (the counterpart of the reference's ``eval_shape``
    tree), from `init_params` itself."""
    return init_params(cfg, device="meta")


def init_cache(cfg, batch: int, max_seq: int, window: int = 0,
               device=None) -> list[dict]:
    """One cache a layer: {k, v, pos} (attn), {c, kpe, pos} (mla), the
    recurrent state {x_prev_mix, x_prev_ffn, wkv} (rwkv) or {conv, h}
    (mamba); the attention caches hold `max_seq` slots (min(max_seq,
    window) with a window), the states do not depend on it."""
    dtype = dtype_of(cfg)
    out = []
    for mixer, _ in layer_specs(cfg):
        if mixer == "attn":
            out.append(attention.init_cache(cfg, batch, max_seq, dtype,
                                            window, device))
        elif mixer == "mla":
            out.append(mla.init_mla_cache(cfg, batch, max_seq, dtype, window,
                                          device))
        elif mixer == "rwkv":
            out.append(ssm_rwkv.init_rwkv_state(cfg, batch, dtype, device))
        else:
            out.append(ssm_mamba.init_mamba_state(cfg, batch, dtype, device))
    return out


def _embed_tokens(cfg, params, tokens):
    """Rows of the embedding table.  ``F.embedding``'s backward sums the
    rows' gradients by sorted index on the card, in a fixed order."""
    return F.embedding(tokens.long().to(params.embed.device), params.embed)


def _inputs_embeds(cfg, params, batch):
    """Token embeddings, after the VLM patch prefix (patch_embeds
    (B, P, D) @ patch_proj) where the config has one."""
    emb = _embed_tokens(cfg, params, batch["tokens"])
    if cfg.n_prefix_patches:
        patches = batch["patch_embeds"].to(device=emb.device,
                                           dtype=emb.dtype)
        emb = torch.cat([patches @ params.patch_proj, emb], dim=1)
    return emb


def _logits(cfg, params, x):
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head
    if cfg.vocab_padded != cfg.vocab:
        ids = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(ids < cfg.vocab, logits,
                             torch.tensor(-1e9, dtype=logits.dtype,
                                          device=logits.device))
    return logits


def _run_layers(cfg, params, x, window: int, remat: bool, chunked: bool):
    """Every layer over the whole sequence, no cache (the "train" mode);
    with `remat` each layer is recomputed in the backward.  Returns (x,
    the MoE layers' load-balance values summed in layer order, float32)."""
    host = np.arange(x.shape[1], dtype=np.int32)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params.layers:
        if remat:
            x, a = checkpoint(layer, x, cfg, None, params.rope_freqs,
                              positions=positions, window=window,
                              chunked=chunked, host_pos=host,
                              use_reentrant=False)
        else:
            x, a = layer(x, cfg, None, params.rope_freqs,
                         positions=positions, window=window, chunked=chunked,
                         host_pos=host)
        if a is not None:
            aux = aux + a
    return x, aux


def loss_fn(cfg, params, batch, window: int = 0, remat: bool = True,
            chunked: bool = True):
    """batch: tokens (B, S), labels (B, S) [, patch_embeds (B, P, D)], on
    any device.

    Labels are next-token targets aligned with the *token* positions
    (the VLM prefix's P positions are cut before the logits); label -100
    masks a position out.  The mean cross-entropy over the unmasked
    positions (float32) plus the MoE layers' load-balance values.
    `chunked` lets the recurrent mixers take their chunked forms where
    the reference's would."""
    x = _inputs_embeds(cfg, params, batch)
    x, aux = _run_layers(cfg, params, x, window, remat, chunked)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    if cfg.n_prefix_patches:
        x = x[:, cfg.n_prefix_patches:, :]
    logits = _logits(cfg, params, x)
    labels = batch["labels"].to(x.device)
    mask = (labels >= 0).float()
    loss = softmax_cross_entropy(logits, torch.clamp(labels, min=0), mask)
    return loss + aux


def hidden_states(cfg, params, batch, window: int = 0, chunked: bool = True):
    """Final-norm hidden states (B, S, D), the VLM prefix's positions
    kept: the feature extractor of the coded linear-probe head
    (``repro_torch.core.coded_probe``)."""
    x = _inputs_embeds(cfg, params, batch)
    x, _ = _run_layers(cfg, params, x, window, remat=False, chunked=chunked)
    return rms_norm(x, params.final_norm, cfg.norm_eps)


@torch.no_grad()
def prefill(cfg, params, batch, window: int = 0, cache_len: int | None = None,
            chunked: bool = True):
    """batch: tokens (B, S) [, patch_embeds (B, P, D)].  Returns
    (last-position logits (B, V), cache).

    The attention caches have `cache_len` positions (default: the prompt
    length P + S), so that a caller that will decode past it need not
    grow them: slots past the prompt hold position -1, as the reference's
    grown cache does.  `chunked` lets the recurrent mixers take their
    chunked forms where the reference's would."""
    x = _inputs_embeds(cfg, params, batch)
    B, S = x.shape[0], x.shape[1]
    host = np.arange(S, dtype=np.int32)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    cache = init_cache(cfg, B, S if cache_len is None else cache_len, window,
                       x.device)
    for layer, c in zip(params.layers, cache):
        x, _ = layer(x, cfg, c, params.rope_freqs, positions=positions,
                     window=window, chunked=chunked, host_pos=host)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(cfg, params, x[:, -1, :]), cache


@torch.no_grad()
def decode_step(cfg, params, cache, tokens, pos: int, window: int = 0):
    """One-token decode.  tokens: (B, 1); pos: int.  Returns
    (logits (B, V), cache), the cache updated in place."""
    x = _embed_tokens(cfg, params, tokens)
    for layer, c in zip(params.layers, cache):
        x, _ = layer(x, cfg, c, params.rope_freqs, pos=int(pos),
                     window=window)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(cfg, params, x[:, -1, :]), cache
