"""Architecture registry: --arch <id> -> ModelConfig, reduced smoke
variants, and the input specs (meta tensors) of every assigned input
shape.  The data modules beside this file are copies of the reference's
``repro.configs``, field for field."""
from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.config import SHAPES, ModelConfig, ShapeConfig

ARCH_IDS = [
    "yi-6b", "command-r-plus-104b", "internvl2-1b", "mixtral-8x7b",
    "rwkv6-1.6b", "qwen3-4b", "jamba-1.5-large-398b", "deepseek-v2-lite-16b",
    "whisper-base", "qwen3-32b",
]


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(
        f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.CONFIG


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: 2 layers, d_model<=512, <=4 experts."""
    updates = dict(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=512, vocab=512,
    )
    if cfg.rwkv is not None:
        updates["n_heads"] = 4
        updates["n_kv_heads"] = 4
        updates["rwkv"] = dataclasses.replace(cfg.rwkv, head_size=64)
    if cfg.moe is not None:
        updates["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_ff_expert=128,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1))
        updates["d_ff"] = 128
    if cfg.mla is not None:
        updates["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=64, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32)
        updates["head_dim"] = 48
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(cfg.ssm, attn_every_n=2)
        updates["n_layers"] = 2
    if cfg.is_encdec:
        updates["n_encoder_layers"] = 2
        updates["encoder_seq"] = 16
    if cfg.n_prefix_patches:
        updates["n_prefix_patches"] = 4
    if cfg.swa_window:
        updates["swa_window"] = 32
    updates["dtype"] = "float32"        # CPU smoke runs in f32
    return dataclasses.replace(cfg, **updates)


def input_specs(cfg: ModelConfig, shape: ShapeConfig | str,
                batch_override: int | None = None, device="meta") -> dict:
    """Stand-ins for the step function's `batch` argument: tensors with
    the reference's shapes and dtypes on `device` (``meta`` by default:
    no storage).

    train/prefill: int32 token batch (+ modality stubs in the config's
    dtype; the VLM prefix's patches counted in the sequence length),
    train adds the labels.  decode: one new token.
    """
    from repro_torch.models.common import dtype_of

    if isinstance(shape, str):
        shape = SHAPES[shape]
    B = batch_override or shape.global_batch
    S = shape.seq_len

    def f(sh, dt=torch.int32):
        return torch.empty(sh, dtype=dt, device=device)

    emb_dt = dtype_of(cfg)
    if shape.kind == "decode":
        return {"tokens": f((B, 1))}
    batch = {}
    if cfg.is_encdec:
        batch["frames"] = f((B, cfg.encoder_seq, cfg.d_model), emb_dt)
        batch["tokens"] = f((B, S))
    elif cfg.n_prefix_patches:
        batch["patch_embeds"] = f((B, cfg.n_prefix_patches, cfg.d_model),
                                  emb_dt)
        batch["tokens"] = f((B, S - cfg.n_prefix_patches))
    else:
        batch["tokens"] = f((B, S))
    if shape.kind == "train":
        batch["labels"] = f(tuple(batch["tokens"].shape))
    return batch


def decode_window(cfg: ModelConfig, shape: ShapeConfig | str) -> int:
    """Window override for long-context decode: sub-quadratic requirement.

    long_500k on archs without native sub-quadratic attention runs the
    sliding-window variant (window 4096).  Natively windowed archs
    (mixtral) use their own window everywhere.
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if cfg.swa_window:
        return cfg.swa_window
    if shape.name == "long_500k" and cfg.arch_type not in ("ssm", "hybrid"):
        return 4096
    return 0
