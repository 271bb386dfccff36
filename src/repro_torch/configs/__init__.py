"""Architecture registry: --arch <id> -> ModelConfig, and reduced smoke
variants.  The data modules beside this file are copies of the reference's
``repro.configs``, field for field."""
from __future__ import annotations

import dataclasses
import importlib

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
