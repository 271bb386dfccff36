"""Training entry points of the model zoo: for now only ``make_batch``,
which serving uses for its prompts (the training loop is not ported
yet)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.pipeline import PackedLMDataset, PipelineConfig
from repro_torch.models.common import dtype_of


def make_batch(cfg, batch: int, seq: int, seed: int, shard_id: int = 0):
    """Training batch from the packed-LM pipeline (+ modality stubs), as
    CPU tensors; the tokens are those of ``repro.launch.train.make_batch``."""
    rng = np.random.default_rng(seed)
    out = {}
    ntok = seq
    if cfg.is_encdec:
        out["frames"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model))
        ).to(dtype_of(cfg))
    elif cfg.n_prefix_patches:
        out["patch_embeds"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.n_prefix_patches, cfg.d_model))
        ).to(dtype_of(cfg))
        ntok = seq - cfg.n_prefix_patches
    ds = PackedLMDataset(PipelineConfig(
        vocab=cfg.vocab, seq_len=ntok, batch=batch, seed=seed * 1000003,
        n_shards=max(shard_id + 1, 1), shard_id=shard_id))
    b = ds.batch_at(0)
    out["tokens"] = torch.from_numpy(b["tokens"])
    out["labels"] = torch.from_numpy(b["labels"])
    return out
