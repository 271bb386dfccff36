"""Deterministic, shardable LM data pipeline (a NumPy copy of the
reference's ``repro.data.pipeline``; ``batch_at`` gives the same bits).

Documents (synthetic Zipf streams standing in for tokenized text) are packed
into fixed-length sequences with EOS separators; labels are next-token
targets with -100 across document boundaries.  `batch_at(step)` is a pure
function of (seed, shard, step).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    seq_len: int
    batch: int                   # per-shard batch size
    seed: int = 0
    n_shards: int = 1
    shard_id: int = 0
    eos_id: int = 0
    mean_doc_len: int = 96
    mask_cross_doc: bool = True


class PackedLMDataset:
    def __init__(self, cfg: PipelineConfig):
        if not 0 <= cfg.shard_id < cfg.n_shards:
            raise ValueError(f"shard_id {cfg.shard_id} outside "
                             f"[0, {cfg.n_shards})")
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab, dtype=np.float64)   # reserve eos=0
        p = 1.0 / ranks
        self._probs = p / p.sum()

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        n = max(2, int(rng.exponential(self.cfg.mean_doc_len)))
        toks = rng.choice(self.cfg.vocab - 1, size=n, p=self._probs) + 1
        return np.concatenate([toks, [self.cfg.eos_id]]).astype(np.int32)

    def _packed_row(self, rng: np.random.Generator):
        """One packed row of seq_len+1 tokens + doc-boundary marks."""
        S = self.cfg.seq_len + 1
        buf = np.empty(S, np.int32)
        bounds = np.zeros(S, bool)
        i = 0
        while i < S:
            d = self._doc(rng)
            take = min(len(d), S - i)
            buf[i:i + take] = d[:take]
            if i > 0:
                bounds[i] = True            # first token of a new doc
            i += take
        return buf, bounds

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, shard_id, step) -> {tokens, labels}."""
        cfg = self.cfg
        out_t = np.empty((cfg.batch, cfg.seq_len), np.int32)
        out_l = np.empty((cfg.batch, cfg.seq_len), np.int32)
        for b in range(cfg.batch):
            key = (cfg.seed, cfg.shard_id, step, b)
            rng = np.random.default_rng(abs(hash(key)) % (2 ** 63))
            row, bounds = self._packed_row(rng)
            out_t[b] = row[:-1]
            labels = row[1:].copy()
            if cfg.mask_cross_doc:
                labels[bounds[1:]] = -100   # don't predict across docs
            out_l[b] = labels
        return {"tokens": out_t, "labels": out_l}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
