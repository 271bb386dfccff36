"""Uniform Model facade over the decoder-only stack (the counterpart of
``repro.models.model_zoo``): training (`loss_fn`, `abstract_params`) and
serving of the dense family; the encoder-decoder stack is not ported
yet."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init_params: Callable      # (seed=0, device=None) -> Transformer
    abstract_params: Callable  # () -> Transformer on the meta device
    loss_fn: Callable          # (params, batch, window=0, remat=True) -> loss
    prefill: Callable          # (params, batch, window=0, cache_len=None)
    decode_step: Callable      # (params, cache, tokens, pos, window=0)
    init_cache: Callable       # (batch, max_seq, window=0, device=None)


def build(cfg) -> Model:
    """The model of `cfg`; raises NotImplementedError for a family the port
    does not run yet (enc-dec, VLM prefix, MoE, MLA, RWKV, Mamba)."""
    transformer.check_supported(cfg)
    return Model(
        cfg=cfg,
        init_params=functools.partial(transformer.init_params, cfg),
        abstract_params=functools.partial(transformer.abstract_params, cfg),
        loss_fn=functools.partial(transformer.loss_fn, cfg),
        prefill=functools.partial(transformer.prefill, cfg),
        decode_step=functools.partial(transformer.decode_step, cfg),
        init_cache=functools.partial(transformer.init_cache, cfg),
    )
