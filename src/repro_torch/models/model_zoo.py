"""Uniform Model facade over the decoder-only stack and the
encoder-decoder stack (the counterpart of ``repro.models.model_zoo``).
Every family serves (`prefill`, `decode_step`) and trains (`loss_fn`,
`abstract_params`)."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init_params: Callable      # (seed=0, device=None) -> Transformer/EncDec
    abstract_params: Callable  # () -> Transformer/EncDec on meta
    loss_fn: Callable          # (params, batch, window=0, remat=True) -> loss
    prefill: Callable          # (params, batch, window=0, cache_len=None)
    decode_step: Callable      # (params, cache, tokens, pos, window=0)
    init_cache: Callable       # (batch, max_seq, window=0, device=None)


def build(cfg) -> Model:
    """The model of `cfg`: the enc-dec stack where ``cfg.is_encdec``, else
    the decoder-only one."""
    mod = encdec if cfg.is_encdec else transformer
    return Model(
        cfg=cfg,
        init_params=functools.partial(mod.init_params, cfg),
        abstract_params=functools.partial(mod.abstract_params, cfg),
        loss_fn=functools.partial(mod.loss_fn, cfg),
        prefill=functools.partial(mod.prefill, cfg),
        decode_step=functools.partial(mod.decode_step, cfg),
        init_cache=functools.partial(mod.init_cache, cfg),
    )
