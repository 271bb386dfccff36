"""Minimal functional optimizers over a dict of named tensors (the
counterparts of ``repro.optim.optimizers``).

Each optimizer is (init_fn, update_fn):
  state = init(params)
  params, state = update(params, grads, state, lr)

`params` maps names to tensors (e.g. ``dict(model.named_parameters())``)
and `grads` the same names to their gradients.  Unlike the reference,
which returns a new tree, `update` writes each parameter and each state
tensor in place, one leaf at a time: a tree-wide update that built every
new moment before freeing the old would need the optimizer state twice
(35 GB more for Adam at qwen3-4b's full width).  The arithmetic is the
reference's: moments in float32 whatever the parameter dtype, the new
parameter computed in float32 and cast back to its dtype (SGD in the
parameter's dtype, as the reference's).  Adam fuses the reference's
element-wise steps into fewer passes (``add_`` with ``alpha``,
``addcmul_``, ``addcdiv``: 94 bytes a parameter moved instead of ~150,
the update ~37% faster at full width on an H100), so its float32
roundings fall at other places: within 1e-6 of the reference's over a few
updates.
"""
from __future__ import annotations

import numpy as np
import torch


def _zeros_f32(params: dict) -> dict:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def sgd():
    def init(params):
        return ()

    @torch.no_grad()
    def update(params, grads, state, lr):
        for k, p in params.items():
            p.sub_(grads[k].to(p.dtype) * lr)
        return params, state

    return init, update


def momentum(beta: float = 0.9):
    def init(params):
        return _zeros_f32(params)

    @torch.no_grad()
    def update(params, grads, state, lr):
        for k, p in params.items():
            m = state[k]
            m.mul_(beta).add_(grads[k].float())
            p.copy_(p.float() - lr * m)
        return params, state

    return init, update


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    def init(params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params), "t": 0}

    @torch.no_grad()
    def update(params, grads, state, lr):
        t = state["t"] + 1
        # the bias corrections in float32, as the reference's traced ones
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        for k, p in params.items():
            g = grads[k].float()
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            den = (v / bc2).sqrt_().add_(eps)
            # p - lr (m / bc1) / den, in float32 (a bf16 p is promoted)
            p.copy_(torch.addcdiv(p, m, den, value=-lr / bc1))
            del den
        state["t"] = t
        return params, state

    return init, update


def get(name: str):
    if name == "sgd":
        return sgd()
    if name == "momentum":
        return momentum()
    if name == "adam":
        return adam()
    raise ValueError(name)
