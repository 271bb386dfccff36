"""Shared model building blocks (the counterparts of
``repro.models.common``).

Norms and rope compute in float32 and cast back to the input's dtype, as
the reference does; the cross-entropy is taken in float32.  Initializers
draw from an explicit ``torch.Generator``: the same seed gives other
numbers than the reference's ``jax.random`` (carry weights over with
``repro_torch.carry.model_params_from_reference`` where they must agree).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ----------------------------------------------------------------- init utils
class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the ``meta`` device (which
    has none): the initializers given it draw nothing and return tensors
    of their shapes and dtypes without storage."""

    device = torch.device("meta")


def generator(seed: int, device=None):
    """A ``torch.Generator`` on `device` (default the CPU) seeded with
    `seed`, or a `MetaGenerator` where `device` is ``meta``."""
    dev = torch.device(device or "cpu")
    if dev.type == "meta":
        return MetaGenerator()
    return torch.Generator(device=dev).manual_seed(seed)


def _randn(gen, shape):
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def dense_init(gen, shape, dtype, scale: float | None = None):
    """Normal draws scaled by 1/sqrt(shape[0]) (the reference's fan-in,
    which is shape[0] for 3-d weights too), on the generator's device."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    return (_randn(gen, shape) * s).to(dtype)


def embed_init(gen, shape, dtype):
    return (_randn(gen, shape) * 0.02).to(dtype)


def frozen_params(tensors: dict) -> nn.ParameterDict:
    """A weight group as a ParameterDict of frozen parameters (keys in
    sorted order, as ``nn.ParameterDict`` keeps a plain dict's)."""
    return nn.ParameterDict({k: nn.Parameter(t, requires_grad=False)
                             for k, t in tensors.items()})


# ----------------------------------------------------------------- norms
def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight + bias).to(x.dtype)


# ----------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x, positions, theta: float, freqs=None):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S) int.

    The split-halves rotation, in float32, cast back to x's dtype.
    `freqs` is ``rope_freqs(hd, theta)`` already on x's device, if the
    caller holds it: copying it from the host every call would
    synchronize the device each time."""
    hd = x.shape[-1]
    if freqs is None:
        freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    if x.ndim == ang.ndim + 1:                              # head axis present
        ang = ang[..., None, :]                             # (..., S, 1, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, device=None):
    """(seq, d) float32: sines of the first d/2 frequencies, then cosines."""
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2.0 * i / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


# ----------------------------------------------------------------- losses
def softmax_cross_entropy(logits, labels, mask=None):
    """logits: (..., V) any float dtype; labels int (...); mask (...) float.

    Float32 logsumexp minus the label's logit (a gather: the reference
    picks it with an iota mask only to keep XLA's vocab sharding local);
    the mean over positions, or the masked mean over max(sum(mask), 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def swiglu(x, w1, w3, w2):
    """SwiGLU FFN: (.., D) @ (D,F) gates -> (.., D)."""
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2
