"""Shared model building blocks (the counterparts of
``repro.models.common``).

Norms and rope compute in float32 and cast back to the input's dtype, as
the reference does.  Initializers draw from an explicit
``torch.Generator``: the same seed gives other numbers than the
reference's ``jax.random`` (carry weights over with
``repro_torch.carry.model_params_from_reference`` where they must agree).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ----------------------------------------------------------------- init utils
def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None):
    """Normal draws scaled by 1/sqrt(shape[0]) (the reference's fan-in,
    which is shape[0] for 3-d weights too), on the generator's device."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * s).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype):
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# ----------------------------------------------------------------- norms
def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


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


def swiglu(x, w1, w3, w2):
    """SwiGLU FFN: (.., D) @ (D,F) gates -> (.., D)."""
    h = F.silu(x @ w1) * (x @ w3)
    return h @ w2
