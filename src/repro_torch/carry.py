"""Carry the reference's random state over into the port.

The reference draws its random numbers with ``jax.random`` (threefry), the
port with ``torch.Generator``s: the same seed gives different numbers.  To
make both packages compute the same thing, a caller draws with the
reference, hands the draws over as NumPy arrays, and these functions turn
them into the port's tensors:

  * `rff_from_reference`: (Omega, delta) of ``repro.core.rff.rff_params``,
    for ``rff_transform`` or for ``build_experiment(..., rff_draw=...)``
    (the fused_embed path, where the reference's ``Experiment`` draws them
    from ``spec.rff`` itself);
  * `generators_from_reference`: the (n, u, l) stack of generator matrices
    that ``repro.core.schemes.CodedScheme.setup`` draws from its key chain
    (``PRNGKey(fl.seed + 99)``, split client after client), for
    ``build_experiment(..., parity_generators=...)``;
  * `theta_from_reference`: a (q, c) model iterate.

This module imports neither ``jax`` nor ``repro``: the caller does the
drawing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(arr, ndim: int, what: str, device) -> torch.Tensor:
    a = np.array(arr, dtype=np.float32, copy=True)
    if a.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim} dimensions, "
                         f"got shape {a.shape}")
    return torch.from_numpy(a).to(resolve_device(device))


def rff_from_reference(omega, delta, device=None):
    """(Omega (d, q), delta (q,)) as float32 tensors on `device`."""
    om = _tensor(omega, 2, "omega", device)
    de = _tensor(delta, 1, "delta", device)
    if de.shape[0] != om.shape[1]:
        raise ValueError(f"delta has {de.shape[0]} entries, omega "
                         f"{om.shape[1]} columns")
    return om, de


def generators_from_reference(g_stack, device=None) -> torch.Tensor:
    """The (n, u, l) generator stack as a float32 tensor on `device`."""
    return _tensor(g_stack, 3, "generator stack", device)


def theta_from_reference(theta, device=None) -> torch.Tensor:
    """A (q, c) model iterate as a float32 tensor on `device`."""
    return _tensor(theta, 2, "theta", device)
