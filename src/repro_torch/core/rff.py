"""Distributed kernel embedding via random Fourier features (paper §III-A).

Every client derives (Omega, delta) from a *shared pseudo-random seed*
(Remark 2), so the server never ships the q frequency vectors.  The port
draws them from a CPU ``torch.Generator`` seeded with ``cfg.seed`` and then
moves them to the device, so the draw is the same on either device.  It is
not the reference's draw (``jax.random`` is another generator): to compute
what the reference computes, carry its (Omega, delta) over with
``repro_torch.carry.rff_from_reference``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.config import RFFConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def rff_params(cfg: RFFConfig, d: int, device=None):
    """Sample (Omega, delta) for the RBF kernel (paper eq. 17/18).

    Omega_s ~ N(0, I_d / sigma^2), delta_s ~ Uniform[0, 2*pi).
    Deterministic in cfg.seed — this is the shared-seed mechanism.
    """
    gen = torch.Generator().manual_seed(cfg.seed)
    omega = torch.randn((d, cfg.q), generator=gen) / cfg.sigma
    delta = torch.rand((cfg.q,), generator=gen) * (2.0 * math.pi)
    dev = resolve_device(device)
    return omega.to(dev), delta.to(dev)


def rff_transform(x, omega, delta):
    """phi(X) = sqrt(2/q) cos(X Omega + delta): (m, d) -> (m, q), through
    the ``rff_embed`` kernel on a CUDA tensor."""
    return ops.rff_embed(x, omega, delta)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def median_sigma(x, n_pairs: int = 2000, seed: int = 0) -> float:
    """Median-pairwise-distance heuristic for the RBF bandwidth sigma.

    The paper fixes (sigma, q) = (5, 2000) for 784-dim MNIST; for other
    feature scales this heuristic reproduces that operating point.
    """
    x = _host(x)
    if x.shape[0] < 2:
        raise ValueError(
            f"median_sigma needs at least 2 points, got {x.shape[0]}")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, x.shape[0], size=(n_pairs, 2))
    # self-pairs have distance exactly 0 and bias the median low at small
    # n_pairs — redraw the second index until every pair is distinct
    while True:
        self_pairs = idx[:, 0] == idx[:, 1]
        if not self_pairs.any():
            break
        idx[self_pairs, 1] = rng.integers(0, x.shape[0],
                                          size=int(self_pairs.sum()))
    d = np.linalg.norm(x[idx[:, 0]] - x[idx[:, 1]], axis=1)
    return float(np.median(d))


def suggest_lr(x_hat, target: float = 1.8, iters: int = 30,
               seed: int = 0) -> float:
    """lr ~= target / lambda_max( X^T X / m ) via power iteration (NumPy,
    on the host, as the reference computes it)."""
    x = _host(x_hat)
    m, q = x.shape
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(q,)).astype(np.float64)
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = x.T @ (x @ v) / m
        lam = float(np.linalg.norm(w))
        v = w / max(lam, 1e-12)
    return target / max(lam, 1e-12)
