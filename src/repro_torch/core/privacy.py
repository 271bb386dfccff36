"""Privacy budget of sharing local parity data (paper Appendix F).

A NumPy copy of ``repro.core.privacy``: bit-identical on the same input.

For Gaussian G_j, sharing u parity rows leaks at most

    eps_j = 1/2 * log2(1 + u / f^2(X^_j))      bits   (eq. 62)

under eps-mutual-information differential privacy, where

    f(X^) = min_{k2 in [q]} sqrt( sum_{k1} |x_{k1}(k2)|^2
                                  - max_{k3} |x_{k3}(k2)|^2 ).

Intuition: features whose mass concentrates on few points are the most
identifiable; f measures the *least* spread-out feature column.
"""
from __future__ import annotations

import numpy as np


def feature_spread(x_hat: np.ndarray) -> float:
    """f(X^) per eq. 62's definition.  x_hat: (l, q)."""
    x = np.asarray(x_hat, dtype=np.float64)
    col_sq = np.sum(x * x, axis=0)            # (q,)
    col_max = np.max(x * x, axis=0)           # (q,)
    vals = col_sq - col_max
    vals = np.maximum(vals, 0.0)
    return float(np.sqrt(np.min(vals)))


def mi_dp_budget(x_hat: np.ndarray, u: int) -> float:
    """eps_j (bits) for sharing u parity rows of x_hat (eq. 62)."""
    f = feature_spread(x_hat)
    if f == 0.0:
        return float("inf")
    return 0.5 * float(np.log2(1.0 + u / (f * f)))
