"""Synthetic benchmark datasets.

MNIST / Fashion-MNIST are not downloadable in this container, so the
experiment drivers use a statistically matched stand-in: a c-class Gaussian
mixture in R^d with class means drawn on a sphere, features normalized to
[0, 1] exactly as the paper normalizes pixel intensities.  The non-IID
partition (sort-by-label + shard) and every wall-clock quantity are
unaffected by this substitution.  A NumPy copy of
``repro.data.synthetic``: the same seed gives the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Dataset:
    x_train: np.ndarray     # (m, d) in [0, 1]
    y_train: np.ndarray     # (m,) int labels
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int

    def one_hot(self, y: np.ndarray) -> np.ndarray:
        out = np.zeros((y.shape[0], self.n_classes), np.float32)
        out[np.arange(y.shape[0]), y] = 1.0
        return out


def synthetic_classification(m_train: int = 12000, m_test: int = 2000,
                             d: int = 784, n_classes: int = 10,
                             class_sep: float = 2.2, intra_dim: int = 24,
                             seed: int = 0) -> Dataset:
    """MNIST-like task: c Gaussian clusters on low-dim manifolds in R^d.

    class_sep controls difficulty; with the defaults a linear model reaches
    ~85-90% and an RBF-kernel (RFF) model a few points more — mirroring the
    MNIST linear-vs-kernel gap the paper exploits.
    """
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(n_classes, d))
    means *= class_sep / np.linalg.norm(means, axis=1, keepdims=True)
    # shared low-rank within-class covariance factors (nonlinear structure)
    factors = rng.normal(size=(n_classes, d, intra_dim)) / np.sqrt(d)

    def sample(n):
        y = rng.integers(0, n_classes, size=n)
        z = rng.normal(size=(n, intra_dim))
        x = means[y] + np.einsum("nij,nj->ni", factors[y], z)
        # mild class-dependent nonlinearity so the RBF kernel has an edge
        x = x + 0.35 * np.tanh(2.0 * x) * (1.0 + 0.1 * y[:, None])
        x += 0.25 * rng.normal(size=x.shape)
        return x.astype(np.float32), y.astype(np.int64)

    x_tr, y_tr = sample(m_train)
    x_te, y_te = sample(m_test)
    # normalize features to [0, 1] using train stats (paper §V-A)
    lo = x_tr.min(axis=0, keepdims=True)
    hi = x_tr.max(axis=0, keepdims=True)
    span = np.maximum(hi - lo, 1e-6)
    x_tr = (x_tr - lo) / span
    x_te = np.clip((x_te - lo) / span, 0.0, 1.0)
    return Dataset(x_tr, y_tr, x_te, y_te, n_classes)
