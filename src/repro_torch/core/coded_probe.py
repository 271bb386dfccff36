"""Coded linear-probe head: exact CodedFedL on top of a deep backbone (the
counterpart of ``repro.core.coded_probe``).

The paper's parity-gradient identity is exact only for squared-loss linear
models.  This module applies it to a deep model the way the paper's
future-work section suggests: each client runs the *frozen* backbone over
its local tokens, mean-pools the final hidden states, applies the
shared-seed RFF map, and then the full CodedFedL machinery (private parity
encoding, load allocation, deadline aggregation) trains the linear
readout — every theorem in the paper applies verbatim to this head.

On the card the embedding is the ``rff_embed`` kernel (one launch a
client) and the FL run is the flat engine's coded round (the parity
encode at setup, the masked gradient every round).  The port draws
(Omega, delta) and the parity generators with its own generators; to
follow the reference's draws, carry them over (``rff_draw=``,
``parity_generators=``; see ``repro_torch.carry``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ExperimentSpec, FLConfig, RFFConfig, TrainConfig
from repro_torch.core import rff
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def extract_features(cfg, params, tokens, batch_size: int = 8, device=None):
    """Mean-pooled final hidden states for (N, S) token rows -> (N, D)
    float32 NumPy; `params` (a `Transformer`) is moved to `device` (the
    GPU unless the caller passes another)."""
    dev = resolve_device(device)
    params.to(dev)
    tokens = torch.as_tensor(np.asarray(tokens))
    feats = []
    with torch.no_grad():
        for i in range(0, tokens.shape[0], batch_size):
            h = transformer.hidden_states(
                cfg, params, {"tokens": tokens[i:i + batch_size].to(dev)})
            feats.append(h.mean(dim=1).float().cpu().numpy())
    return np.concatenate(feats, axis=0).astype(np.float32)


def probe_head(feats, client_labels, n_classes: int,
               fl_cfg: FLConfig | None = None, rff_q: int = 256,
               iterations: int = 100, scheme: str = "coded", device=None,
               rff_draw=None, parity_generators=None):
    """The FL half of `coded_probe_training` on (n, l, D) pooled features:
    the shared-seed RFF map, then exact CodedFedL on the linear head.
    Returns (FedResult, (omega, delta))."""
    dev = resolve_device(device)
    feats = np.asarray(feats, dtype=np.float32)
    n, l, _ = feats.shape
    fl = fl_cfg or FLConfig(n_clients=n)
    # shared-seed RFF on the pooled features (paper §III-A)
    sigma = rff.median_sigma(feats.reshape(n * l, -1))
    rcfg = RFFConfig(q=rff_q, sigma=max(sigma, 1e-3))
    if rff_draw is None:
        omega, delta = rff.rff_params(rcfg, feats.shape[-1], device=dev)
    else:
        omega, delta = (torch.as_tensor(a).to(dev) for a in rff_draw)
    xh = torch.stack([rff.rff_transform(torch.from_numpy(feats[j]).to(dev),
                                        omega, delta)
                      for j in range(n)])                    # (n, l, q)
    y = np.eye(n_classes, dtype=np.float32)[client_labels]   # (n, l, C)
    # exact CodedFedL on the linear head
    lr = rff.suggest_lr(xh.reshape(n * l, -1))
    tcfg = TrainConfig(learning_rate=lr,
                       lr_decay_epochs=(int(iterations * 0.6),
                                        int(iterations * 0.85)))
    from repro_torch.api import build_experiment
    exp = build_experiment(
        ExperimentSpec(fl=fl, train=tcfg, rff=rcfg, scheme=scheme), xh, y,
        device=dev, parity_generators=parity_generators)
    res = exp.run(iterations)
    return res, (omega, delta)


def coded_probe_training(cfg, params, client_tokens, client_labels,
                         n_classes: int, fl_cfg: FLConfig | None = None,
                         rff_q: int = 256, iterations: int = 100,
                         scheme: str = "coded", device=None, rff_draw=None,
                         parity_generators=None):
    """Train a CodedFedL linear probe on a frozen backbone.

    client_tokens: (n_clients, l, S) int; client_labels: (n_clients, l).
    Returns (FedResult, (omega, delta)), on `device` (the GPU unless the
    caller passes another).
    """
    n = client_tokens.shape[0]
    # every client extracts features locally (the backbone is frozen/shared)
    feats = np.stack([extract_features(cfg, params, client_tokens[j],
                                       device=device)
                      for j in range(n)])                    # (n, l, D)
    return probe_head(feats, client_labels, n_classes, fl_cfg, rff_q,
                      iterations, scheme, device, rff_draw,
                      parity_generators)
