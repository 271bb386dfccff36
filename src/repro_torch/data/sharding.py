"""Non-IID client data partition (paper §V-A).

The paper sorts the training set by class label, cuts it into n equal
shards, sorts the clients by their expected round time (eq. 15 with the
local minibatch size), and hands shards out in that order — so the slowest
clients own entire classes and 'greedy uncoded' systematically misses them.
A NumPy copy of ``repro.data.sharding``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.delay_model import NodeDelayParams


def sort_and_shard(x: np.ndarray, y: np.ndarray, n_clients: int):
    """Sort by label, split into n equal shards.  Returns list of (x, y)."""
    order = np.argsort(y, kind="stable")
    x, y = x[order], y[order]
    m = (x.shape[0] // n_clients) * n_clients
    xs = np.split(x[:m], n_clients)
    ys = np.split(y[:m], n_clients)
    return list(zip(xs, ys))


def assign_shards_by_speed(shards, nodes: list[NodeDelayParams],
                           minibatch: int):
    """Assign label-sorted shards to clients ordered by expected delay.

    Client order: ascending E[T_j] at load = local minibatch size (paper
    §V-A).  Returns per-client (x, y) in client index order.
    """
    exp_delay = np.array([nd.expected_delay(minibatch) for nd in nodes])
    client_order = np.argsort(exp_delay)
    out = [None] * len(nodes)
    for shard_idx, client in enumerate(client_order):
        out[client] = shards[shard_idx]
    return out


def stack_clients(per_client):
    """List of (x, y) with equal sizes -> (n, l, d), (n, l) arrays."""
    xs = np.stack([c[0] for c in per_client])
    ys = np.stack([c[1] for c in per_client])
    return xs, ys
