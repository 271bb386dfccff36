"""The benchmark's traffic generator: every input of a run, from ``--seed``.

A run's inputs are the deployment's data and its random draws: the
synthetic MNIST stand-in (10 classes, 784 features in [0, 1]), split
non-IID by label and by client speed as ``launch/mnist_codedfedl.py``
splits it, the RFF frequencies (Omega, delta), the clients' (n, u, l)
parity generators and the seed of the host generator that draws the
delays.  The large ones
are made on the device, each in a few calls of a ``torch.Generator`` there.
The same seed gives the same inputs; the sizes come from the configuration
and the traffic file alone, so every seed does the same amount of work.
Both the program and the plain reference are handed these same inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from portbench.reference import codedfedl as ref


@dataclasses.dataclass
class Inputs:
    x: torch.Tensor                 # (n, l, d) raw client points
    y: torch.Tensor                 # (n, l, c) one-hot labels
    omega: torch.Tensor             # (d, q)
    delta: torch.Tensor             # (q,)
    gens: Optional[torch.Tensor]    # (n, u, l) parity generators (coded)
    host_seed: int                  # the delay stream's generator seed
    lr: float                       # the learning rate of the run


def sub_seeds(seed: int) -> list[int]:
    """Four independent 63-bit seeds from the run's seed (any size)."""
    words = np.random.SeedSequence(int(seed)).generate_state(4, np.uint64)
    return [int(w) & ((1 << 63) - 1) for w in words]


def synthetic_points(data: dict, m: int, d: int, c: int,
                     gen: torch.Generator, device) -> tuple:
    """(x (m, d) in [0, 1], labels (m,)): c Gaussian clusters on
    low-dimensional manifolds in R^d with a mild class-dependent
    nonlinearity, scaled per feature to [0, 1] as the paper scales pixel
    intensities."""
    k = int(data["intra_dim"])
    kw = dict(generator=gen, device=device)
    means = torch.randn((c, d), **kw)
    means *= data["class_sep"] / torch.linalg.vector_norm(means, dim=1,
                                                          keepdim=True)
    factors = torch.randn((c, d, k), **kw) / math.sqrt(d)
    labels = torch.randint(0, c, (m,), **kw)
    z = torch.randn((m, k), **kw)
    x = means[labels]
    for cls in range(c):
        idx = torch.nonzero(labels == cls).squeeze(1)
        x[idx] += z[idx] @ factors[cls].t()
    x += data["nonlinearity"] * torch.tanh(2.0 * x) * (
        1.0 + 0.1 * labels[:, None].float())
    x += data["noise"] * torch.randn((m, d), **kw)
    lo = x.min(dim=0, keepdim=True).values
    hi = x.max(dim=0, keepdim=True).values
    x = (x - lo) / torch.clamp(hi - lo, min=1e-6)
    return x, labels


def split_by_label_and_speed(x, labels, nodes: list, n: int, l: int, c: int):
    """Sort by label, cut into n shards of l, and hand the shards out in
    the order of the clients' expected round time at load l (paper
    §V-A): the slowest clients own whole classes.  -> (n, l, d), (n, l, c)
    one-hot."""
    order = torch.sort(labels, stable=True).indices
    shards_x = x[order].reshape(n, l, -1)
    shards_y = labels[order].reshape(n, l)
    exp_delay = np.array([nd.expected_delay(l) for nd in nodes])
    client_order = np.argsort(exp_delay)          # shard s -> client
    shard_of = torch.from_numpy(np.argsort(client_order)).to(x.device)
    xs = shards_x[shard_of].contiguous()
    ys = torch.nn.functional.one_hot(shards_y[shard_of], c).float()
    return xs, ys.contiguous()


def make_inputs(cfg: dict, traffic: dict, seed: int, device) -> Inputs:
    """Every input of one run of (configuration, traffic) from `seed`."""
    n, l, d, q, c = (int(traffic["n_clients"]), cfg["l"], cfg["d"],
                     cfg["q"], cfg["c"])
    m = n * l
    s_data, s_rff, s_gen, s_host = sub_seeds(seed)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    x, labels = synthetic_points(cfg["data"], m, d, c,
                                 gen.manual_seed(s_data), dev)
    xs, ys = split_by_label_and_speed(x, labels, ref.nodes_unscaled(cfg, n),
                                      n, l, c)
    del x, labels
    gen.manual_seed(s_rff)
    omega = torch.randn((d, q), generator=gen, device=dev) / cfg["sigma"]
    delta = torch.rand((q,), generator=gen, device=dev) * (2.0 * math.pi)
    gens = None
    if traffic["scheme"] == "coded":
        u = max(1, int(round(cfg["delta"] * m)))
        gens = torch.randn((n, u, l), generator=gen.manual_seed(s_gen),
                           device=dev)
    phi = ref.embed(xs, omega, delta).reshape(m, q)
    lr = ref.learning_rate(phi, cfg["lr_target"], cfg["lr_power_iters"])
    del phi
    return Inputs(x=xs, y=ys, omega=omega, delta=delta, gens=gens,
                  host_seed=s_host, lr=lr)
