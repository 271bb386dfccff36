"""A second program for the harness's CPU tests, as a configuration names
it (``"program": "toy"`` -> ``programs/toy.py``): least squares trained
over federated rounds with stragglers, on data made from the seed.

Each round every client returns with its own probability p_j (drawn from
the seed's straggler stream); the server sums the returned clients'
gradients, each reweighted by 1 / p_j, and takes a gradient step.  A block
is K rounds.  Its check replays the same straggler stream in float64
NumPy and compares every round's returned set and theta after every
block.  It runs no hand-written kernel and imports nothing of the port.
"""
from __future__ import annotations

import numpy as np
import torch

#: added to theta after every block: nought in the program as it stands
#: (a test writes a copy with another value to break it)
PERTURB = 0.0


def _data(cfg: dict, traffic: dict, seed: int) -> tuple:
    """(x (n, l, d), y (n, l), p (n,)) of the seed, float64."""
    rng = np.random.default_rng((int(seed), 0))
    n, l, d = int(traffic["n_clients"]), int(cfg["l"]), int(cfg["d"])
    x = rng.standard_normal((n, l, d))
    y = x @ rng.standard_normal(d) + cfg["noise"] * rng.standard_normal(
        (n, l))
    p = np.linspace(cfg["p_min"], 1.0, n)
    return x, y, p


def _stragglers(seed: int) -> np.random.Generator:
    return np.random.default_rng((int(seed), 1))


class Toy:
    kernels: dict = {}
    ops = None

    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 dev: torch.device, *, traced: bool, checked: int):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        x, y, self.p = _data(cfg, traffic, seed)
        self.x = torch.tensor(x, dtype=torch.float32, device=dev)
        self.y = torch.tensor(y, dtype=torch.float32, device=dev)
        self.w = torch.empty(len(self.p), dtype=torch.float32, device=dev)
        self.theta = torch.zeros(x.shape[2], dtype=torch.float32, device=dev)
        self.rng = _stragglers(seed)
        self.K = int(traffic["block_rounds"])
        self.masks, self.thetas = [], []
        self.setup_spans = {}

    def turn(self) -> None:
        pass

    def block(self) -> int:
        n, l, _ = self.x.shape
        for _ in range(self.K):
            mask = self.rng.random(n) < self.p
            self.w.copy_(torch.from_numpy(mask / self.p))
            r = torch.einsum("nld,d->nl", self.x, self.theta) - self.y
            g = torch.einsum("n,nl,nld->d", self.w, r, self.x) / (n * l)
            self.theta = self.theta - self.cfg["lr"] * g
            self.masks.append(mask)
        self.theta = self.theta + PERTURB
        self.thetas.append(self.theta.cpu().numpy())
        return self.K

    def launches(self) -> dict:
        return {}

    def check(self, log) -> tuple[dict, int]:
        masks, thetas = self.masks, self.thetas
        del self.x, self.y, self.w, self.theta
        want_masks, want = replay_thetas(self.cfg, self.traffic, self.seed,
                                         len(thetas), self.K, np.float64)
        gap = max(float(np.linalg.norm(a - b) / np.linalg.norm(b))
                  for a, b in zip(thetas, want))
        diff = int(np.sum(np.asarray(masks) != np.asarray(want_masks)))
        log(f"toy check: {len(thetas)} blocks")
        failed = int(np.sum(~np.asarray(masks).any(axis=1)))
        return {"theta_gap": gap, "returned_diff": diff}, failed

    def fields(self, window: tuple, stretch) -> dict:
        return {}


def replay_thetas(cfg: dict, traffic: dict, seed: int, blocks: int, K: int,
                  dtype) -> tuple:
    """(every round's returned mask, theta after every block) of the plain
    replay in `dtype`."""
    x, y, p = (a.astype(dtype) for a in _data(cfg, traffic, seed))
    rng = _stragglers(seed)
    n, l, d = x.shape
    theta = np.zeros(d, dtype)
    masks, thetas = [], []
    for _ in range(blocks):
        for _ in range(K):
            mask = rng.random(n) < p
            r = np.einsum("nld,d->nl", x, theta) - y
            g = np.einsum("n,nl,nld->d", (mask / p).astype(dtype), r, x) \
                / (n * l)
            theta = theta - dtype(cfg["lr"]) * g
            masks.append(mask)
        thetas.append(theta.copy())
    return masks, thetas


#: ``build(cfg, traffic, seed, dev, *, traced, checked)``
build = Toy


def control(cfg: dict, traffic: dict, seed: int, dev: torch.device, *,
            checked: int) -> dict:
    """The replay in float16, one precision below the program's float32,
    held against the float64 replay over 20 blocks."""
    K = int(traffic["block_rounds"])
    _, got = replay_thetas(cfg, traffic, seed, 20, K, np.float16)
    _, want = replay_thetas(cfg, traffic, seed, 20, K, np.float64)
    gap = max(float(np.linalg.norm(a - b) / np.linalg.norm(b))
              for a, b in zip(got, want))
    return {"theta_gap": gap, "returned_diff": 0}
