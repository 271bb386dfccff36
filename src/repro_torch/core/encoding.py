"""Distributed encoding of local datasets into parity data (paper §III-B/D).

Client j:
  - draws a PRIVATE generator G_j in R^{u x l_j}, entries iid N(0, 1);
  - builds the diagonal weight matrix W_j from the no-return probabilities:
      w_{j,k} = sqrt(1 - P(T_j <= t*))  if point k is in the processed subset
      w_{j,k} = 1                        otherwise (never evaluated locally)
    (paper §III-D: pnr_{j,2} = 1 for unprocessed points);
  - ships (X~_j, Y~_j) = (G_j W_j X^_j, G_j W_j Y_j) to the server.

Server: sums the n local parity sets -> global parity dataset (eq. 20/21).

The generators come from a CPU ``torch.Generator``, one client after
another, and are then moved to the device, so the draw is the same on
either device.  The reference draws them from a ``jax.random`` key chain
instead; ``repro_torch.carry.generators_from_reference`` carries that stack
over where both packages must compute the same thing.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import ops


def generator_matrix(gen: torch.Generator, u: int, l: int) -> torch.Tensor:
    """Private random generator G_j (u, l) with iid N(0, 1) entries, drawn
    on the CPU from `gen`."""
    return torch.randn((u, l), generator=gen)


def generator_stack(seed: int, n: int, u: int, l: int, *,
                    device=None) -> torch.Tensor:
    """(n, u, l) generators of all clients: one CPU generator seeded with
    `seed`, drawn client after client, then moved to `device`."""
    gen = torch.Generator().manual_seed(seed)
    g = torch.stack([generator_matrix(gen, u, l) for _ in range(n)])
    return g.to(device)


def weight_vector(l: int, processed_idx: np.ndarray,
                  p_return: float) -> np.ndarray:
    """Diagonal of W_j (paper §III-D).

    processed_idx: indices of the l*_j points the client will process.
    p_return: P(T_j <= t*) for this client.
    """
    w = np.ones(l, dtype=np.float32)                    # sqrt(pnr=1) = 1
    w[processed_idx] = np.sqrt(1.0 - p_return)          # sqrt(pnr_{j,1})
    return w


@dataclasses.dataclass
class LocalParity:
    x: torch.Tensor    # (u, q), or (n, u, q) stacked
    y: torch.Tensor    # (u, c), or (n, u, c) stacked


def encode_local(g, x_hat, y, w) -> LocalParity:
    """Local parity dataset (X~_j, Y~_j) = (G_j W_j X^_j, G_j W_j Y_j) of
    one client: two ``parity_encode`` launches.

    g: (u, l) generator (`generator_matrix`, or the reference's carried
    over, in place of its key); x_hat: (l, q); y: (l, c); w: (l,).
    """
    return LocalParity(x=ops.parity_encode(g, w, x_hat),
                       y=ops.parity_encode(g, w, y))


def encode_local_batched(g_stack, x_stack, y_stack, w_stack) -> LocalParity:
    """All-clients parity encode: two ``parity_encode_batched`` launches,
    one for the features and one for the labels.

    g_stack: (n, u, l); x_stack: (n, l, q); y_stack: (n, l, c);
    w_stack: (n, l).  Returns stacked LocalParity with x: (n, u, q),
    y: (n, u, c).
    """
    px = ops.parity_encode_batched(g_stack, w_stack, x_stack)
    py = ops.parity_encode_batched(g_stack, w_stack, y_stack)
    return LocalParity(x=px, y=py)


def aggregate_parity_stacked(parity: LocalParity) -> LocalParity:
    """Global parity set from a stacked (n, u, ·) LocalParity (eq. 20)."""
    return LocalParity(x=parity.x.sum(dim=0), y=parity.y.sum(dim=0))


def aggregate_parity(parities: list[LocalParity]) -> LocalParity:
    """Global parity set = sum over the clients' parity sets (eq. 20)."""
    return LocalParity(x=torch.stack([p.x for p in parities]).sum(dim=0),
                       y=torch.stack([p.y for p in parities]).sum(dim=0))
