"""Secure aggregation of the local parity sets (paper §VI future work; the
port of ``repro.core.secure_agg``).

The server only needs the *global* parity set, the sum of the local ones,
so each local set can be hidden by pairwise masks [Bonawitz et al. 2016]:
every client pair (i, j) shares a mask M_ij; client min(i, j) adds it and
client max(i, j) subtracts it, so the masks cancel in the server's sum
while each upload on its own is noise.

Each pair's mask is a function of the pair alone.  The port draws it with
a ``torch.Generator`` on the parity's device, seeded from
``np.random.SeedSequence((session_seed, lo, hi))``, where the reference
folds both ids into a ``jax.random`` session key: the same seed gives other
numbers.  A caller that must reproduce the reference's masks draws them
with the reference and hands them over (`repro_torch.carry.
secure_masks_from_reference`).  The CPU and CUDA generators draw different
numbers too, so a secure parity set is not bit-identical across devices.

Masking is exact only up to rounding: in float32 ``(x + M) - M`` is not
``x``.  `rounding_tolerance` bounds how far the masked global parity set
may sit from the unmasked one.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.encoding import LocalParity

#: float32 machine epsilon
EPS32 = float(np.finfo(np.float32).eps)


def pairs(n_clients: int) -> list[tuple[int, int]]:
    """Every client pair (lo, hi), lo < hi, in lexicographic order: the
    order of the rows of a carried-over mask stack."""
    return [(i, j) for i in range(n_clients) for j in range(i + 1, n_clients)]


def pair_index(lo: int, hi: int, n_clients: int) -> int:
    """Row of pair (lo, hi), lo < hi, in `pairs(n_clients)`."""
    return lo * n_clients - lo * (lo + 1) // 2 + (hi - lo - 1)


def pair_seed(session_seed: int, lo: int, hi: int) -> int:
    """The 64-bit generator seed of pair (lo, hi), lo < hi."""
    state = np.random.SeedSequence(
        (int(session_seed), int(lo), int(hi))).generate_state(1, np.uint64)
    return int(state[0])


def draw_pair_mask(session_seed: int, lo: int, hi: int,
                   parity: LocalParity, scale: float = 1.0) -> LocalParity:
    """Mask M_lo,hi shaped like `parity`, iid N(0, scale^2), on its device."""
    gen = torch.Generator(device=parity.x.device)
    gen.manual_seed(pair_seed(session_seed, lo, hi))

    def normal(t):
        return torch.randn(t.shape, generator=gen, dtype=t.dtype,
                           device=t.device) * scale
    return LocalParity(x=normal(parity.x), y=normal(parity.y))


def _pair_mask(session_seed, lo, hi, n_clients, parity, scale,
               pair_masks) -> LocalParity:
    if pair_masks is None:
        return draw_pair_mask(session_seed, lo, hi, parity, scale)
    k = pair_index(lo, hi, n_clients)
    return LocalParity(x=pair_masks[0][k] * scale, y=pair_masks[1][k] * scale)


def _check_masks(pair_masks, n_clients: int, parity: LocalParity) -> None:
    if pair_masks is None:
        return
    n_pairs = n_clients * (n_clients - 1) // 2
    mx, my = pair_masks
    want_x = (n_pairs,) + tuple(parity.x.shape[-2:])
    want_y = (n_pairs,) + tuple(parity.y.shape[-2:])
    if tuple(mx.shape) != want_x or tuple(my.shape) != want_y:
        raise ValueError(
            f"secure masks have shapes {tuple(mx.shape)} and "
            f"{tuple(my.shape)}; {n_clients} clients need one mask a pair: "
            f"{want_x} and {want_y}")


def mask_parity(session_seed: int, client_id: int, n_clients: int,
                parity: LocalParity, scale: float = 1.0, *,
                pair_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> LocalParity:
    """The client's masked upload (what the server may see): its parity
    plus M_ij for every other client j > i, minus M_ji for every j < i,
    added in the order of j, as the reference adds them.

    `pair_masks` = (x masks (P, u, q), y masks (P, u, c)), one row a pair
    in `pairs` order, replaces the port's own draws (unit scale; `scale`
    multiplies them)."""
    _check_masks(pair_masks, n_clients, parity)
    x, y = parity.x, parity.y
    for other in range(n_clients):
        if other == client_id:
            continue
        lo, hi = min(client_id, other), max(client_id, other)
        m = _pair_mask(session_seed, lo, hi, n_clients, parity, scale,
                       pair_masks)
        sign = 1.0 if client_id < other else -1.0
        x = x + sign * m.x
        y = y + sign * m.y
    return LocalParity(x=x, y=y)


def masked_uploads(session_seed: int, stacked: LocalParity,
                   scale: float = 1.0, *,
                   pair_masks: Optional[Sequence[torch.Tensor]] = None
                   ) -> LocalParity:
    """All n masked uploads of a stacked (n, u, .) `LocalParity`, each the
    `mask_parity` of its client, bit for bit, with each pair's mask drawn
    once: pairs are taken in `pairs` order, and client j meets its pairs
    (0, j), ..., (j - 1, j), (j, j + 1), ... in the order of the other
    client, as `mask_parity` adds them.  Holds the n uploads and one mask
    at a time."""
    n = stacked.x.shape[0]
    one = LocalParity(x=stacked.x[0], y=stacked.y[0])
    _check_masks(pair_masks, n, one)
    ux = [stacked.x[j] for j in range(n)]
    uy = [stacked.y[j] for j in range(n)]
    for lo, hi in pairs(n):
        m = _pair_mask(session_seed, lo, hi, n, one, scale, pair_masks)
        ux[lo] = ux[lo] + m.x
        uy[lo] = uy[lo] + m.y
        ux[hi] = ux[hi] + -1.0 * m.x
        uy[hi] = uy[hi] + -1.0 * m.y
    return LocalParity(x=torch.stack(ux), y=torch.stack(uy))


def secure_aggregate(masked) -> LocalParity:
    """Server-side sum of the masked uploads (a list of `LocalParity`, or
    one stacked (n, u, .)): the pairwise masks cancel, leaving the global
    parity set without revealing any local one."""
    if isinstance(masked, LocalParity):
        return LocalParity(x=masked.x.sum(dim=0), y=masked.y.sum(dim=0))
    return LocalParity(x=torch.stack([p.x for p in masked]).sum(dim=0),
                       y=torch.stack([p.y for p in masked]).sum(dim=0))


def rounding_tolerance(n_clients: int, scale: float,
                       parity_abs_max: float) -> float:
    """Tolerance of max |masked global parity - unmasked one| in float32.

    An entry of the masked sum goes through n(n - 1) additions on the
    clients and n - 1 on the server.  Each rounds its result v to nearest,
    an error within half an ulp, of either sign, whose standard deviation
    is at most eps |v| / sqrt(12).  With x = max |x_j| and s the mask
    scale, a client's partial upload after k masks has E[v^2] <= x^2 + k
    s^2, and the server's partial sum after k uploads holds k (n - k)
    uncancelled masks and k parity sets, E[v^2] <= k (n - k) s^2 + k^2 x^2.
    Summed over all additions, sum E[v^2] <= n^3 (s + x)^2, so the error
    of an entry has a standard deviation of at most
    eps n^1.5 (s + x) / sqrt(12).  The tolerance is 4 eps n^1.5 (s + x),
    near 14 of those standard deviations: the largest of millions of
    entries stays far below it, and a mask that failed to cancel (an
    error of order s) far above it.
    """
    n = int(n_clients)
    return 4.0 * EPS32 * n ** 1.5 * (float(scale) + float(parity_abs_max))
