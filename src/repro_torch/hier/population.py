"""Chunked/streamed population state of the hierarchical tier (the port of
``repro.hier.population``).

Three facilities, all O(block) memory, so a population of n = 1e5-1e6
clients never materializes an O(n) dense intermediate:

  * `population_delay_arrays` — the `delay_model.mec_network` +
    `scale_tau` deployment as stacked ``(n,)`` float64 arrays (the
    `stack_node_params` layout), value-identical to building the n
    `NodeDelayParams` objects; `nodes_for_range` materializes node objects
    only for the shard/stripe being processed.  NumPy, the reference's
    code, bit-identical to it.
  * `two_step_allocate_chunked` — the block-by-block variant of
    `load_allocation.two_step_allocate_vectorized`: step 1 runs the same
    fixed-iteration golden-section program (`_vec_optimal_loads`, torch
    float64 on the experiment's device) one node block at a time, and the
    step-2 bracket/bisection totals are accumulated through a fixed-stripe
    sequential fold on the host (a strict left fold down each global
    `SUM_STRIPE`-wide stripe, stripe sums folded in global stripe order).
  * `generate_trace_chunked` / `iter_trace_chunks` — client-chunked
    channel-trace generation: clients are keyed in fixed-width stripes,
    each stripe an independent ``(seed, stripe_index)``-keyed stream, so
    any block partition of the client axis reproduces the same trace.
    NumPy over `repro_torch.net.trace.generate_trace`, bit-identical to
    the reference's.

Bit-equality contract: the chunked solver and the chunked trace generator
return BIT-IDENTICAL results for every block size, the single-block call
included.  For the solver this rests on two points:

  * a block's per-node arithmetic does not depend on the block (each
    node's row of `_vec_optimal_loads` reads only that node), and the
    transmission-grid widths are population-wide static caps;
  * the total expected return is never a ``torch.sum`` (whose association
    depends on the length and the device): each block's returns are read
    back to the host, where each absolute `SUM_STRIPE`-wide stripe is
    summed by a strict left fold (NumPy, vectorized across stripes,
    serial down the stripe) and the stripe sums are folded into the total
    in global stripe order.  Block boundaries are rounded up to stripe
    multiples, so every stripe lives inside one block at fixed slots;
    dead padding nodes (cap 0, erasure 0) contribute +0.0 at every
    deadline below 2 s (their round trip).  That is the reference's fold,
    step for step, so the port's t* agrees with the reference's chunked
    solver to the elementwise float64 rounding of ``exp``/``pow``
    (bit-equal where those agree).

The bracket and bisection run in Python floats, as the reference's do;
each evaluation reads one block of returns back per block.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import load_allocation
from repro_torch.core.delay_model import (NodeDelayParams, mec_network,
                                          packet_bits, scale_tau,
                                          stack_node_params)
from repro_torch.device import resolve_device
from repro_torch.net.trace import NetworkTrace, generate_trace

#: default node-block width of the chunked solver (solver memory is
#: O(block * pieces * transmission-grid columns), not O(n))
DEFAULT_BLOCK = 2048

#: fixed client-stripe width of the chunked trace generator; part of the
#: RNG layout, so changing it changes trace realizations (block sizes
#: never do)
TRACE_STRIPE = 1024

#: fixed stripe width of the solver's sequential total fold; part of the
#: floating-point association, so changing it perturbs totals at the
#: rounding level (block sizes, which are rounded up to a multiple of
#: this, never do)
SUM_STRIPE = 128


# --------------------------------------------------------------- deployment
def population_delay_arrays(fl_cfg, d_scalars_per_point: int,
                            payload_scalars: int | None = None) -> dict:
    """The `mec_network` deployment as stacked ``(n,)`` float64 arrays.

    Value-identical to ``stack_node_params([scale_tau(nd, payload) for nd
    in mec_network(fl_cfg, d_scalars_per_point)])`` — same RNG
    (``default_rng(fl_cfg.seed)``), same shuffle order, same per-element
    arithmetic — without constructing n Python node objects.
    `payload_scalars` is the per-round model/gradient packet size in
    scalars (defaults to `d_scalars_per_point`, the flat engine's q*c).
    """
    rng = np.random.default_rng(fl_cfg.seed)
    n = fl_cfg.n_clients
    rate_factors = fl_cfg.rate_decay ** np.arange(n)
    mac_factors = fl_cfg.mac_decay ** np.arange(n)
    rng.shuffle(rate_factors)
    rng.shuffle(mac_factors)
    rates = fl_cfg.max_rate_bps * rate_factors
    macs = fl_cfg.max_mac_rate * mac_factors
    payload = packet_bits(
        fl_cfg, d_scalars_per_point if payload_scalars is None
        else payload_scalars)
    tau = (1.0 / rates) * payload
    full = lambda v: np.full(n, v, np.float64)
    return {
        "mu": (macs / float(d_scalars_per_point)).astype(np.float64),
        "alpha": full(fl_cfg.alpha),
        "tau_down": tau.astype(np.float64),
        "tau_up": tau.astype(np.float64),
        "p_down": full(fl_cfg.p_erasure),
        "p_up": full(fl_cfg.p_erasure),
    }


def nodes_for_range(prm: dict, lo: int, hi: int) -> list[NodeDelayParams]:
    """Materialize `NodeDelayParams` objects for clients [lo, hi) only.

    Symmetric entries (tau_up == tau_down, p_up == p_down) come back as
    reciprocal-link nodes (tau_up/p_up left None), matching what
    `mec_network` builds, so downstream symmetric fast paths still fire.
    """
    out = []
    for j in range(lo, hi):
        sym = (prm["tau_up"][j] == prm["tau_down"][j]
               and prm["p_up"][j] == prm["p_down"][j])
        out.append(NodeDelayParams(
            mu=float(prm["mu"][j]), alpha=float(prm["alpha"][j]),
            tau=float(prm["tau_down"][j]), p=float(prm["p_down"][j]),
            tau_up=None if sym else float(prm["tau_up"][j]),
            p_up=None if sym else float(prm["p_up"][j])))
    return out


def population_nodes(fl_cfg, d_scalars_per_point: int, lo: int,
                     hi: int) -> list[NodeDelayParams]:
    """Nodes [lo, hi) of the scaled `mec_network` deployment
    (`population_delay_arrays` + `nodes_for_range`)."""
    return nodes_for_range(
        population_delay_arrays(fl_cfg, d_scalars_per_point), lo, hi)


def _oracle_nodes(fl_cfg, d_scalars_per_point: int) -> list[NodeDelayParams]:
    """The flat engine's node list (test oracle for the array path)."""
    payload = packet_bits(fl_cfg, d_scalars_per_point)
    return [scale_tau(nd, payload)
            for nd in mec_network(fl_cfg, d_scalars_per_point)]


def return_prob(prm: dict, lo: int, hi: int, t: float,
                loads) -> np.ndarray:
    """Vectorized P(T_j <= t) at per-client loads, clients [lo, hi).

    The symmetric-link `NodeDelayParams.cdf` (paper eq. 42 / Theorem 1)
    over stacked arrays: one shared transmission grid up to the
    population's largest per-node cap, masked per node.  Values agree with
    the per-node scalar cdf to float tolerance; clients with load <= 0
    report the pure-communication probability (callers zero them out).
    """
    tau = prm["tau_down"][lo:hi]
    p = prm["p_down"][lo:hi]
    mu = prm["mu"][lo:hi]
    al = prm["alpha"][lo:hi]
    if not (np.array_equal(prm["p_down"][lo:hi], prm["p_up"][lo:hi])
            and np.array_equal(prm["tau_down"][lo:hi],
                               prm["tau_up"][lo:hi])):
        raise NotImplementedError(
            "return_prob covers the paper's reciprocal links only; "
            "asymmetric populations go through NodeDelayParams.cdf")
    ld = np.asarray(loads, np.float64)
    v_m = np.floor(t / tau - 1e-12).astype(np.int64)
    tail = np.where(
        p > 0.0,
        2 + np.ceil(-14.0 / np.log10(np.maximum(p, 1e-300))) + 10,
        2.0).astype(np.int64)
    cap = np.minimum(v_m, tail)
    v_hi = int(max(2, cap.max())) if cap.size else 2
    v = np.arange(2, v_hi + 1, dtype=np.float64)              # (V,)
    h = (v - 1.0) * (1.0 - p[:, None]) ** 2 * p[:, None] ** (v - 2.0)
    det = np.where(ld > 0.0, ld / mu, 0.0)
    slack = t - det[:, None] - tau[:, None] * v
    ok = (v[None, :] <= cap[:, None]) & (slack > 0.0)
    rate = np.where(ld > 0.0, al * mu / np.maximum(ld, 1e-300), 0.0)
    inner = np.where(ld[:, None] > 0.0,
                     1.0 - np.exp(-rate[:, None] * np.maximum(slack, 0.0)),
                     1.0)
    out = np.minimum(np.sum(np.where(ok, h * inner, 0.0), axis=1), 1.0)
    return np.where((cap >= 2) & (t > 2.0 * tau), out, 0.0)


# ----------------------------------------------------------- chunked solver
def _block_grids(p_d, p_u, tau_d, tau_u, *, sym: bool, v_cap: int,
                 vd_cap: int, vu_cap: int):
    """The transmission grids (h, comm) of one node block, (B, K) each.

    Grid widths are STATIC population-wide caps (from the whole
    population's largest erasure probabilities), so every block, and every
    block partition, runs the same per-node arithmetic.
    """
    if sym:
        v = torch.arange(2, v_cap + 1, dtype=p_d.dtype, device=p_d.device)
        h = (v - 1.0) * (1.0 - p_d[:, None]) ** 2 * p_d[:, None] ** (v - 2.0)
        return h, tau_d[:, None] * v
    vd = torch.arange(1, vd_cap + 1, dtype=p_d.dtype, device=p_d.device)
    vu = torch.arange(1, vu_cap + 1, dtype=p_u.dtype, device=p_u.device)
    b = p_d.shape[0]
    h_d = (1.0 - p_d[:, None]) * p_d[:, None] ** (vd - 1.0)
    h_u = (1.0 - p_u[:, None]) * p_u[:, None] ** (vu - 1.0)
    h = (h_d[:, :, None] * h_u[:, None, :]).reshape(b, -1)
    comm = ((tau_d[:, None] * vd)[:, :, None]
            + (tau_u[:, None] * vu)[:, None, :]).reshape(b, -1)
    return h, comm


def _stack_blocks(prm: dict, caps: np.ndarray, block_size: int):
    """Pad the population with dead tail nodes and reshape to blocks.

    Dead nodes (cap 0, erasure 0) contribute +0.0 to the sequential total
    at deadlines below their 2 s round trip, so trailing padding changes
    no bit of any partition's result there.
    """
    n = caps.shape[0]
    n_blocks = -(-n // block_size)
    pad = n_blocks * block_size - n

    def padded(arr, fill):
        return np.concatenate(
            [np.asarray(arr, np.float64), np.full(pad, fill, np.float64)]
        ).reshape(n_blocks, block_size)
    return (padded(prm["mu"], 1.0), padded(prm["alpha"], 1.0),
            padded(prm["tau_down"], 1.0), padded(prm["tau_up"], 1.0),
            padded(prm["p_down"], 0.0), padded(prm["p_up"], 0.0),
            padded(caps, 0.0))


def _stripe_fold(rets: np.ndarray) -> float:
    """The total of the padded returns in the fixed association: a strict
    left fold down each `SUM_STRIPE`-wide stripe (vectorized across the
    stripes), then the stripe sums folded in stripe order."""
    rows = rets.reshape(-1, SUM_STRIPE)
    sums = np.zeros(rows.shape[0], np.float64)
    for j in range(SUM_STRIPE):
        sums = sums + rows[:, j]
    total = 0.0
    for s in sums.tolist():
        total = total + s
    return total


def two_step_allocate_chunked(clients=None, client_caps=None,
                              server: NodeDelayParams | None = None,
                              u_max: float = 0.0, m: float = 0.0,
                              tol: float = 1e-6,
                              t_hi: float | None = None,
                              *, prm: dict | None = None,
                              block_size: int = DEFAULT_BLOCK,
                              n_golden: int = 52,
                              n_golden_search: int = 28,
                              n_bracket: int = 60,
                              n_bisect: int = 48,
                              device=None
                              ) -> load_allocation.Allocation:
    """Block-by-block two-step load allocation (paper eq. 23-27).

    Same contract as `two_step_allocate_vectorized` — the same per-node
    step-1 program, the same bracket doubling + fixed-iteration bisection
    over t — but step 1 runs one `block_size` node block at a time, in
    float64 on `device` (the GPU unless the caller asks for another), so
    solver memory is O(block), not O(n).  Clients come in either as a
    `NodeDelayParams` list + `client_caps` (the flat call shape) or
    pre-stacked via ``prm`` (a `stack_node_params`-layout dict;
    ``client_caps`` then may be a scalar cap).  ``server=None`` models the
    paper's reliable-MEC assumption (u_max always returns).

    Results are bit-identical for EVERY ``block_size`` (rounded up to a
    `SUM_STRIPE` multiple so the total fold's stripes stay block-aligned);
    see the module docstring.  `tol` only documents the contract: the
    iteration counts are fixed.
    """
    if prm is None:
        prm = stack_node_params(list(clients))
    n = prm["mu"].shape[0]
    caps = np.asarray(client_caps, np.float64)
    if caps.ndim == 0:
        caps = np.full(n, float(caps), np.float64)
    if caps.shape != (n,):
        raise ValueError(f"caps shape {caps.shape} != ({n},)")
    if float(np.sum(caps)) + float(u_max) < float(m) - 1e-9:
        raise ValueError("infeasible: sum of caps + u_max < m")
    target = float(m)
    if server is not None:
        sprm = stack_node_params([server])
        prm = {k: np.concatenate([prm[k], sprm[k]]) for k in prm}
        caps = np.concatenate([caps, [float(u_max)]])
    else:
        target -= float(u_max)      # P(T_C <= t) = 1: u_max always returns
    if block_size < 1:
        raise ValueError(f"block_size={block_size} must be >= 1")
    n_nodes = prm["mu"].shape[0]
    # stripe-aligned blocks: the partition independence of the total fold
    # needs every SUM_STRIPE-wide absolute stripe inside one block
    block_size = -(-min(block_size, n_nodes) // SUM_STRIPE) * SUM_STRIPE
    sym = (np.array_equal(prm["p_down"], prm["p_up"])
           and np.array_equal(prm["tau_down"], prm["tau_up"]))
    grid_caps = dict(
        sym=sym, v_cap=load_allocation._tail_v_cap(float(prm["p_down"].max())),
        vd_cap=load_allocation._geo_tail_cap(float(prm["p_down"].max())),
        vu_cap=load_allocation._geo_tail_cap(float(prm["p_up"].max())))
    dev = resolve_device(device)
    blocks = [torch.as_tensor(b, device=dev)
              for b in _stack_blocks(prm, caps, block_size)]

    def block_step1(t: float, golden: int):
        """(loads, returns) of every padded node at deadline t, one block
        after another; each block's grids are built and dropped in turn."""
        t_dev = torch.tensor(t, dtype=torch.float64, device=dev)
        loads, rets = [], []
        for i in range(blocks[0].shape[0]):
            mu, al, td, tu, pd, pu, cp = (b[i] for b in blocks)
            h, comm = _block_grids(pd, pu, td, tu, **grid_caps)
            ld, rt = load_allocation._vec_optimal_loads(
                mu, al, td, h, comm, cp, t_dev, v_cap=grid_caps["v_cap"],
                n_golden=golden)
            loads.append(ld)
            rets.append(rt)
        return torch.cat(loads), torch.cat(rets)

    def total(t: float) -> float:
        _, rets = block_step1(t, n_golden_search)
        return _stripe_fold(rets.cpu().numpy())

    # the reference's float arithmetic exactly: doubling, 0.5*(lo+hi)
    # midpoints, >= target decisions
    hi = float(t_hi if t_hi is not None else 1.0)
    k = 0
    while total(hi) < target and k < n_bracket:
        hi *= 2.0
        k += 1
    lo = 0.0
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        if total(mid) >= target:
            hi = mid
        else:
            lo = mid
    t_star = hi
    loads, rets = block_step1(t_star, n_golden)
    loads = loads.cpu().numpy()[:n_nodes]
    rets = rets.cpu().numpy()[:n_nodes]
    if server is None:
        u_star, coded_ret = float(u_max), float(u_max)
    else:
        loads, u_star = loads[:-1], float(loads[-1])
        rets, coded_ret = rets[:-1], float(rets[-1])
    return load_allocation.Allocation(
        t_star=t_star, loads=loads, u_star=u_star, returns=rets,
        coded_return=coded_ret)


# ------------------------------------------------------------ chunked trace
def _trace_stripe(nodes_or_prm, profile, rounds: int, seed: int,
                  stripe_idx: int, lo: int, hi: int) -> NetworkTrace:
    """One full stripe's trace from its (seed, stripe_index)-keyed stream."""
    if isinstance(nodes_or_prm, dict):
        sub = nodes_for_range(nodes_or_prm, lo, hi)
    else:
        sub = list(nodes_or_prm[lo:hi])
    rng = np.random.default_rng((seed, stripe_idx))
    return generate_trace(sub, profile, rounds, rng)


def _concat(parts: list, profile) -> NetworkTrace:
    """The column-wise concatenation of ``(trace, a, b)`` client slices."""
    def cat(field):
        return np.concatenate([getattr(t, field)[:, a:b]
                               for t, a, b in parts], axis=1)
    return NetworkTrace(mu_mult=cat("mu_mult"), tau_mult=cat("tau_mult"),
                        p_down=cat("p_down"), p_up=cat("p_up"),
                        active=cat("active"), profile=profile)


def _population_size(nodes_or_prm) -> int:
    return (nodes_or_prm["mu"].shape[0] if isinstance(nodes_or_prm, dict)
            else len(nodes_or_prm))


def iter_trace_chunks(nodes_or_prm, profile, rounds: int, *, seed: int,
                      block_size: int, stripe: int = TRACE_STRIPE):
    """Yield ``(lo, hi, NetworkTrace)`` client blocks of a population trace.

    Clients are keyed in fixed-width stripes: stripe s draws from
    ``default_rng((seed, s))`` with the standard fixed per-dynamic layout
    of `generate_trace`.  A block materializes only the stripes it
    overlaps (memory O(rounds * (block_size + stripe))), and any block
    partition yields bit-identical values — the stripe width is part of
    the RNG layout, the block size never is.  `nodes_or_prm` is either a
    `NodeDelayParams` list or a `population_delay_arrays` dict.
    """
    if block_size < 1:
        raise ValueError(f"block_size={block_size} must be >= 1")
    if stripe < 1:
        raise ValueError(f"stripe={stripe} must be >= 1")
    n = _population_size(nodes_or_prm)
    for lo in range(0, n, block_size):
        hi = min(lo + block_size, n)
        parts = []
        for s in range(lo // stripe, (hi - 1) // stripe + 1):
            s_lo, s_hi = s * stripe, min((s + 1) * stripe, n)
            tr = _trace_stripe(nodes_or_prm, profile, rounds, seed,
                               s, s_lo, s_hi)
            parts.append((tr, max(lo, s_lo) - s_lo, min(hi, s_hi) - s_lo))
        yield lo, hi, _concat(parts, profile)


def generate_trace_chunked(nodes_or_prm, profile, rounds: int, *,
                           seed: int, block_size: int | None = None,
                           stripe: int = TRACE_STRIPE) -> NetworkTrace:
    """Assembled population trace (the dense one-shot of this tier).

    ``block_size=None`` (or >= n) generates in one block; smaller blocks
    stream through `iter_trace_chunks` and concatenate — bit-identical
    either way.  For n <= ``stripe`` the result is also bit-identical to
    the flat ``generate_trace(nodes, profile, rounds,
    default_rng((seed, 0)))`` (a single stripe IS that call).
    """
    n = _population_size(nodes_or_prm)
    if block_size is None:
        block_size = max(1, n)
    chunks = [tr for _, _, tr in iter_trace_chunks(
        nodes_or_prm, profile, rounds, seed=seed, block_size=block_size,
        stripe=stripe)]
    return _concat([(t, 0, t.n) for t in chunks], profile)
