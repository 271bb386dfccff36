"""Frozen copy of the port's two-step load allocation
(``repro_torch.core.load_allocation``: the scalar NumPy solver and the
vectorized torch float64 one) for the benchmark's plain reference.

The reference recomputes the deadline t* and the loads with this copy and
holds the program's against them, so a later change to the program's
solver is judged against the solver as it stood when the benchmark was
defined.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from portbench.reference.delay_model import (NodeDelayParams,
                                             stack_node_params)

_INV_PHI = (math.sqrt(5.0) - 1.0) / 2.0


# --------------------------------------------------------------------------
# Lambert W, minor branch W_{-1}:  w e^w = x  for x in (-1/e, 0), w <= -1.
# --------------------------------------------------------------------------
def lambert_w_minus1(x: float) -> float:
    if not (-1.0 / math.e < x < 0.0):
        raise ValueError(f"W_-1 defined on (-1/e, 0); got {x}")
    # initial guess (Corless et al. 1996 asymptotics)
    l1 = math.log(-x)
    l2 = math.log(-l1)
    w = l1 - l2 + l2 / l1
    for _ in range(100):
        ew = math.exp(w)
        f = w * ew - x
        # Halley's method
        denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0)
        w_new = w - f / denom
        if abs(w_new - w) < 1e-14 * (1.0 + abs(w_new)):
            return w_new
        w = w_new
    return w


def awgn_slope(node: NodeDelayParams) -> float:
    """s_j = -alpha*mu / (W_{-1}(-e^{-(1+alpha)}) + 1)   (paper eq. 34)."""
    w = lambert_w_minus1(-math.exp(-(1.0 + node.alpha)))
    return -node.alpha * node.mu / (w + 1.0)


def awgn_optimal_load(node: NodeDelayParams, t: float, cap: float) -> float:
    """Closed-form l*_j(t) for p=0 (paper eq. 34)."""
    if t <= 2.0 * node.tau:
        return 0.0
    s = awgn_slope(node)
    return min(s * (t - 2.0 * node.tau), cap)


def awgn_optimal_return(node: NodeDelayParams, t: float, cap: float) -> float:
    """Closed-form E[R_j(t; l*_j(t))] for p=0 (paper eq. 35)."""
    if t <= 2.0 * node.tau:
        return 0.0
    s = awgn_slope(node)
    zeta = cap / s + 2.0 * node.tau
    if t <= zeta:
        s_tilde = s * (1.0 - math.exp(-node.alpha * (node.mu / s - 1.0)))
        return s_tilde * (t - 2.0 * node.tau)
    return cap * (1.0 - math.exp(
        -node.alpha * node.mu / cap * (t - cap / node.mu - 2.0 * node.tau)))


# --------------------------------------------------------------------------
# General case: E[R_j(t; l)] = l * cdf_j(t; l), piece-wise concave in l.
# --------------------------------------------------------------------------
def expected_return(node: NodeDelayParams, t: float, load: float) -> float:
    if load <= 0:
        return 0.0
    return load * node.cdf(t, load)


def _golden_max(f, lo: float, hi: float, tol: float = 1e-9):
    """Golden-section maximization of unimodal f on [lo, hi]."""
    a, b = lo, hi
    c = b - _INV_PHI * (b - a)
    d = a + _INV_PHI * (b - a)
    fc, fd = f(c), f(d)
    while (b - a) > tol * (1.0 + abs(a) + abs(b)):
        if fc >= fd:
            b, d, fd = d, c, fc
            c = b - _INV_PHI * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + _INV_PHI * (b - a)
            fd = f(d)
    x = (a + b) / 2.0
    return x, f(x)


def optimal_load(node: NodeDelayParams, t: float, cap: float) -> tuple[float, float]:
    """Maximize E[R_j(t; l)] over 0 <= l <= cap.

    Returns (l*, E[R_j(t; l*)]).  Handles the general p>0 case by searching
    each concavity piece; for p==0 uses the closed form.
    """
    symmetric = node.tau_up is None and node.p_up is None
    if cap <= 0 or (symmetric and t <= 2.0 * node.tau) or \
            (not symmetric and t <= node.tau + node._tau_up):
        return 0.0, 0.0
    if node.p == 0.0 and symmetric:
        l = awgn_optimal_load(node, t, cap)
        return l, expected_return(node, t, l)
    # piece boundaries: l = mu (t - v tau) for v = 2..v_m, clipped to (0, cap]
    # (v capped where the NB tail is numerically zero — see NodeDelayParams)
    v_m = node._v_cap(t)
    if v_m < 2:
        return 0.0, 0.0
    bounds = sorted({min(max(node.mu * (t - v * node.tau), 0.0), cap)
                     for v in range(2, v_m + 1)} | {0.0, cap})
    best_l, best_r = 0.0, 0.0
    f = lambda l: expected_return(node, t, l)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi - lo < 1e-15:
            continue
        x, fx = _golden_max(f, lo + 1e-12, hi)
        # also test the piece endpoints
        for cand, fc in ((x, fx), (hi, f(hi))):
            if fc > best_r:
                best_l, best_r = cand, fc
    return best_l, best_r


@dataclasses.dataclass(frozen=True)
class Allocation:
    t_star: float                 # optimal epoch deadline (seconds)
    loads: np.ndarray             # l*_j for clients j in [n]
    u_star: float                 # coded redundancy processed at the server
    returns: np.ndarray           # E[R_j(t*; l*_j)] per client
    coded_return: float           # E[R_C(t*; u*)]

    @property
    def total_return(self) -> float:
        return float(np.sum(self.returns) + self.coded_return)


def max_total_return(nodes: Sequence[NodeDelayParams], caps: Sequence[float],
                     t: float) -> tuple[np.ndarray, np.ndarray]:
    loads = np.zeros(len(nodes))
    rets = np.zeros(len(nodes))
    for j, (node, cap) in enumerate(zip(nodes, caps)):
        loads[j], rets[j] = optimal_load(node, t, cap)
    return loads, rets


def two_step_allocate(clients: Sequence[NodeDelayParams],
                      client_caps: Sequence[float],
                      server: NodeDelayParams | None,
                      u_max: float,
                      m: float,
                      tol: float = 1e-6,
                      t_hi: float | None = None) -> Allocation:
    """Solve paper eq. (23) via the two-step approach (eq. 24-27).

    `server=None` models the paper's §V assumption P(T_C <= t) = 1 (dedicated
    reliable MEC resources => u* = u_max contributes fully for any t>0).
    """
    nodes = list(clients)
    caps = list(client_caps)

    def total(t: float) -> float:
        _, rets = max_total_return(nodes, caps, t)
        tot = float(np.sum(rets))
        if server is None:
            tot += u_max
        else:
            _, r = optimal_load(server, t, u_max)
            tot += r
        return tot

    target = float(m)
    # the maximal possible return is sum(caps) + u_max; demand feasibility
    if sum(caps) + u_max < target - 1e-9:
        raise ValueError("infeasible: sum of caps + u_max < m")
    # bracket
    lo = 0.0
    hi = t_hi if t_hi is not None else 1.0
    for _ in range(200):
        if total(hi) >= target:
            break
        hi *= 2.0
    else:
        raise RuntimeError("could not bracket deadline time")
    # bisection (total return monotone increasing in t, Appendix C)
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if total(mid) >= target:
            hi = mid
        else:
            lo = mid
        if hi - lo < tol * (1.0 + hi):
            break
    t_star = hi
    loads, rets = max_total_return(nodes, caps, t_star)
    if server is None:
        u_star, coded_ret = float(u_max), float(u_max)
    else:
        u_star, coded_ret = optimal_load(server, t_star, u_max)
    return Allocation(t_star=t_star, loads=loads, u_star=u_star,
                      returns=rets, coded_return=coded_ret)


# --------------------------------------------------------------------------
# Population-level truncation rules (used to resolve alloc_backend="auto").
# --------------------------------------------------------------------------
def _tail_v_cap(p_max: float) -> int:
    """Static truncation of the NB transmission-count tail.

    Mirrors NodeDelayParams._v_cap's tail rule at the population's largest
    erasure probability; the per-t floor(t/tau) part of the scalar cap is
    subsumed by the slack > 0 masking inside the vectorized cdf.  Rounded up
    to a multiple of 8 so nearby populations share one compiled program
    (v_cap is a static jit argument; the extra tail terms are < 1e-13).
    """
    if p_max <= 0.0:
        return 2
    exact = 2 + int(np.ceil(-14.0 / np.log10(p_max))) + 10
    return int(-(-exact // 8) * 8)


def _geo_tail_cap(p_max: float) -> int:
    """Static per-direction geometric tail cap: NodeDelayParams._geo_cap
    (the scalar oracle's truncation rule — one source of truth) at the
    population's largest erasure prob, rounded up to a multiple of 8 so
    nearby populations share one compiled program."""
    return int(-(-NodeDelayParams._geo_cap(p_max) // 8) * 8)


def vectorized_grid_width(nodes: Sequence[NodeDelayParams]) -> int:
    """Transmission-grid columns K the vectorized solver would build.

    Symmetric populations collapse to the NB(2) grid (K = V - 1);
    asymmetric ones pay the per-direction pair grid (K = Vd * Vu), which
    grows as O(log^2 p) toward p -> 1.  The runtime's auto backend pick
    consults this to keep high-erasure asymmetric populations on the
    scalar solver instead of materializing (n, pieces, K) intermediates.
    """
    prm = stack_node_params(nodes)
    if np.array_equal(prm["p_down"], prm["p_up"]) \
            and np.array_equal(prm["tau_down"], prm["tau_up"]):
        return _tail_v_cap(float(prm["p_down"].max())) - 1
    return (_geo_tail_cap(float(prm["p_down"].max()))
            * _geo_tail_cap(float(prm["p_up"].max())))


# --------------------------------------------------------------------------
# Vectorized fixed-iteration solver (all n+1 nodes at once), torch float64.
# --------------------------------------------------------------------------
def _transmission_grids(prm: dict) -> tuple[np.ndarray, np.ndarray]:
    """Per-node transmission-count weights/offsets (h, comm), each (n, K).

    The cdf inside the vectorized objective is a weighted sum over
    transmission counts: P(T <= t) = sum_k h_k (1 - exp(-rate (t - l/mu -
    comm_k))) over terms with positive slack.  Symmetric links collapse the
    two geometric directions into the NB(2, 1-p) pmf over the round-trip
    count (K = V-1 terms); asymmetric links keep the full (n_down, n_up)
    pair grid with per-direction tail caps, flattened.
    """
    p_d, p_u = prm["p_down"], prm["p_up"]
    tau_d, tau_u = prm["tau_down"], prm["tau_up"]
    if np.array_equal(p_d, p_u) and np.array_equal(tau_d, tau_u):
        v_cap = _tail_v_cap(float(p_d.max()))
        v = np.arange(2, v_cap + 1, dtype=np.float64)
        h = ((v - 1.0) * (1.0 - p_d[:, None]) ** 2
             * p_d[:, None] ** (v - 2.0))
        return h, tau_d[:, None] * v
    vd = np.arange(1, _geo_tail_cap(float(p_d.max())) + 1, dtype=np.float64)
    vu = np.arange(1, _geo_tail_cap(float(p_u.max())) + 1, dtype=np.float64)
    n = p_d.shape[0]
    h_d = (1.0 - p_d[:, None]) * p_d[:, None] ** (vd - 1.0)    # (n, Vd)
    h_u = (1.0 - p_u[:, None]) * p_u[:, None] ** (vu - 1.0)    # (n, Vu)
    h = (h_d[:, :, None] * h_u[:, None, :]).reshape(n, -1)
    comm = ((tau_d[:, None] * vd)[:, :, None]
            + (tau_u[:, None] * vu)[:, None, :]).reshape(n, -1)
    return h, comm


def _vec_expected_return(mu, alpha, h, comm, t, loads):
    """E[R(t; l)] = l * P(T <= t), element-wise (paper eq. 42 / Theorem 1).

    mu/alpha and the transmission grids `h`/`comm` broadcast against
    ``loads[..., None]``.  Terms with non-positive slack are masked; the
    exponent is taken of the slack clamped at 0, so a masked term never
    overflows (the kept terms, of positive slack, are unchanged).
    """
    lo = loads[..., None]
    slack = t - lo / mu[..., None] - comm
    safe = torch.where(loads > 0, loads, 1.0)
    rate = (alpha * mu / safe)[..., None]
    term = torch.where(slack > 0,
                       h * (1.0 - torch.exp(-rate * slack.clamp(min=0.0))),
                       0.0)
    cdf = torch.clamp(term.sum(dim=-1), max=1.0)
    return torch.where(loads > 0, loads * cdf, 0.0)


def _vec_optimal_loads(mu, alpha, tau, h, comm, caps, t, *, v_cap: int,
                       n_golden: int):
    """Step 1 for every node at once: argmax_l E[R(t; l)], 0 <= l <= cap.

    A fixed-iteration golden-section search on every (node, concavity
    piece) pair at once (piece boundaries at l = mu (t - v tau), Theorem 1;
    asymmetric links keep the downlink-tau boundary grid, as the scalar
    solver does), then the best of each piece's interior point and upper
    endpoint, in the scalar solver's candidate order.  `t` is a float64
    scalar tensor.  Returns (loads, returns), each shaped like caps.
    """
    v = torch.arange(2, v_cap + 1, dtype=caps.dtype, device=caps.device)

    def f(l):                                   # l: (n, P) piece-grid loads
        return _vec_expected_return(mu[:, None], alpha[:, None],
                                    h[:, None, :], comm[:, None, :], t, l)

    # sorted piece boundaries: clip(mu (t - v tau), [0, cap]) with {0, cap}
    b = torch.minimum((mu[:, None] * (t - v * tau[:, None])).clamp(min=0.0),
                      caps[:, None])
    zeros = torch.zeros_like(caps)[:, None]
    bounds = torch.sort(torch.cat([zeros, b, caps[:, None]], dim=1),
                        dim=1).values           # (n, V + 1), ascending
    lo, hi = bounds[:, :-1], bounds[:, 1:]      # (n, V) pieces

    # golden section with one objective eval an iteration: carry
    # (a, b, c, d, fc, fd) and probe only the one new interior point
    a, bb = lo + 1e-12, hi
    c = bb - _INV_PHI * (bb - a)
    d = a + _INV_PHI * (bb - a)
    fc, fd = f(c), f(d)
    for _ in range(n_golden):
        left = fc >= fd
        a2 = torch.where(left, a, c)
        b2 = torch.where(left, d, bb)
        probe = torch.where(left, b2 - _INV_PHI * (b2 - a2),
                            a2 + _INV_PHI * (b2 - a2))
        fp = f(probe)
        c, d = torch.where(left, probe, d), torch.where(left, c, probe)
        fc, fd = torch.where(left, fp, fd), torch.where(left, fc, fp)
        a, bb = a2, b2
    x = 0.5 * (a + bb)

    # candidate order matches the scalar loop: per piece (ascending), the
    # golden interior point first, then the piece's upper endpoint; argmax
    # takes the first of equal returns, as the scalar loop's strict ">"
    n = caps.shape[0]
    cands = torch.stack([x, hi], dim=-1).reshape(n, -1)
    rets = torch.stack([f(x), f(hi)], dim=-1).reshape(n, -1)
    best = torch.argmax(rets, dim=1, keepdim=True)
    best_ret = torch.take_along_dim(rets, best, dim=1)[:, 0]
    best_load = torch.take_along_dim(cands, best, dim=1)[:, 0]
    ok = best_ret > 0.0
    return torch.where(ok, best_load, 0.0), torch.where(ok, best_ret, 0.0)


def _vec_two_step(mu, alpha, tau, h, comm, caps, target: float,
                  t_hi0: float, *, v_cap: int, n_golden: int,
                  n_golden_search: int, n_bracket: int, n_bisect: int):
    """Step 2: bracket + bisection over t.

    The bracket doubles t until the maximized total return reaches the
    target (at most n_bracket doublings; each test reads one scalar back
    to the host); the bisection is a fixed n_bisect iterations on the
    device.  Only the objective's VALUE matters during the search, and the
    golden-section value error is quadratic in the interval width, so the
    coarser n_golden_search runs inside the search and the full n_golden
    only for the final loads at t*.
    """
    def total(t):
        _, rets = _vec_optimal_loads(mu, alpha, tau, h, comm, caps, t,
                                     v_cap=v_cap, n_golden=n_golden_search)
        return rets.sum()

    hi = torch.tensor(t_hi0, dtype=torch.float64, device=caps.device)
    for _ in range(n_bracket):
        if not bool(total(hi) < target):
            break
        hi = hi * 2.0
    lo = torch.zeros_like(hi)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        ge = total(mid) >= target
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    loads, rets = _vec_optimal_loads(mu, alpha, tau, h, comm, caps, hi,
                                     v_cap=v_cap, n_golden=n_golden)
    return hi, loads, rets


def _stacked(nodes, caps, device):
    """The solver's float64 tensors of `nodes` on `device`: (mu, alpha,
    tau_down, h, comm, caps) and the static v_cap."""
    prm = stack_node_params(nodes)
    h, comm = _transmission_grids(prm)
    dev = torch.device("cuda" if device is None else device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)
    return ((t(prm["mu"]), t(prm["alpha"]), t(prm["tau_down"]), t(h),
             t(comm), t(caps)), _tail_v_cap(float(prm["p_down"].max())))


def vectorized_optimal_loads(nodes: Sequence[NodeDelayParams], t: float,
                             caps: Sequence[float], *, n_golden: int = 52,
                             device=None) -> tuple[np.ndarray, np.ndarray]:
    """Step-1 optimal loads for all nodes at once (float64 on `device`,
    the GPU unless the caller asks for another).

    Node for node equivalent to looping `optimal_load`, asymmetric links
    included (the flattened per-direction transmission grid).
    """
    tensors, v_cap = _stacked(nodes, caps, device)
    t_dev = torch.tensor(float(t), dtype=torch.float64,
                         device=tensors[0].device)
    loads, rets = _vec_optimal_loads(*tensors, t_dev, v_cap=v_cap,
                                     n_golden=n_golden)
    return loads.cpu().numpy(), rets.cpu().numpy()


def two_step_allocate_vectorized(clients: Sequence[NodeDelayParams],
                                 client_caps: Sequence[float],
                                 server: NodeDelayParams | None,
                                 u_max: float,
                                 m: float,
                                 tol: float = 1e-6,
                                 t_hi: float | None = None,
                                 n_golden: int = 52,
                                 n_golden_search: int = 28,
                                 n_bracket: int = 60,
                                 n_bisect: int = 48,
                                 device=None) -> Allocation:
    """Vectorized counterpart of `two_step_allocate` (paper eq. 23-27).

    One fixed-iteration program solves step 1 for all n clients (plus the
    MEC server compute node when given, the paper's n+1 nodes) and runs the
    step-2 bracket and bisection, in float64 on `device` (the GPU unless
    the caller asks for another).  Matches the scalar solver within its
    bisection tolerance (`tol` only documents that contract: the iteration
    counts are fixed and exceed it).
    """
    nodes = list(clients)
    caps = [float(cp) for cp in client_caps]
    target = float(m)
    if server is not None:
        nodes.append(server)
        caps.append(float(u_max))
    else:
        target -= float(u_max)          # P(T_C <= t) = 1: u_max always returns
    if sum(client_caps) + u_max < m - 1e-9:
        raise ValueError("infeasible: sum of caps + u_max < m")
    tensors, v_cap = _stacked(nodes, caps, device)
    t_star, loads, rets = _vec_two_step(
        *tensors, target, float(t_hi if t_hi is not None else 1.0),
        v_cap=v_cap, n_golden=n_golden, n_golden_search=n_golden_search,
        n_bracket=n_bracket, n_bisect=n_bisect)
    t_star = float(t_star)
    loads = loads.cpu().numpy()
    rets = rets.cpu().numpy()
    if server is None:
        u_star, coded_ret = float(u_max), float(u_max)
    else:
        loads, u_star = loads[:-1], float(loads[-1])
        rets, coded_ret = rets[:-1], float(rets[-1])
    return Allocation(t_star=t_star, loads=loads, u_star=u_star,
                      returns=rets, coded_return=coded_ret)
