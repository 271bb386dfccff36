"""CodedFedL load allocation and coding-redundancy optimizer (paper §III-C, §IV).

The scalar NumPy part of ``repro.core.load_allocation``, copied: the same
code on the same nodes gives a bit-identical deadline t* and loads.

Two-step scheme:
  Step 1 (fixed deadline t): for every node j in [n+1] (clients + MEC
    compute unit), maximize the expected return
        E[R_j(t; l)] = l * P(T_j <= t)
    over 0 <= l <= cap_j.  By Theorem 1 the objective is piece-wise concave
    in l with concavity-piece boundaries at l = mu_j (t - v tau_j); we run a
    golden-section search per piece (no SciPy dependency).
  Step 2: bisection over t (the maximized total expected return is monotone
    increasing in t, Appendix C) until it equals m.

The reference's vectorized fixed-iteration JAX solver
(``two_step_allocate_vectorized``) is not ported yet.  Its floored loads can
differ from the scalar solver's, so the runtime raises wherever the
reference would pick it (``vectorized_grid_width`` decides, as there) rather
than quietly running the scalar solver in its place.

Special case p_j = 0 (AWGN links): closed form via the Lambert-W minor
branch (paper eq. 34/35, Appendix D).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.delay_model import NodeDelayParams, stack_node_params

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
