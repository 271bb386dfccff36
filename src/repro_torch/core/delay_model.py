"""Compute + communication delay model of CodedFedL (paper §II-B).

A NumPy copy of ``repro.core.delay_model``: the same code on the same
``np.random.Generator`` gives bit-identical delays, which is what lets the
port's round-by-round returned counts and wall clock match the reference.

Per node j (client or MEC compute unit):

  T_j = T_down + T_cmp + T_up
      = tau_j * N_down + ( l_j / mu_j + Exp(alpha_j * mu_j / l_j) ) + tau_j * N_up

with N_down, N_up ~ iid Geometric(1 - p_j) (number of transmissions until
success over an erasure link) so N_down + N_up ~ NegBinomial(r=2, 1-p_j).

The module is pure NumPy — the delay model drives the *simulation* of the
wireless MEC network and the load-allocation optimizer; it never runs on
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class NodeDelayParams:
    """Delay parameters for one node (client or server compute unit).

    The paper assumes reciprocal links (footnote 1) — tau_up == tau_down ==
    tau.  The asymmetric generalization the footnote mentions is supported:
    set tau_up (and/or p_up) explicitly; everywhere the symmetric model is
    analyzed, the asymmetric case substitutes tau -> (tau + tau_up)/2 in
    expectation and samples each direction with its own parameters.
    """
    mu: float                 # data points processed per second
    alpha: float              # compute/memory-access ratio (>0)
    tau: float                # seconds per downlink (re)transmission
    p: float                  # downlink erasure probability in [0, 1)
    tau_up: float | None = None   # uplink; None -> reciprocal (= tau)
    p_up: float | None = None

    def __post_init__(self):
        for name, p in (("p", self.p), ("p_up", self.p_up)):
            if p is not None and not (0.0 <= p < 1.0):
                raise ValueError(
                    f"erasure probability {name}={p} must lie in [0, 1): "
                    "p == 1 means the link never delivers a packet, so every "
                    "delay (and the parity upload time) is infinite")
        if self.mu <= 0.0 or self.alpha <= 0.0 or self.tau <= 0.0:
            raise ValueError(
                f"mu={self.mu}, alpha={self.alpha}, tau={self.tau} "
                "must all be positive")
        if self.tau_up is not None and self.tau_up <= 0.0:
            raise ValueError(f"tau_up={self.tau_up} must be positive")

    @property
    def _tau_up(self) -> float:
        return self.tau if self.tau_up is None else self.tau_up

    @property
    def _p_up(self) -> float:
        return self.p if self.p_up is None else self.p_up

    def expected_delay(self, load: float) -> float:
        """E[T_j] for a per-round load of `load` points  (paper eq. 15,
        asymmetric links per footnote 1)."""
        comm = self.tau / (1.0 - self.p) + self._tau_up / (1.0 - self._p_up)
        if load <= 0:
            return comm
        return load / self.mu * (1.0 + 1.0 / self.alpha) + comm

    def _v_cap(self, t: float) -> int:
        """Largest transmission count worth summing over.

        Exact bound is floor(t/tau); we additionally truncate the negative-
        binomial tail where (v-1) p^(v-2) < 1e-14 — beyond that the terms
        cannot move the cdf at double precision.
        """
        v_m = int(np.floor(t / self.tau - 1e-12))
        if self.p <= 0.0:
            return min(v_m, 2)
        v_tail = 2 + int(np.ceil(-14.0 / np.log10(self.p))) + 10
        return min(v_m, v_tail)

    # ------------------------------------------------------------------ cdf
    def cdf(self, t: float, load: float) -> float:
        """P(T_j <= t) for load l  (paper eq. 42 / Theorem 1).

        P = sum_{v=2}^{v_m} (v-1)(1-p)^2 p^(v-2) * (1 - exp(-a*mu/l*(t - l/mu - tau*v)))
        over v with t - l/mu - tau*v > 0.  Asymmetric links use the nested
        two-geometric sum (footnote 1 generalization).
        """
        if self.tau_up is not None or self.p_up is not None:
            return self._cdf_asym(t, load)
        if t <= 2.0 * self.tau:
            return 0.0
        if load <= 0:
            # pure communication: P(N_com * tau <= t), N_com ~ NB(2, 1-p)
            v_m = self._v_cap(t)
            if v_m < 2:
                return 0.0
            v = np.arange(2, v_m + 1)
            return float(min(np.sum(
                (v - 1) * (1 - self.p) ** 2 * self.p ** (v - 2)), 1.0))
        v_m = self._v_cap(t)
        if v_m < 2:
            return 0.0
        v = np.arange(2, v_m + 1, dtype=np.float64)
        slack = t - load / self.mu - self.tau * v
        mask = slack > 0
        if not np.any(mask):
            return 0.0
        rate = self.alpha * self.mu / load
        h = (v - 1) * (1 - self.p) ** 2 * self.p ** (v - 2)
        val = h[mask] * (1.0 - np.exp(-rate * slack[mask]))
        return float(min(np.sum(val), 1.0))

    def _cdf_asym(self, t: float, load: float) -> float:
        """Nested sum over (n_down, n_up) geometric pairs."""
        det = load / self.mu if load > 0 else 0.0
        rate = self.alpha * self.mu / load if load > 0 else None
        tot = 0.0
        nd_cap = self._geo_cap(self.p)
        nu_cap = self._geo_cap(self._p_up)
        for nd in range(1, nd_cap + 1):
            p_nd = self.p ** (nd - 1) * (1.0 - self.p)
            for nu in range(1, nu_cap + 1):
                slack = t - det - self.tau * nd - self._tau_up * nu
                if slack <= 0:
                    break
                p_nu = self._p_up ** (nu - 1) * (1.0 - self._p_up)
                inner = 1.0 if rate is None else 1.0 - np.exp(-rate * slack)
                tot += p_nd * p_nu * inner
        return float(min(tot, 1.0))

    @staticmethod
    def _geo_cap(p: float) -> int:
        if p <= 0.0:
            return 1
        return 1 + int(np.ceil(-14.0 / np.log10(p))) + 10

    # ------------------------------------------------------------- sampling
    def sample(self, rng: np.random.Generator, load: float, size: int = 1) -> np.ndarray:
        """Sample total round-trip delays T_j (seconds)."""
        n_down = rng.geometric(1.0 - self.p, size=size)
        n_up = rng.geometric(1.0 - self._p_up, size=size)
        t_comm = self.tau * n_down + self._tau_up * n_up
        if load <= 0:
            return t_comm
        t_det = load / self.mu
        t_stoch = rng.exponential(load / (self.alpha * self.mu), size=size)
        return t_det + t_stoch + t_comm


def stack_node_params(nodes: "list[NodeDelayParams]") -> dict[str, np.ndarray]:
    """Stack per-node delay parameters into dense arrays.

    Returns {"mu", "alpha", "tau_down", "tau_up", "p_down", "p_up"}, each of
    shape (n,).  Reciprocal links (tau_up/p_up unset) are resolved to their
    downlink values, so consumers never branch on None.
    """
    return {
        "mu": np.array([nd.mu for nd in nodes], np.float64),
        "alpha": np.array([nd.alpha for nd in nodes], np.float64),
        "tau_down": np.array([nd.tau for nd in nodes], np.float64),
        "tau_up": np.array([nd._tau_up for nd in nodes], np.float64),
        "p_down": np.array([nd.p for nd in nodes], np.float64),
        "p_up": np.array([nd._p_up for nd in nodes], np.float64),
    }


def sample_round_times(nodes: "list[NodeDelayParams]", loads,
                       rng: np.random.Generator, rounds: int = 1) -> np.ndarray:
    """Vectorized delay sampling: all nodes x all rounds in 3 RNG draws.

    Replaces `rounds * n` Python-level `NodeDelayParams.sample` calls with one
    vectorized geometric draw per link direction plus one exponential draw —
    the sampling API the batched `FederatedSimulation` engine pre-computes an
    entire training run's delays with.

    loads: (n,) per-node per-round loads (data points).  Nodes with load <= 0
    incur communication delay only, matching `NodeDelayParams.sample`.
    Returns float64 delays of shape (rounds, n).
    """
    return sample_round_times_stacked(stack_node_params(nodes), loads,
                                      rng, rounds)


def sample_round_times_stacked(prm: dict, loads, rng: np.random.Generator,
                               rounds: int = 1) -> np.ndarray:
    """`sample_round_times` over pre-stacked `stack_node_params` arrays.

    Identical draw layout (geometric down, geometric up, exponential) and
    bit-identical output.
    """
    loads = np.asarray(loads, np.float64)
    n = prm["mu"].shape[0]
    if loads.shape != (n,):
        raise ValueError(f"loads shape {loads.shape} != ({n},)")
    n_down = rng.geometric(1.0 - prm["p_down"], size=(rounds, n))
    n_up = rng.geometric(1.0 - prm["p_up"], size=(rounds, n))
    t = prm["tau_down"] * n_down + prm["tau_up"] * n_up
    active = loads > 0.0
    # exponential compute tail with per-node scale l/(alpha*mu); a single
    # unit-rate draw is rescaled so inactive nodes cost no extra RNG state
    scale = np.where(active, loads / (prm["alpha"] * prm["mu"]), 0.0)
    t_stoch = rng.exponential(1.0, size=(rounds, n)) * scale
    return t + np.where(active, loads / prm["mu"], 0.0) + t_stoch


def mec_network(fl_cfg, d_scalars_per_point: int) -> list[NodeDelayParams]:
    """Build the paper's §V-A heterogeneous 30-client MEC network.

    Effective rates are max_rate * k1^i (random permutation over clients),
    MAC rates max_mac * k2^i.  tau is the time to move one packet of
    b bits = d_scalars_per_point-independent model/gradient packet; the paper
    sends the full model/gradient each round, so b = payload bits with 10%
    overhead.  We parameterize tau per *packet* where the packet carries the
    model (q*c scalars); callers pass the packet size via
    `packet_bits(fl_cfg, n_scalars)` and scale tau accordingly — here we
    return per-client (mu, alpha, tau_unit, p) with tau_unit = seconds per
    bit, to be scaled by the payload.
    """
    rng = np.random.default_rng(fl_cfg.seed)
    n = fl_cfg.n_clients
    rate_factors = fl_cfg.rate_decay ** np.arange(n)
    mac_factors = fl_cfg.mac_decay ** np.arange(n)
    rng.shuffle(rate_factors)
    rng.shuffle(mac_factors)
    rates = fl_cfg.max_rate_bps * rate_factors            # bits/s
    macs = fl_cfg.max_mac_rate * mac_factors              # MAC/s
    # mu: data points per second = MAC rate / MACs per point
    mus = macs / float(d_scalars_per_point)
    nodes = []
    for j in range(n):
        nodes.append(NodeDelayParams(
            mu=float(mus[j]), alpha=fl_cfg.alpha,
            tau=1.0 / float(rates[j]),                     # seconds per bit
            p=fl_cfg.p_erasure))
    return nodes


def scale_tau(node: NodeDelayParams, payload_bits: float) -> NodeDelayParams:
    """Return a copy of `node` with tau scaled to a concrete packet size."""
    return NodeDelayParams(
        mu=node.mu, alpha=node.alpha, tau=node.tau * payload_bits, p=node.p,
        tau_up=None if node.tau_up is None else node.tau_up * payload_bits,
        p_up=node.p_up)


def packet_bits(fl_cfg, n_scalars: int) -> float:
    """Bits to ship `n_scalars` scalars incl. protocol overhead."""
    return n_scalars * fl_cfg.bits_per_scalar * (1.0 + fl_cfg.overhead)


# Paper §V-A heterogeneity knobs: effective link rates decay as k1^i and MAC
# rates as k2^i over clients (random permutation), so smaller factors mean a
# heavier straggler tail.  The grid walks from a homogeneous network through
# the §V-A operating point out to a heavy straggler tail, plus one-knob
# skews isolating link-rate vs MAC-rate heterogeneity.  Named profiles are
# addressable from `ExperimentSpec.delay_profile`; the benchmark launcher
# sweeps the full grid.
HETEROGENEITY_PROFILES = {
    "uniform": dict(rate_decay=1.0, mac_decay=1.0),
    "gentle": dict(rate_decay=0.99, mac_decay=0.95),
    "mild": dict(rate_decay=0.98, mac_decay=0.9),
    "moderate": dict(rate_decay=0.96, mac_decay=0.85),
    "paper": dict(rate_decay=0.95, mac_decay=0.8),
    "rate_skew": dict(rate_decay=0.9, mac_decay=1.0),
    "rate_heavy": dict(rate_decay=0.85, mac_decay=1.0),
    "mac_skew": dict(rate_decay=1.0, mac_decay=0.7),
    "mac_heavy": dict(rate_decay=1.0, mac_decay=0.55),
    "mixed": dict(rate_decay=0.94, mac_decay=0.75),
    "heavy": dict(rate_decay=0.92, mac_decay=0.7),
    "extreme": dict(rate_decay=0.9, mac_decay=0.6),
    "harsh": dict(rate_decay=0.85, mac_decay=0.5),
    "brutal": dict(rate_decay=0.8, mac_decay=0.45),
}


def ideal_round_time(nodes: "list[NodeDelayParams]", l: float) -> float:
    """Deterministic no-straggler round time (seconds).

    One transmission per direction, deterministic compute, full load l on
    every client — the floor for the full-load (naive/greedy) schemes.
    """
    prm = stack_node_params(nodes)
    return float(np.max(l / prm["mu"] + prm["tau_down"] + prm["tau_up"]))
