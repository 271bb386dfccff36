"""Deterministic per-seed network-state traces and traced delay sampling
(a NumPy copy of ``repro.net.trace``: the same code on the same
``np.random.Generator`` gives the same bits).

`generate_trace` rolls a `ChannelProfile` forward for a whole training
run, producing dense ``(rounds, n)`` state tensors (erasure probabilities,
tau/mu multipliers, availability).  Under the hood it is a single-block
call of `generate_trace_block`, which advances an explicit resumable
`TraceState` (RNG bit-generator state + one recurrence vector per
dynamic) so the block-structured runtime can checkpoint a trace mid-run
and continue it bit-exactly.  `sample_round_observations` then draws
the per-round delays *through* that trace with the same three-draw layout
as `delay_model.sample_round_times` — one geometric draw per link
direction plus one exponential compute tail — so the batched engine keeps
pre-sampling an entire run in a handful of vectorized RNG calls.

Two contracts the tests pin down:

  * **Determinism** — equal (nodes, profile, rounds, seed) reproduce the
    trace array-for-array; the trace generator always consumes the same
    RNG layout (one uniform/normal block per dynamic, drawn whether or
    not that dynamic is enabled), so switching one knob on never changes
    another's realization at equal seed.
  * **Static exactness** — under a static profile the sampler's delays
    are BIT-IDENTICAL to `sample_round_times` given the same generator
    state: multipliers are exactly 1.0 (multiplying by them is an IEEE
    no-op), erasure probabilities are the unmodified per-node values, and
    the arithmetic evaluates in the same order.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.delay_model import NodeDelayParams, stack_node_params
from repro_torch.net.channel import ChannelProfile, mcs_efficiency


@dataclasses.dataclass
class NetworkTrace:
    """Realized network state, one row per round: all arrays (rounds, n)."""
    mu_mult: np.ndarray     # compute-speed multiplier (exactly 1.0 if off)
    tau_mult: np.ndarray    # per-transmission-time multiplier (both dirs)
    p_down: np.ndarray      # absolute downlink erasure prob per round
    p_up: np.ndarray
    active: np.ndarray      # bool availability (churn) mask
    profile: ChannelProfile

    @property
    def rounds(self) -> int:
        return self.mu_mult.shape[0]

    @property
    def n(self) -> int:
        return self.mu_mult.shape[1]

    def slice(self, r0: int, r1: int) -> "NetworkTrace":
        """Rounds [r0, r1) as a view-trace (the controller's block window)."""
        return NetworkTrace(
            mu_mult=self.mu_mult[r0:r1], tau_mult=self.tau_mult[r0:r1],
            p_down=self.p_down[r0:r1], p_up=self.p_up[r0:r1],
            active=self.active[r0:r1], profile=self.profile)


@dataclasses.dataclass
class TraceState:
    """Resumable cursor of a rolling channel trace.

    Every dynamic `generate_trace` rolls forward is a first-order
    recurrence over the rounds axis, so one ``(n,)`` vector per dynamic —
    plus the RNG bit-generator state and the global round cursor — is
    sufficient to continue the trace from any round boundary.  Chaining
    `generate_trace_block` calls through this state yields, for a fixed
    block partition, exactly the trajectory of the per-block draws; a
    single block covering the whole horizon is bit-identical to the
    one-shot `generate_trace`.
    """
    rng_state: dict         # numpy BitGenerator state (JSON-serializable)
    rounds_done: int        # global rounds already generated
    ge_bad: np.ndarray      # (n,) bool Gilbert–Elliott bad-state flags
    shadow_x: np.ndarray    # (n,) raw AR(1) shadowing in dB (pre-trend)
    drift_g: np.ndarray     # (n,) log-domain compute-drift walk position
    churn_active: np.ndarray  # (n,) bool availability flags

    @classmethod
    def init(cls, n: int, rng: np.random.Generator) -> "TraceState":
        """Fresh state at round 0 (good links, nominal speed, all present),
        consuming `rng`'s current position as the stream start."""
        return cls(rng_state=rng.bit_generator.state, rounds_done=0,
                   ge_bad=np.zeros(n, bool), shadow_x=np.zeros(n),
                   drift_g=np.zeros(n), churn_active=np.ones(n, bool))


def generate_trace_block(nodes: "list[NodeDelayParams]",
                         profile: ChannelProfile, rounds: int,
                         state: TraceState
                         ) -> "tuple[NetworkTrace, TraceState]":
    """Roll the profile forward `rounds` more rounds from `state`.

    Vectorized over nodes; the only Python-level loop is the O(rounds)
    recurrence each dynamic needs (Markov states, AR(1), random walk).
    The RNG layout is fixed — four (rounds, n) blocks drawn in one order
    — so the realization of one dynamic is invariant to the others being
    toggled (controlled comparisons at equal seed).  Round 0 of the whole
    run (``state.rounds_done == 0``) gets the stationary/nominal initial
    conditions; later blocks continue their recurrences seamlessly.

    Returns the block's trace and the advanced state; `state` itself is
    not mutated (checkpointing keeps the pre-block snapshot valid).
    """
    prm = stack_node_params(nodes)
    n = len(nodes)
    R = int(rounds)
    if R < 1:
        raise ValueError(f"rounds must be >= 1, got {rounds}")
    r0 = int(state.rounds_done)
    rng = np.random.default_rng()
    rng.bit_generator.state = state.rng_state
    # fixed draw layout (see docstring): GE uniforms, shadowing normals,
    # drift normals, churn uniforms
    ge_u = rng.random((R, n))
    shadow_eps = rng.standard_normal((R, n))
    drift_eps = rng.standard_normal((R, n))
    churn_u = rng.random((R, n))

    # --- Gilbert–Elliott erasure states -> absolute per-round erasure probs
    ge_bad = state.ge_bad
    if profile.has_erasure_dynamics:
        bad = np.zeros((R, n), bool)
        prev = state.ge_bad.copy()            # round 0 starts in good state
        for t in range(R):
            prev = np.where(prev, ge_u[t] >= profile.ge_p_bg,
                            ge_u[t] < profile.ge_p_gb)
            bad[t] = prev
        scale = np.where(bad, profile.ge_bad_scale, 1.0)
        p_down = np.clip(prm["p_down"] * scale, 0.0, profile.p_cap)
        p_up = np.clip(prm["p_up"] * scale, 0.0, profile.p_cap)
        ge_bad = prev
    else:
        p_down = np.broadcast_to(prm["p_down"], (R, n)).copy()
        p_up = np.broadcast_to(prm["p_up"], (R, n)).copy()

    # --- log-normal shadowing (AR(1) in dB) + deterministic trend,
    # optionally MCS-quantized.  The dB process is *attenuation*: positive
    # values slow the link in both the continuous and the MCS mapping.
    shadow_x = state.shadow_x
    if profile.has_shadowing:
        sigma, rho = profile.shadow_sigma_db, profile.shadow_rho
        x = np.zeros((R, n))
        innov = np.sqrt(max(0.0, 1.0 - rho * rho)) * sigma
        prev = state.shadow_x
        for t in range(R):
            if r0 + t == 0:
                x[t] = sigma * shadow_eps[t]  # start at the stationary law
            else:
                x[t] = rho * prev + innov * shadow_eps[t]
            prev = x[t]
        shadow_x = x[-1].copy()               # raw (pre-trend) carry
        x = x + profile.tau_trend_db * np.arange(r0, r0 + R)[:, None]
        if profile.mcs:
            # attenuation lowers SNR; rate hops along the CQI ladder
            eff0 = mcs_efficiency(profile.mcs_snr0_db)
            tau_mult = eff0 / mcs_efficiency(profile.mcs_snr0_db - x)
        else:
            tau_mult = 10.0 ** (x / 10.0)
    else:
        tau_mult = np.ones((R, n))

    # --- bounded compute-speed random walk (log domain)
    drift_g = state.drift_g
    if profile.has_compute_drift:
        lo, hi = np.log(profile.mu_min), np.log(profile.mu_max)
        step = np.log1p(profile.mu_drift_rate)
        g = np.zeros((R, n))
        prev = state.drift_g
        for t in range(R):
            if r0 + t == 0:
                g[t] = 0.0                    # round 0 at nominal speed
            else:
                g[t] = np.clip(
                    prev + step + profile.mu_drift_sigma * drift_eps[t],
                    lo, hi)
            prev = g[t]
        mu_mult = np.exp(g)
        drift_g = g[-1].copy()
    else:
        mu_mult = np.ones((R, n))

    # --- dropout/rejoin churn
    churn_active = state.churn_active
    if profile.has_churn:
        active = np.ones((R, n), bool)
        prev = state.churn_active.copy()      # round 0 everyone present
        for t in range(R):
            if r0 + t > 0:
                prev = np.where(prev, churn_u[t] >= profile.dropout_prob,
                                churn_u[t] < profile.rejoin_prob)
            active[t] = prev
        churn_active = prev
    else:
        active = np.ones((R, n), bool)

    trace = NetworkTrace(mu_mult=mu_mult, tau_mult=tau_mult, p_down=p_down,
                         p_up=p_up, active=active, profile=profile)
    new_state = TraceState(rng_state=rng.bit_generator.state,
                           rounds_done=r0 + R, ge_bad=ge_bad,
                           shadow_x=shadow_x, drift_g=drift_g,
                           churn_active=churn_active)
    return trace, new_state


def generate_trace(nodes: "list[NodeDelayParams]", profile: ChannelProfile,
                   rounds: int, rng: np.random.Generator) -> NetworkTrace:
    """Roll the channel profile forward `rounds` rounds for all nodes.

    One-shot wrapper over `generate_trace_block`: a fresh `TraceState` at
    round 0 plus a single block covering the whole horizon.  The caller's
    generator is advanced past the consumed draws, exactly as if the
    draws had been made on it directly.
    """
    trace, end = generate_trace_block(nodes, profile, rounds,
                                      TraceState.init(len(nodes), rng))
    rng.bit_generator.state = end.rng_state
    return trace


@dataclasses.dataclass
class RoundObservations:
    """Per-round, per-node timing telemetry the MEC orchestrator collects.

    The simulator grants full per-phase observability — download time,
    compute time, upload time, and per-direction transmission counts (the
    link layer counts its own retransmissions) — which is what the online
    estimator (`repro_torch.net.estimator`) consumes.  ``total`` is the scalar
    round-trip delay the engine's deadline logic sees.
    """
    total: np.ndarray       # (R, n) seconds
    t_down: np.ndarray      # (R, n) downlink communication seconds
    t_up: np.ndarray        # (R, n) uplink communication seconds
    t_comp: np.ndarray      # (R, n) compute seconds (deterministic + tail)
    n_down: np.ndarray      # (R, n) downlink transmission counts
    n_up: np.ndarray        # (R, n) uplink transmission counts
    active: np.ndarray      # (R, n) availability (copied from the trace)
    loads: np.ndarray       # (R, n) loads in effect when sampled


def sample_round_observations(nodes: "list[NodeDelayParams]", loads,
                              rng: np.random.Generator,
                              trace: NetworkTrace) -> RoundObservations:
    """Sample every round's delays through the trace, with telemetry.

    Mirrors `delay_model.sample_round_times`'s three-draw layout exactly
    (geometric per direction, then one unit exponential), with the trace's
    per-round parameters substituted elementwise.  `loads` is (n,) for a
    fixed allocation or (rounds, n) for a per-round (adaptive) schedule.
    """
    prm = stack_node_params(nodes)
    n = len(nodes)
    R = trace.rounds
    loads = np.asarray(loads, np.float64)
    if loads.shape == (n,):
        loads_rn = np.broadcast_to(loads, (R, n))
    elif loads.shape == (R, n):
        loads_rn = loads
    else:
        raise ValueError(f"loads shape {loads.shape} must be ({n},) "
                         f"or ({R}, {n})")
    if trace.n != n:
        raise ValueError(f"trace covers {trace.n} nodes, got {n}")

    n_down = rng.geometric(1.0 - trace.p_down)
    n_up = rng.geometric(1.0 - trace.p_up)
    t_down = (prm["tau_down"] * trace.tau_mult) * n_down
    t_up = (prm["tau_up"] * trace.tau_mult) * n_up
    active_load = loads_rn > 0.0
    mu_eff = prm["mu"] * trace.mu_mult
    scale = np.where(active_load, loads_rn / (prm["alpha"] * mu_eff), 0.0)
    t_stoch = rng.exponential(1.0, size=(R, n)) * scale
    t_det = np.where(active_load, loads_rn / mu_eff, 0.0)
    # same association order as sample_round_times: (comm + det) + tail
    total = (t_down + t_up) + t_det + t_stoch
    return RoundObservations(total=total, t_down=t_down, t_up=t_up,
                             t_comp=t_det + t_stoch, n_down=n_down,
                             n_up=n_up, active=trace.active.copy(),
                             loads=np.asarray(loads_rn, np.float64).copy())


def sample_round_times_traced(nodes: "list[NodeDelayParams]", loads,
                              rng: np.random.Generator,
                              trace: NetworkTrace) -> np.ndarray:
    """(rounds, n) round-trip delays through the trace.

    Drop-in extension of `delay_model.sample_round_times`: under a static
    profile (all multipliers exactly 1.0, erasure probs untouched) the
    output is bit-identical to it for the same generator state, because
    the RNG draws see elementwise-equal parameters and the arithmetic
    keeps the same evaluation order.
    """
    return sample_round_observations(nodes, loads, rng, trace).total
