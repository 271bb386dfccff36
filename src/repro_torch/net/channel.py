"""Time-varying wireless channel profiles (a NumPy copy of
``repro.net.channel``).

A `ChannelProfile` declares how the MEC network drifts over a training
run, on top of the per-node stationary parameters (`NodeDelayParams`):

  * **Gilbert–Elliott erasure states** — each node's link hops between a
    good and a bad state with a 2-state Markov chain; the bad state
    multiplies the node's base erasure probability by ``ge_bad_scale``
    (Gilbert 1960 / Elliott 1963 burst-loss model).
  * **Log-normal shadowing on tau** — an AR(1) process in dB perturbs the
    per-transmission time.  With ``mcs=True`` the dB process is read as an
    SNR offset and quantized through an LTE CQI table (TS 36.213
    Table 7.2.3-1 spectral efficiencies), so the realized rate hops
    between discrete MCS levels the way an LTE link adapter would.
  * **Compute-speed drift** — a bounded random walk (plus an optional
    deterministic trend) on each node's processing rate ``mu``, modeling
    thermal throttling, background load, or hardware upgrades.
  * **Churn** — a 2-state availability chain: an active client drops out
    with ``dropout_prob`` per round and rejoins with ``rejoin_prob``.

All knobs default OFF, so ``ChannelProfile()`` (the ``"static"`` profile)
reproduces the stationary paper model *bit-exactly* through the traced
sampler (`repro_torch.net.trace`).  Named profiles in `CHANNEL_PROFILES` are
addressable from ``ExperimentSpec.channel_profile``; scenario-specific
overrides ride in ``ExperimentSpec.channel_params``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# LTE CQI table (TS 36.213 Table 7.2.3-1): spectral efficiency per CQI
# index, with the customary AWGN SNR switching thresholds (dB).  The rate
# mapping picks the highest CQI whose threshold the instantaneous SNR
# clears; per-transmission time scales inversely with efficiency.
MCS_SNR_DB = np.array([-6.7, -4.7, -2.3, 0.2, 2.4, 4.3, 5.9, 8.1,
                       10.3, 11.7, 14.1, 16.3, 18.7, 21.0, 22.7])
MCS_EFFICIENCY = np.array([0.1523, 0.2344, 0.3770, 0.6016, 0.8770,
                           1.1758, 1.4766, 1.9141, 2.4063, 2.7305,
                           3.3223, 3.9023, 4.5234, 5.1152, 5.5547])


def mcs_efficiency(snr_db) -> np.ndarray:
    """Spectral efficiency at `snr_db` through the CQI switching table.

    Below the lowest threshold the link stays at the most robust MCS
    (CQI 1) — outage is the erasure process's job, not the rate mapping's.
    """
    idx = np.searchsorted(MCS_SNR_DB, np.asarray(snr_db, np.float64),
                          side="right") - 1
    return MCS_EFFICIENCY[np.clip(idx, 0, len(MCS_EFFICIENCY) - 1)]


@dataclasses.dataclass(frozen=True)
class ChannelProfile:
    """Declarative network-dynamics knobs (all OFF by default = static)."""
    # Gilbert–Elliott erasure chain (per node, shared by both directions)
    ge_p_gb: float = 0.0        # P(good -> bad) per round; 0 = never bad
    ge_p_bg: float = 1.0        # P(bad -> good) per round
    ge_bad_scale: float = 1.0   # erasure-prob multiplier in the bad state
    # log-normal shadowing (AR(1) in dB) on per-transmission time tau,
    # plus an optional deterministic dB-per-round trend (negative = links
    # improve over the run, positive = degrade)
    shadow_sigma_db: float = 0.0
    shadow_rho: float = 0.9     # round-to-round correlation in [0, 1]
    tau_trend_db: float = 0.0
    mcs: bool = False           # quantize through the LTE CQI table
    mcs_snr0_db: float = 10.3   # nominal operating SNR (CQI 9)
    # bounded random walk (+ trend) on compute speed mu, in log domain
    mu_drift_sigma: float = 0.0     # per-round log-step std
    mu_drift_rate: float = 0.0      # per-round multiplicative trend - 1
    mu_min: float = 0.25            # multiplier clip range
    mu_max: float = 4.0
    # client dropout/rejoin churn
    dropout_prob: float = 0.0
    rejoin_prob: float = 1.0
    # time-varying erasure probabilities are clipped here (p = 1 would
    # make a link permanently dead — see NodeDelayParams validation)
    p_cap: float = 0.95

    def __post_init__(self):
        for name in ("ge_p_gb", "ge_p_bg", "dropout_prob", "rejoin_prob",
                     "shadow_rho"):
            val = getattr(self, name)
            if not (0.0 <= val <= 1.0):
                raise ValueError(f"{name}={val} must lie in [0, 1]")
        if self.ge_bad_scale < 0.0:
            raise ValueError(f"ge_bad_scale={self.ge_bad_scale} must be >= 0")
        if self.shadow_sigma_db < 0.0:
            raise ValueError(
                f"shadow_sigma_db={self.shadow_sigma_db} must be >= 0")
        if self.mu_drift_sigma < 0.0:
            raise ValueError(
                f"mu_drift_sigma={self.mu_drift_sigma} must be >= 0")
        if self.mu_drift_rate <= -1.0:
            raise ValueError(
                f"mu_drift_rate={self.mu_drift_rate} must be > -1")
        if not (0.0 < self.mu_min <= 1.0 <= self.mu_max):
            raise ValueError(
                f"need 0 < mu_min <= 1 <= mu_max, got "
                f"[{self.mu_min}, {self.mu_max}]")
        if not (0.0 < self.p_cap < 1.0):
            raise ValueError(f"p_cap={self.p_cap} must lie in (0, 1)")

    # ------------------------------------------------------------ properties
    @property
    def has_erasure_dynamics(self) -> bool:
        return self.ge_p_gb > 0.0 and self.ge_bad_scale != 1.0

    @property
    def has_shadowing(self) -> bool:
        return self.shadow_sigma_db > 0.0 or self.tau_trend_db != 0.0

    @property
    def has_compute_drift(self) -> bool:
        return self.mu_drift_sigma > 0.0 or self.mu_drift_rate != 0.0

    @property
    def has_churn(self) -> bool:
        return self.dropout_prob > 0.0

    @property
    def is_static(self) -> bool:
        """True iff the trace is guaranteed exactly neutral (multipliers
        exactly 1.0, erasure probs untouched, everyone always active)."""
        return not (self.has_erasure_dynamics or self.has_shadowing
                    or self.has_compute_drift or self.has_churn)


#: Named profiles addressable from ``ExperimentSpec.channel_profile``.
#: "static" is the exact stationary paper model; the rest are the drift
#: scenarios the reference's bench (`repro.launch.scenarios`) compares
#: static vs adaptive allocation on.
CHANNEL_PROFILES: dict[str, ChannelProfile] = {
    # no dynamics: bit-exact with the stationary engine
    "static": ChannelProfile(),
    # bursty erasures: ~19% of rounds in a 6x-loss bad state
    "markov_loss": ChannelProfile(ge_p_gb=0.08, ge_p_bg=0.35,
                                  ge_bad_scale=6.0),
    # slow log-normal fading quantized through the LTE CQI ladder
    "slow_fade": ChannelProfile(shadow_sigma_db=4.0, shadow_rho=0.95,
                                mcs=True),
    # undirected compute wander (thermal throttling / background load)
    "compute_drift": ChannelProfile(mu_drift_sigma=0.06),
    # network steadily speeds up (compute AND links): a round-0
    # allocation grows stale fast, wasting deadline slack every round
    "speedup_drift": ChannelProfile(mu_drift_rate=0.05,
                                    mu_drift_sigma=0.01, mu_max=8.0,
                                    tau_trend_db=-0.3, mcs=True),
    # network steadily degrades: fixed deadline loses more return mass
    # every round
    "degrade_drift": ChannelProfile(mu_drift_rate=-0.04,
                                    mu_drift_sigma=0.01, mu_min=0.15,
                                    tau_trend_db=0.15, mcs=True),
    # clients drop out and rejoin (5%/round out, 25%/round back)
    "churn": ChannelProfile(dropout_prob=0.05, rejoin_prob=0.25),
    # the stress scenario: fading + MCS hopping + degrading compute +
    # churn, all at once
    "drift_churn": ChannelProfile(shadow_sigma_db=3.0, shadow_rho=0.9,
                                  mcs=True, mu_drift_rate=-0.03,
                                  mu_drift_sigma=0.03, mu_min=0.15,
                                  dropout_prob=0.03, rejoin_prob=0.3),
}
