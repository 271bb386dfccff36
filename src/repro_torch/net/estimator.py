"""Online channel estimation and adaptive load re-allocation (the port
of ``repro.net.estimator``).

`OnlineChannelEstimator` turns the per-round telemetry the MEC
orchestrator collects (`trace.RoundObservations`) into running estimates
of every node's delay parameters ``(mu, tau, p)`` plus an availability
score.  It smooths the *sufficient statistics* — EWMAs by default,
windowed means otherwise (the exact MLE for the model's exponential /
geometric families over the window) — and inverts them only at readout,
so the estimates stay free of the Jensen bias that smoothing per-round
ratios would pick up:

  s_tau  <- (t_down + t_up) / N, N = n_down + n_up  (= tau exactly)
  s_ntr  <- N                      =>  p_hat  = 1 - 2 / s_ntr
  s_comp <- t_comp / load          =>  mu_hat = (1 + 1/alpha) / s_comp

`plan_segment` is the host-side control loop of the adaptive schemes: it
walks a block of the run in sub-blocks of ``adapt_every`` rounds,
samples each sub-block's delays through the network trace (consuming the
run's RNG exactly like the static pre-sampling path), feeds the telemetry
to the estimator, and asks the scheme to re-plan — re-solving the paper's
two-step load allocation on the *estimated* network for the coded family,
re-tuning the wait count for the greedy family.  Its per-round arrays
(delays, availability, deadlines, wait counts) go to the device once a
block; the coded family's per-sub-block load masks are stacked into one
(B, n+1, L) float32 tensor on the experiment's device, which the round
indexes by sub-block: shapes never change across re-plans.

Everything but that mask stack is NumPy, the same code as the
reference's on the same generator, so every plan is bit-identical to it.
The network simulation never depends on model state, which is what lets
the whole loop run ahead of a block's rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import torch

from repro_torch.core.delay_model import NodeDelayParams
from repro_torch.net.trace import (NetworkTrace, RoundObservations,
                             sample_round_observations)

# floors keeping estimated NodeDelayParams constructible under heavy noise
_MU_FLOOR = 1e-9
_TAU_FLOOR = 1e-12
_P_CEIL = 0.95


class OnlineChannelEstimator:
    """EWMA / windowed estimates of per-node (mu, tau, p, availability).

    Estimates warm-start from the *nominal* node parameters, so a
    controller that re-plans before any telemetry arrives reproduces the
    static allocation.  Telemetry from churned-out rounds never updates a
    node's link/compute estimates (no upload was seen), only its
    availability score.
    """

    def __init__(self, nodes: "list[NodeDelayParams]", *, beta: float = 0.25,
                 window: Optional[int] = None):
        if not (0.0 < beta <= 1.0):
            raise ValueError(f"beta={beta} must lie in (0, 1]")
        if window is not None and window < 1:
            raise ValueError(f"window={window} must be >= 1")
        self.n = len(nodes)
        self.alpha = np.array([nd.alpha for nd in nodes], np.float64)
        self.beta = float(beta)
        self.window = window
        # sufficient statistics, warm-started at their nominal expectations
        self._s_tau = np.array(
            [(nd.tau + nd._tau_up) / 2.0 for nd in nodes], np.float64)
        p0 = np.array([(nd.p + nd._p_up) / 2.0 for nd in nodes], np.float64)
        self._s_ntr = 2.0 / (1.0 - p0)
        mu0 = np.array([nd.mu for nd in nodes], np.float64)
        self._s_comp = (1.0 + 1.0 / self.alpha) / mu0
        self.avail_hat = np.ones(self.n, np.float64)
        self.rounds_seen = 0
        # ring buffers for the windowed mode (one (n,) row per round,
        # NaN = unobserved)
        self._win: dict[str, list[np.ndarray]] = {
            "comp": [], "tau": [], "ntr": [], "avail": []}

    # ------------------------------------------------------------- updates
    def update(self, obs: RoundObservations) -> None:
        """Fold a block of round observations in, one round at a time."""
        R = obs.total.shape[0]
        for r in range(R):
            seen = np.asarray(obs.active[r], bool)
            ntr = (obs.n_down[r] + obs.n_up[r]).astype(np.float64)
            tau_obs = np.where(seen, (obs.t_down[r] + obs.t_up[r])
                               / np.maximum(ntr, 1.0), np.nan)
            ntr_obs = np.where(seen, ntr, np.nan)
            loaded = seen & (obs.loads[r] > 0.0)
            comp_obs = np.where(
                loaded, obs.t_comp[r] / np.maximum(obs.loads[r], 1e-30),
                np.nan)
            if self.window is None:
                self._ewma("_s_tau", tau_obs)
                self._ewma("_s_ntr", ntr_obs)
                self._ewma("_s_comp", comp_obs)
                self.avail_hat = ((1.0 - self.beta) * self.avail_hat
                                  + self.beta * seen.astype(np.float64))
            else:
                self._push("tau", tau_obs)
                self._push("ntr", ntr_obs)
                self._push("comp", comp_obs)
                self._push("avail", seen.astype(np.float64))
            self.rounds_seen += 1
        if self.window is not None:
            self._refresh_windowed()

    def _ewma(self, attr: str, obs: np.ndarray) -> None:
        cur = getattr(self, attr)
        upd = (1.0 - self.beta) * cur + self.beta * obs
        setattr(self, attr, np.where(np.isnan(obs), cur, upd))

    def _push(self, key: str, row: np.ndarray) -> None:
        buf = self._win[key]
        buf.append(row)
        if len(buf) > self.window:
            del buf[: len(buf) - self.window]

    def _refresh_windowed(self) -> None:
        # explicit NaN-masked mean: an all-NaN column (a node unseen for
        # the whole window) keeps its previous estimate, without the
        # RuntimeWarning np.nanmean emits on empty slices
        for key, attr in (("comp", "_s_comp"), ("tau", "_s_tau"),
                          ("ntr", "_s_ntr"), ("avail", "avail_hat")):
            if not self._win[key]:
                continue
            stacked = np.stack(self._win[key])
            seen = ~np.isnan(stacked)
            count = seen.sum(axis=0)
            total = np.where(seen, stacked, 0.0).sum(axis=0)
            mean = total / np.maximum(count, 1)
            cur = getattr(self, attr)
            setattr(self, attr, np.where(count > 0, mean, cur))

    # ------------------------------------------------------------ readouts
    @property
    def mu_hat(self) -> np.ndarray:
        return (1.0 + 1.0 / self.alpha) / np.maximum(self._s_comp, 1e-30)

    @property
    def tau_hat(self) -> np.ndarray:
        return self._s_tau.copy()

    @property
    def p_hat(self) -> np.ndarray:
        return np.clip(1.0 - 2.0 / np.maximum(self._s_ntr, 2.0), 0.0,
                       _P_CEIL)

    def estimated_nodes(self) -> "list[NodeDelayParams]":
        """The estimated network, ready for the load-allocation solver."""
        mu = np.maximum(self.mu_hat, _MU_FLOOR)
        tau = np.maximum(self.tau_hat, _TAU_FLOOR)
        p = np.clip(self.p_hat, 0.0, _P_CEIL)
        return [NodeDelayParams(mu=float(mu[j]), alpha=float(self.alpha[j]),
                                tau=float(tau[j]), p=float(p[j]))
                for j in range(self.n)]

    def snapshot(self) -> dict:
        return {"mu": self.mu_hat.copy(), "tau": self.tau_hat.copy(),
                "p": self.p_hat.copy(), "avail": self.avail_hat.copy(),
                "rounds_seen": self.rounds_seen}

    # ------------------------------------------------------- checkpointing
    def state_dict(self) -> dict:
        """Everything needed to continue estimation bit-exactly: the
        sufficient statistics, availability score, round counter, and the
        windowed mode's ring buffers (stacked to (k, n) arrays)."""
        return {
            "beta": self.beta, "window": self.window,
            "rounds_seen": int(self.rounds_seen),
            "s_tau": self._s_tau.copy(), "s_ntr": self._s_ntr.copy(),
            "s_comp": self._s_comp.copy(),
            "avail_hat": self.avail_hat.copy(),
            "win": {key: (np.stack(buf) if buf
                          else np.zeros((0, self.n), np.float64))
                    for key, buf in self._win.items()},
        }

    def load_state_dict(self, state: dict) -> None:
        """Inverse of `state_dict`; the estimator must have been built
        with the same smoothing configuration (beta/window)."""
        if (float(state["beta"]) != self.beta
                or state["window"] != self.window):
            raise ValueError(
                f"estimator state was produced with beta={state['beta']}, "
                f"window={state['window']}; this estimator has "
                f"beta={self.beta}, window={self.window}")
        for attr, key in (("_s_tau", "s_tau"), ("_s_ntr", "s_ntr"),
                          ("_s_comp", "s_comp"), ("avail_hat", "avail_hat")):
            arr = np.asarray(state[key], np.float64)
            if arr.shape != (self.n,):
                raise ValueError(f"estimator state {key!r} has shape "
                                 f"{arr.shape}, expected ({self.n},)")
            setattr(self, attr, arr.copy())
        self.rounds_seen = int(state["rounds_seen"])
        self._win = {key: [np.asarray(row, np.float64).copy()
                           for row in np.asarray(state["win"][key])]
                     for key in self._win}


@dataclasses.dataclass
class AdaptiveSchedule:
    """Dense per-round control arrays for one adaptive run.

    ``times``/``active`` drive the round outcomes; ``block_idx`` maps each
    round to its allocation block; the coded family carries per-round
    deadlines (``t_star``) plus per-block load masks (``gmask_blocks``,
    shape (B, rows, L) — same row/point layout as the fused step tensors,
    so re-allocation is pure mask re-weighting); the greedy family carries
    per-round wait counts (``n_wait``).  ``loads_blocks`` and
    ``estimates`` record the controller's trajectory for inspection.
    ``gmask_blocks`` is a tensor on the experiment's device; the rest is
    NumPy.
    """
    times: np.ndarray                       # (R, n) float64 delays
    active: np.ndarray                      # (R, n) float32 churn mask
    block_idx: np.ndarray                   # (R,) int32
    loads_blocks: np.ndarray                # (B, n) float64
    t_star: Optional[np.ndarray] = None     # (R,) float32 (coded family)
    n_wait: Optional[np.ndarray] = None     # (R,) int32  (greedy family)
    gmask_blocks: Optional[torch.Tensor] = None  # (B, rows, L) float32
    estimates: list = dataclasses.field(default_factory=list)

    @property
    def n_blocks(self) -> int:
        return self.loads_blocks.shape[0]


@dataclasses.dataclass
class SegmentPlan:
    """One contiguous segment of an adaptive run's control plan.

    Produced by `plan_segment` for global rounds ``[r0, r1)``; the
    per-round arrays are segment-local, ``block_idx`` indexes into this
    segment's ``loads_blocks``/``gmask_blocks``, and ``controls`` carries
    the live control values forward so the next segment continues exactly
    where this one stopped.
    """
    times: np.ndarray                       # (r1-r0, n) float64 delays
    active: np.ndarray                      # (r1-r0, n) float32 churn mask
    block_idx: np.ndarray                   # (r1-r0,) int32, segment-local
    t_star_r: np.ndarray                    # (r1-r0,) float32
    n_wait_r: np.ndarray                    # (r1-r0,) int32
    loads_blocks: np.ndarray                # (B_seg, n) float64
    gmask_blocks: Optional[torch.Tensor]    # (B_seg, rows, L) (coded)
    estimates: list                         # one snapshot per sub-block
    controls: dict                          # {"loads","t_star","n_wait"}


def plan_segment(exp, estimator: OnlineChannelEstimator,
                 trace_seg: NetworkTrace, r0: int, r1: int,
                 controls: dict, rng: np.random.Generator) -> SegmentPlan:
    """Plan global rounds ``[r0, r1)`` of an adaptive run incrementally.

    `trace_seg` covers exactly this segment (local round 0 = global
    ``r0``); `controls` holds the loads/deadline/wait-count in effect at
    ``r0`` and `estimator` the telemetry folded in so far — together they
    are the full control-plane state, so chaining segments reproduces the
    one-shot plan bit-exactly as long as every segment boundary lands on
    an ``adapt_every`` multiple (the runtime validates that).  Re-planning
    happens at every global round that is a positive multiple of
    ``adapt_every``, including ``r0`` itself for a resumed segment.
    """
    K = exp.adapt_every
    n = exp.n
    R_seg = int(r1) - int(r0)
    if R_seg < 1:
        raise ValueError(f"empty segment [{r0}, {r1})")
    if trace_seg.rounds < R_seg:
        raise ValueError(f"trace segment covers {trace_seg.rounds} rounds, "
                         f"need {R_seg}")
    coded = exp.step_kind == "adaptive_coded"

    loads = np.asarray(controls["loads"], np.float64).copy()
    t_star = controls.get("t_star")
    n_wait = controls.get("n_wait")

    times = np.zeros((R_seg, n))
    active = np.zeros((R_seg, n), np.float32)
    block_idx = np.zeros(R_seg, np.int32)
    t_star_r = np.zeros(R_seg, np.float32)
    n_wait_r = np.zeros(R_seg, np.int32)
    loads_list, gmasks, estimates = [], [], []

    b_local = -1
    r = int(r0)
    while r < r1:
        if r > 0 and r % K == 0:
            plan_b = exp.scheme_obj.replan(exp, estimator)
            loads = np.asarray(plan_b.get("loads", loads), np.float64)
            t_star = plan_b.get("t_star", t_star)
            n_wait = plan_b.get("n_wait", n_wait)
        b_local += 1
        r_end = min(int(r1), (r // K + 1) * K)
        if coded:
            gmasks.append(exp.scheme_obj.gmask_for_loads(exp, loads))
        # block delays consume the run's RNG sequentially, exactly like
        # the static engine's one-shot pre-sampling
        obs = sample_round_observations(
            exp.nodes, loads, rng, trace_seg.slice(r - r0, r_end - r0))
        estimator.update(obs)
        lo, hi = r - r0, r_end - r0
        times[lo:hi] = obs.total
        active[lo:hi] = obs.active.astype(np.float32)
        block_idx[lo:hi] = b_local
        if t_star is not None:
            t_star_r[lo:hi] = t_star
        n_wait_r[lo:hi] = n_wait
        loads_list.append(loads.copy())
        estimates.append(estimator.snapshot())
        r = r_end

    # the sub-blocks' masks, one (B_seg, n+1, L) tensor on the device
    gmask_blocks = torch.stack(gmasks) if coded else None
    return SegmentPlan(
        times=times, active=active, block_idx=block_idx,
        t_star_r=t_star_r, n_wait_r=n_wait_r,
        loads_blocks=np.stack(loads_list), gmask_blocks=gmask_blocks,
        estimates=estimates,
        controls={"loads": loads.copy(), "t_star": t_star,
                  "n_wait": n_wait})


class AdaptiveController:
    """Blockwise re-estimation + re-allocation for a whole run ahead of its
    rounds (the runtime plans block by block with `plan_segment`)."""

    def __init__(self, exp, trace: NetworkTrace, *,
                 estimator: Optional[OnlineChannelEstimator] = None):
        if exp.adapt_every < 1:
            raise ValueError(
                "adaptive schemes need ExperimentSpec.adapt_every >= 1 "
                f"(got {exp.adapt_every})")
        self.exp = exp
        self.trace = trace
        self.estimator = estimator or OnlineChannelEstimator(
            exp.nodes, **exp.scheme_params_estimator_kwargs())

    def plan(self, iterations: int) -> AdaptiveSchedule:
        """One-shot plan for a whole run: a single segment from round 0
        seeded with the scheme's setup-time controls."""
        exp = self.exp
        R = int(iterations)
        if self.trace.rounds < R:
            raise ValueError(f"trace covers {self.trace.rounds} rounds, "
                             f"need {R}")
        seg = plan_segment(exp, self.estimator, self.trace, 0, R,
                           exp.scheme_obj.initial_controls(exp), exp.rng)
        sched = AdaptiveSchedule(
            times=seg.times, active=seg.active, block_idx=seg.block_idx,
            loads_blocks=seg.loads_blocks, estimates=seg.estimates)
        if exp.step_kind == "adaptive_coded":
            sched.t_star = seg.t_star_r
            sched.gmask_blocks = seg.gmask_blocks
        else:
            sched.n_wait = seg.n_wait_r
        return sched
