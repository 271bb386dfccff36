"""Post-hoc straggler attribution from the run's materialized delay arrays.

The port of ``repro.obs.attribution`` (NumPy, the reference's code).  The
engine draws every block's per-client delays into host arrays before it
uploads them (`fed_runtime.Experiment._block_single`).  With telemetry
enabled (`repro_torch.obs.spans.enable`) those already-materialized
blocks are kept — a NumPy reference per block, no random stream touched,
no extra draw, no device read — and this module turns them into the
paper's delay analysis, per client:

  * **deadline-miss rate** — fraction of rounds a client exceeded the
    round deadline (t* for the coded family, the n_wait-th order
    statistic for the greedy family, the round max for naive);
  * **slowest-k contributions** — how often the client was among the k
    slowest present that round (who *drives* the tail, not just who
    misses);
  * **coded-compensation share** — per round, the fraction of the data
    mass the parity gradient stood in for: ``1 - sum_j l_j r_j / m``
    (a data-mass proxy for the parity share of the update, exact for
    the uniform-weight limit; 0 for schemes with no parity).

Exposed as ``Experiment.attribution()``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Attribution", "compute_attribution", "round_deadlines"]


@dataclasses.dataclass
class Attribution:
    """Straggler attribution over one run's captured rounds."""
    rounds: int                  # rounds covered
    k: int                       # slowest-k window
    miss_rate: np.ndarray        # (n,) deadline-miss rate per client
    miss_counts: np.ndarray      # (n,) rounds missed
    active_rounds: np.ndarray    # (n,) rounds the client was present
    slowest_k_counts: np.ndarray  # (n,) rounds among the k slowest present
    comp_share: np.ndarray       # (rounds,) coded-compensation data share

    def top_stragglers(self, count: int = 5) -> "list[tuple[int, float]]":
        """[(client, miss_rate)] sorted worst-first, ties by client id."""
        order = np.lexsort((np.arange(len(self.miss_rate)),
                            -self.miss_rate))
        return [(int(j), float(self.miss_rate[j]))
                for j in order[:count]]

    def to_dict(self) -> dict:
        return {
            "rounds": int(self.rounds),
            "k": int(self.k),
            "miss_rate": [float(v) for v in self.miss_rate],
            "miss_counts": [int(v) for v in self.miss_counts],
            "active_rounds": [int(v) for v in self.active_rounds],
            "slowest_k_counts": [int(v) for v in self.slowest_k_counts],
            "comp_share_mean": float(self.comp_share.mean())
            if len(self.comp_share) else 0.0,
            "top_stragglers": [[j, r] for j, r in self.top_stragglers()],
        }


def round_deadlines(step_kind: str, times: np.ndarray, active: np.ndarray,
                    *, t_star=None, t_ideal=None, n_wait=None,
                    t_star_r=None, n_wait_r=None) -> np.ndarray:
    """(T,) per-round deadline implied by the scheme's step kind.

    Mirrors `fed_runtime.build_step`'s deadline logic on the host:
    coded uses the (possibly re-planned) t*, greedy the n_wait-th order
    statistic among clients present, naive the max over clients present,
    ideal its deterministic round clock.
    """
    T, n = times.shape
    if step_kind == "coded":
        if t_star_r is not None:
            return np.asarray(t_star_r, np.float64)
        return np.full(T, float(t_star), np.float64)
    if step_kind == "adaptive_coded":
        return np.asarray(t_star_r, np.float64)
    if step_kind == "ideal":
        return np.full(T, float(t_ideal), np.float64)
    if step_kind == "naive":
        masked = np.where(active > 0, times, 0.0)
        return masked.max(axis=1)
    if step_kind in ("greedy", "adaptive_greedy"):
        waits = (np.asarray(n_wait_r, np.int64) if n_wait_r is not None
                 else np.full(T, int(n_wait), np.int64))
        srt = np.sort(np.where(active > 0, times, np.inf), axis=1)
        n_act = (active > 0).sum(axis=1)
        k_eff = np.clip(np.minimum(waits, n_act), 1, n)
        dl = srt[np.arange(T), k_eff - 1]
        return np.where(n_act > 0, dl, 0.0)
    raise ValueError(f"unknown step kind {step_kind!r}")


def compute_attribution(times: np.ndarray, active, deadline: np.ndarray,
                        *, loads=None, m=None, coded: bool = False,
                        k: int = 3) -> Attribution:
    """Attribution over (T, n) delay samples against (T,) deadlines.

    `active` is the (T, n) presence mask (churn / sampled cohorts), or
    None for all-present runs.  `loads`/`m` feed the coded-compensation
    data share when `coded`.
    """
    times = np.asarray(times, np.float64)
    T, n = times.shape
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    active = (np.ones((T, n), bool) if active is None
              else np.asarray(active) > 0)
    deadline = np.asarray(deadline, np.float64)
    miss = (times > deadline[:, None]) & active
    active_rounds = active.sum(axis=0)
    miss_counts = miss.sum(axis=0)
    miss_rate = miss_counts / np.maximum(active_rounds, 1)
    # slowest-k among clients PRESENT each round: absent clients sort
    # first at -inf, so the tail of the argsort is the live tail — but
    # guard rounds with fewer than k present
    order = np.argsort(np.where(active, times, -np.inf), axis=1,
                       kind="stable")
    tail = order[:, -min(k, n):]
    tail_live = np.take_along_axis(active, tail, axis=1)
    slowest = np.zeros(n, np.int64)
    np.add.at(slowest, tail[tail_live], 1)
    if coded:
        ret = (~miss) & active
        mass = (np.asarray(loads, np.float64)[None, :] * ret).sum(axis=1)
        comp_share = np.clip(1.0 - mass / float(m), 0.0, 1.0)
    else:
        comp_share = np.zeros(T, np.float64)
    return Attribution(rounds=T, k=int(min(k, n)), miss_rate=miss_rate,
                       miss_counts=miss_counts,
                       active_rounds=active_rounds,
                       slowest_k_counts=slowest, comp_share=comp_share)


def attribution_from_blocks(blocks: "list[dict]", step_kind: str, *,
                            t_star=None, t_ideal=None, n_wait=None,
                            loads=None, m=None, k: int = 3) -> Attribution:
    """Concatenate per-block captures (`fed_runtime._block_single`) and
    attribute.  Each block dict: ``times`` (K, n), optional ``active``
    (K, n), optional per-round controls ``t_star_r`` / ``n_wait_r``."""
    if not blocks:
        raise RuntimeError(
            "no telemetry captured for this run: call "
            "repro_torch.obs.spans.enable() before running, then "
            "attribution()")
    times = np.concatenate([np.asarray(b["times"], np.float64)
                            for b in blocks])
    active = np.concatenate(
        [np.asarray(b["active"], np.float64) if b.get("active") is not None
         else np.ones_like(np.asarray(b["times"], np.float64))
         for b in blocks])
    has_tsr = any(b.get("t_star_r") is not None for b in blocks)
    has_nwr = any(b.get("n_wait_r") is not None for b in blocks)
    t_star_r = (np.concatenate([np.asarray(b["t_star_r"], np.float64)
                                for b in blocks]) if has_tsr else None)
    n_wait_r = (np.concatenate([np.asarray(b["n_wait_r"], np.int64)
                                for b in blocks]) if has_nwr else None)
    deadline = round_deadlines(step_kind, times, active, t_star=t_star,
                               t_ideal=t_ideal, n_wait=n_wait,
                               t_star_r=t_star_r, n_wait_r=n_wait_r)
    return compute_attribution(
        times, active, deadline, loads=loads, m=m,
        coded=step_kind in ("coded", "adaptive_coded"), k=k)
