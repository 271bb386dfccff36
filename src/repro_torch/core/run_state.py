"""Explicit, serializable state of a block-structured federated run.

The port of ``repro.core.run_state``.  `RunState` is everything
`Experiment.run_block` needs to advance a run by one block, and therefore
everything a checkpoint needs to resume it bit-identically after a kill:

  * the model carry ``theta`` (a tensor on the experiment's device) and the
    global round cursor (the lr-schedule position is derived from the
    cursor, never stored),
  * the run RNG's bit-generator state (delay draws continue mid-stream),
  * the per-round accumulators that become the final `FedResult` history
    (round times, returned counts, eval losses),
  * the trace-stream index and live `repro_torch.net.trace.TraceState` of
    the channel trace, the `OnlineChannelEstimator` sufficient statistics,
    the adaptive control values (loads / deadline / wait count) in effect
    and the adaptive schedule record,
  * the divergence guard's lr backoff scale and the per-round
    masked-return / skipped-round accumulators (`FedResult.health`),
  * with return faults, the fault stream's bit-generator state, and under
    stale replay the iterate the next round's stale rows read
    (``theta_prev``, a tensor on the experiment's device),
  * for the hierarchical tier, the client-sampling stream's
    bit-generator state (``sample_rng_state``).

Modes: ``"single"`` (one trajectory, blocks advance the round cursor),
``"multi"`` (stationary `run_multi`, blocks advance all realizations'
round cursors together), ``"multi_channel"`` (traced `run_multi`, a
block is one whole realization with its own trace) and ``"hier"`` (a
`repro_torch.hier.HierExperiment` run: one trajectory over the shards,
blocks advance the round cursor and both the delay and the sampling
stream).

`pack_state`/`unpack_state` convert to/from the (arrays, JSON-meta)
payload of `repro_torch.checkpoint.io.save_state` with the reference's
keys, array dtypes and meta layout, so a checkpoint either package writes
loads in the other.  NumPy PCG64 states are plain-int dicts, so the RNG
round-trips exactly through JSON.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.net.trace import TraceState

FORMAT_VERSION = 2

_MODES = ("single", "multi", "multi_channel", "hier")

#: per-sub-block adaptive schedule record arrays, (B, n) unless noted
SCHED_KEYS = ("times", "active", "block_idx", "t_star_r", "n_wait_r",
              "loads_blocks", "est_mu", "est_tau", "est_p", "est_avail",
              "est_rounds_seen")

_WIN_KEYS = ("comp", "tau", "ntr", "avail")
_TRACE_KEYS = ("ge_bad", "shadow_x", "drift_g", "churn_active")
_EST_KEYS = ("s_tau", "s_ntr", "s_comp", "avail_hat")

#: the arrays each channel part of the meta promises
_CHANNEL_ARRAYS = {
    "trace": tuple(f"trace/{k}" for k in _TRACE_KEYS),
    "est": (tuple(f"est/{k}" for k in _EST_KEYS)
            + tuple(f"est/win_{k}" for k in _WIN_KEYS)),
    "controls": ("controls/loads",),
    "has_sched": tuple(f"sched/{k}" for k in SCHED_KEYS),
}


@dataclasses.dataclass
class RunState:
    """One resumable run, between block boundaries.  See module docstring.

    Accumulator shapes by mode (r = rounds_done, R = n_realizations):

      single        t_rounds (r,)    n_ret (r,)    theta (q, c)
      multi         t_rounds (R, r)  n_ret (R, r)  theta (R, q, c)
      multi_channel t_rounds (realizations_done, T), theta (R, q, c)
                    with rows past ``realizations_done`` still zero
      hier          t_rounds (r,)    n_ret (r,)    theta (q, c)
    """
    mode: str
    iterations: int
    rounds_done: int
    realizations_done: int
    n_realizations: Optional[int]
    collect: bool                     # eval losses collected per block
    theta: Any                        # torch.Tensor
    rng_state: dict                   # run RNG (delay draws)
    trace_call: int                   # base trace-stream index (-1 = none)
    trace: Optional[TraceState]       # channel trace cursor
    est: Optional[dict]               # OnlineChannelEstimator.state_dict()
    controls: Optional[dict]          # {"loads", "t_star", "n_wait"}
    t_rounds: np.ndarray
    n_ret: np.ndarray
    losses: Optional[np.ndarray]      # (r,) NaN where not evaluated
    accs: Optional[np.ndarray]
    sched: Optional[dict]             # adaptive record, keys SCHED_KEYS
    lr_scale: Any = None              # divergence-backoff lr multiplier,
                                      # () for single / (R,) for multi
    n_masked: Optional[np.ndarray] = None  # per-round masked returns
    skipped: Optional[np.ndarray] = None   # per-round 0/1 divergence skips
    theta_prev: Any = None            # previous-round iterate (a tensor,
                                      # only under stale faults)
    fault_rng_state: Optional[dict] = None  # fault-stream RNG (PCG64)
    sample_rng_state: Optional[dict] = None  # hier client-sampling RNG

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown run mode {self.mode!r} "
                             f"(expected one of {_MODES})")

    @property
    def done(self) -> bool:
        if self.mode == "multi_channel":
            return self.realizations_done >= int(self.n_realizations)
        return self.rounds_done >= self.iterations


def _scalar(val):
    """None-preserving plain-Python scalar for JSON metadata."""
    if val is None:
        return None
    return val.item() if isinstance(val, np.generic) else val


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def pack_state(state: RunState) -> "tuple[dict, dict]":
    """RunState -> (arrays, meta) for `checkpoint.io.save_state`."""
    arrays = {
        "theta": _host(state.theta),
        "t_rounds": np.asarray(state.t_rounds),
        "n_ret": np.asarray(state.n_ret),
    }
    meta = {
        "format": FORMAT_VERSION,
        "mode": state.mode,
        "iterations": int(state.iterations),
        "rounds_done": int(state.rounds_done),
        "realizations_done": int(state.realizations_done),
        "n_realizations": _scalar(state.n_realizations),
        "collect": bool(state.collect),
        "rng_state": state.rng_state,
        "trace_call": int(state.trace_call),
        "has_eval": state.losses is not None,
        "trace": None,
        "est": None,
        "controls": None,
        "has_sched": state.sched is not None,
        "fault_rng_state": state.fault_rng_state,
        "sample_rng_state": state.sample_rng_state,
    }
    if state.lr_scale is not None:
        arrays["lr_scale"] = np.asarray(state.lr_scale, np.float64)
    if state.n_masked is not None:
        arrays["n_masked"] = np.asarray(state.n_masked)
        arrays["skipped"] = np.asarray(state.skipped)
    if state.theta_prev is not None:
        arrays["theta_prev"] = _host(state.theta_prev)
    if state.losses is not None:
        arrays["losses"] = np.asarray(state.losses)
        arrays["accs"] = np.asarray(state.accs)
    if state.trace is not None:
        meta["trace"] = {"rng_state": state.trace.rng_state,
                         "rounds_done": int(state.trace.rounds_done)}
        for key in _TRACE_KEYS:
            arrays[f"trace/{key}"] = getattr(state.trace, key)
    if state.est is not None:
        est = state.est
        meta["est"] = {"beta": float(est["beta"]),
                       "window": _scalar(est["window"]),
                       "rounds_seen": int(est["rounds_seen"])}
        for key in _EST_KEYS:
            arrays[f"est/{key}"] = np.asarray(est[key])
        for key in _WIN_KEYS:
            arrays[f"est/win_{key}"] = np.asarray(est["win"][key])
    if state.controls is not None:
        meta["controls"] = {
            "t_star": _scalar(state.controls.get("t_star")),
            "n_wait": _scalar(state.controls.get("n_wait"))}
        arrays["controls/loads"] = np.asarray(state.controls["loads"],
                                              np.float64)
    if state.sched is not None:
        for key in SCHED_KEYS:
            arrays[f"sched/{key}"] = np.asarray(state.sched[key])
    return arrays, meta


def unpack_state(arrays: dict, meta: dict, device=None) -> RunState:
    """(arrays, meta) -> RunState, theta on `device` (the GPU unless the
    caller asks for another); inverse of `pack_state`."""
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(f"run-state format {meta.get('format')!r} not "
                         f"supported (this build reads {FORMAT_VERSION})")
    for part, keys in _CHANNEL_ARRAYS.items():
        missing = [k for k in keys if k not in arrays]
        if meta.get(part) and missing:
            raise ValueError(
                f"run-state payload declares channel state {part!r} but "
                f"lacks its arrays {missing}")
    dev = resolve_device(device)

    def tensor(key):
        return torch.from_numpy(np.array(arrays[key], copy=True)).to(dev)

    trace = None
    if meta["trace"] is not None:
        trace = TraceState(
            rng_state=meta["trace"]["rng_state"],
            rounds_done=int(meta["trace"]["rounds_done"]),
            ge_bad=np.asarray(arrays["trace/ge_bad"], bool),
            shadow_x=np.asarray(arrays["trace/shadow_x"], np.float64),
            drift_g=np.asarray(arrays["trace/drift_g"], np.float64),
            churn_active=np.asarray(arrays["trace/churn_active"], bool))
    est = None
    if meta["est"] is not None:
        est = {"beta": meta["est"]["beta"],
               "window": meta["est"]["window"],
               "rounds_seen": meta["est"]["rounds_seen"],
               "win": {key: np.asarray(arrays[f"est/win_{key}"])
                       for key in _WIN_KEYS}}
        for key in _EST_KEYS:
            est[key] = np.asarray(arrays[f"est/{key}"])
    controls = None
    if meta["controls"] is not None:
        controls = {"loads": np.asarray(arrays["controls/loads"],
                                        np.float64),
                    "t_star": meta["controls"]["t_star"],
                    "n_wait": meta["controls"]["n_wait"]}
    sched = None
    if meta.get("has_sched"):
        sched = {key: np.asarray(arrays[f"sched/{key}"])
                 for key in SCHED_KEYS}
    has_eval = bool(meta.get("has_eval"))
    return RunState(
        mode=meta["mode"],
        iterations=int(meta["iterations"]),
        rounds_done=int(meta["rounds_done"]),
        realizations_done=int(meta["realizations_done"]),
        n_realizations=meta["n_realizations"],
        collect=bool(meta["collect"]),
        theta=tensor("theta"),
        rng_state=meta["rng_state"],
        trace_call=int(meta["trace_call"]),
        trace=trace, est=est, controls=controls,
        t_rounds=np.asarray(arrays["t_rounds"]),
        n_ret=np.asarray(arrays["n_ret"]),
        losses=np.asarray(arrays["losses"]) if has_eval else None,
        accs=np.asarray(arrays["accs"]) if has_eval else None,
        sched=sched,
        lr_scale=(np.asarray(arrays["lr_scale"])
                  if "lr_scale" in arrays else None),
        n_masked=(np.asarray(arrays["n_masked"])
                  if "n_masked" in arrays else None),
        skipped=(np.asarray(arrays["skipped"])
                 if "skipped" in arrays else None),
        theta_prev=(tensor("theta_prev")
                    if "theta_prev" in arrays else None),
        fault_rng_state=meta.get("fault_rng_state"),
        sample_rng_state=meta.get("sample_rng_state"))
