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
  * the divergence guard's lr backoff scale and the per-round
    masked-return / skipped-round accumulators (`FedResult.health`).

The reference's state also carries channel dynamics (the trace-stream
index and trace state, the channel estimator's statistics, the adaptive
controls and schedule record), the stale-fault iterate and fault stream,
and the hierarchical tier's sampling stream.  The port runs none of these
yet: their fields stay None here, and a payload that holds any of the
channel ones raises `NotImplementedError` on unpacking.

Modes: ``"single"`` (one trajectory, blocks advance the round cursor) and
``"multi"`` (stationary `run_multi`, blocks advance all realizations'
round cursors together) run in the port; ``"multi_channel"`` and
``"hier"`` are known, so their payloads unpack, but do not run.

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

FORMAT_VERSION = 2

_MODES = ("single", "multi", "multi_channel", "hier")

#: meta entries of the channel-dynamics state the port does not run yet
_CHANNEL_META = ("trace", "est", "controls", "has_sched")


@dataclasses.dataclass
class RunState:
    """One resumable run, between block boundaries.  See module docstring.

    Accumulator shapes by mode (r = rounds_done, R = n_realizations):

      single        t_rounds (r,)    n_ret (r,)    theta (q, c)
      multi         t_rounds (R, r)  n_ret (R, r)  theta (R, q, c)
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
    trace: Optional[Any]              # channel trace state (not ported)
    est: Optional[dict]               # channel estimator (not ported)
    controls: Optional[dict]          # adaptive controls (not ported)
    t_rounds: np.ndarray
    n_ret: np.ndarray
    losses: Optional[np.ndarray]      # (r,) NaN where not evaluated
    accs: Optional[np.ndarray]
    sched: Optional[dict]             # adaptive record (not ported)
    lr_scale: Any = None              # divergence-backoff lr multiplier,
                                      # () for single / (R,) for multi
    n_masked: Optional[np.ndarray] = None  # per-round masked returns
    skipped: Optional[np.ndarray] = None   # per-round 0/1 divergence skips
    theta_prev: Any = None            # stale-fault iterate (not ported)
    fault_rng_state: Optional[dict] = None  # fault stream (not ported)
    sample_rng_state: Optional[dict] = None  # hier sampling (not ported)

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
    if any(getattr(state, f) is not None
           for f in ("trace", "est", "controls", "sched")):
        raise NotImplementedError(
            "the PyTorch port does not support channel dynamics yet; "
            "this state carries channel-trace or adaptive fields")
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
        "has_sched": False,
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
    return arrays, meta


def unpack_state(arrays: dict, meta: dict, device=None) -> RunState:
    """(arrays, meta) -> RunState, theta on `device` (the GPU unless the
    caller asks for another); inverse of `pack_state`."""
    if meta.get("format") != FORMAT_VERSION:
        raise ValueError(f"run-state format {meta.get('format')!r} not "
                         f"supported (this build reads {FORMAT_VERSION})")
    held = [key for key in _CHANNEL_META if meta.get(key)]
    if held:
        raise NotImplementedError(
            "the PyTorch port does not support channel dynamics yet; the "
            f"checkpoint holds {held}")
    dev = resolve_device(device)

    def tensor(key):
        return torch.from_numpy(np.array(arrays[key], copy=True)).to(dev)

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
        trace=None, est=None, controls=None,
        t_rounds=np.asarray(arrays["t_rounds"]),
        n_ret=np.asarray(arrays["n_ret"]),
        losses=np.asarray(arrays["losses"]) if has_eval else None,
        accs=np.asarray(arrays["accs"]) if has_eval else None,
        sched=None,
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
