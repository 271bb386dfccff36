"""Append-only JSONL run journal: one event per completed round.

The port of ``repro.obs.events``.  `RunJournal` lives next to a run's
checkpoints (``root/<run_id>/events.jsonl``) and records, per round: the
simulated round time and cumulative wall-clock, the return count, the
non-finite-guard mask count, the divergence-guard skip flag, the effective
lr backoff multiplier, and the evaluated loss/accuracy (null when not
evaluated that round).

Every quantity journaled is *simulated* or derived from the run's state —
no host timestamps, no environment — so the journal is a deterministic
function of (spec, seed): two runs of the same spec and seed produce
byte-identical files.  Lines are serialized with sorted keys and compact
separators, and each block's lines are written with a single ``O_APPEND``
write, so concurrent readers never see a torn line from a live writer.
The fields are host quantities of the `RunState` (float64 round times,
int32 returns, int64 guard counters), held in the reference's dtypes, so a
run without an ``eval_fn`` journals the same bytes in both packages.

The journal is rebuilt from `RunState` accumulators, which carry the full
round history from round 0 — so `sync` after any block (including the
first block after a resume) can fill whatever suffix is missing, and a
journal lost with its directory is fully regrown by the resumed run.
`history_from_journal` reconstructs the exact ``FedResult.history`` list
the runtime would have produced (same floats — JSON round-trips Python
floats exactly).  A hierarchical run (`repro_torch.hier.HierExperiment`,
a ``"hier"`` state) journals one event a round too, with the per-shard
deadlines ``t_star_s``.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np

from repro_torch.obs import spans as obs_spans

__all__ = ["RunJournal", "EVENTS_NAME", "load_events",
           "history_from_journal", "histories_equal"]

#: journal filename inside a run directory
EVENTS_NAME = "events.jsonl"


def _resolve(path: str) -> str:
    """A directory means ``<dir>/events.jsonl``; a file path is itself."""
    if path.endswith(".jsonl"):
        return path
    return os.path.join(path, EVENTS_NAME)


def _null_if_nan(value: float):
    value = float(value)
    return None if math.isnan(value) else value


def _nan_if_null(value) -> float:
    return float("nan") if value is None else float(value)


def _encode(event: dict) -> bytes:
    # sorted keys + compact separators + allow_nan=False: the byte
    # serialization is a pure function of the event values (NaN must be
    # mapped to null by the caller, never emitted)
    return (json.dumps(event, sort_keys=True, separators=(",", ":"),
                       allow_nan=False) + "\n").encode()


def _valid_prefix(raw: bytes) -> "tuple[list[dict], int]":
    """(events, byte length) of the valid contiguous round prefix (0, 1,
    2, ...) of a journal's bytes: parsing stops at a torn tail (a kill
    mid-append), an unparsable line, or a gap."""
    events = []
    valid_len = 0
    for line in raw.splitlines(keepends=True):
        if not line.endswith(b"\n"):
            break
        try:
            event = json.loads(line)
        except json.JSONDecodeError:
            break
        if not isinstance(event, dict) or event.get("round") != len(events):
            break
        events.append(event)
        valid_len += len(line)
    return events, valid_len


class RunJournal:
    """One run's ``events.jsonl``: appends per-block, trims on resume.

    ``path`` is the run directory (conventionally the checkpoint dir) or
    the journal file itself.  Opening an existing journal parses it and
    truncates any torn trailing line (a kill mid-append), so appends
    always extend valid content.
    """

    def __init__(self, path: str):
        self.path = _resolve(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._events: "list[dict]" = []
        self._load_existing()

    @property
    def rounds_logged(self) -> int:
        return len(self._events)

    def _load_existing(self) -> None:
        """Parse the file into memory, keeping only the valid contiguous
        round prefix; truncate the file past it."""
        try:
            with open(self.path, "rb") as fh:
                raw = fh.read()
        except FileNotFoundError:
            return
        self._events, valid_len = _valid_prefix(raw)
        if valid_len != len(raw):
            with open(self.path, "r+b") as fh:
                fh.truncate(valid_len)

    # ----------------------------------------------------------- writing
    def reset_to(self, rounds: int) -> None:
        """Keep only events for rounds < `rounds` (atomic rewrite).

        Called before resuming: a journal ahead of the restored state
        (blocks computed, journaled, then lost to a checkpoint rollback)
        is trimmed back so `sync` re-appends the authoritative replay.
        A fresh run calls ``reset_to(0)``.
        """
        rounds = int(rounds)
        if rounds >= len(self._events):
            return
        self._events = self._events[:rounds]
        data = b"".join(_encode(e) for e in self._events)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
        os.replace(tmp, self.path)

    def append_events(self, events: "list[dict]") -> None:
        """Append pre-built events (one O_APPEND write for the batch)."""
        if not events:
            return
        for k, event in enumerate(events):
            if event.get("round") != len(self._events) + k:
                raise ValueError(
                    f"journal {self.path!r} holds rounds 0.."
                    f"{len(self._events) - 1}; refusing non-contiguous "
                    f"append of round {event.get('round')!r}")
        data = b"".join(_encode(e) for e in events)
        with obs_spans.span("journal/append"):
            fd = os.open(self.path,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, data)
            finally:
                os.close(fd)
        self._events.extend(events)

    def sync(self, exp, state) -> int:
        """Append one event per round in [rounds_logged, rounds_done).

        `exp` is the `Experiment` (or `HierExperiment`) that produced
        `state` (the journal needs its setup_time and, for hier runs, the
        per-shard deadlines).  Returns the number of events appended.
        Only single-trajectory modes journal — one event per round has no
        meaning for a stack of realizations.
        """
        r1 = int(state.rounds_done)
        r0 = self.rounds_logged
        if r1 <= r0:
            return 0
        self.append_events(events_from_state(exp, state, r0, r1))
        return r1 - r0


def events_from_state(exp, state, r0: int, r1: int) -> "list[dict]":
    """Events for global rounds [r0, r1) from a `RunState`'s accumulators
    (which always cover the run from round 0).  A hierarchical run's
    events carry every shard's deadline (``t_star_s``) and no masked or
    skipped rounds."""
    if state.mode not in ("single", "hier"):
        raise ValueError(
            f"run journals record single-trajectory runs; mode "
            f"{state.mode!r} has {state.n_realizations} realizations")
    from repro_torch.core.fed_runtime import LR_BACKOFF
    t_rounds = np.asarray(state.t_rounds, np.float64)
    wall = float(exp.setup_time) + np.cumsum(t_rounds)
    n_ret = np.asarray(state.n_ret)
    if state.mode == "hier" or state.n_masked is None:
        n_masked = np.zeros(r1, np.int64)
        skipped = np.zeros(r1, np.int64)
    else:
        n_masked = np.asarray(state.n_masked, np.int64)
        skipped = np.asarray(state.skipped, np.int64)
    # effective lr multiplier AFTER each round: the divergence guard backs
    # off by LR_BACKOFF per skipped round (fed_runtime.build_step)
    lr_scale = LR_BACKOFF ** np.cumsum(skipped, dtype=np.float64)
    t_star_s = None
    if state.mode == "hier":
        t_star_s = [float(p.t_star) for p in exp.plans]
    events = []
    for r in range(r0, r1):
        if state.mode == "single" and state.collect:
            loss = _null_if_nan(state.losses[r])
            acc = _null_if_nan(state.accs[r])
        else:
            loss = acc = None
        event = {
            "round": int(r),
            "t_round_s": float(t_rounds[r]),
            "wall_clock_s": float(wall[r]),
            "returned": int(n_ret[r]),
            "n_masked": int(n_masked[r]),
            "skipped": int(skipped[r]),
            "lr_scale": float(lr_scale[r]),
            "loss": loss,
            "accuracy": acc,
        }
        if t_star_s is not None:
            event["t_star_s"] = t_star_s
        events.append(event)
    return events


# --------------------------------------------------------------- loading
def load_events(path: str) -> "list[dict]":
    """Read a journal -> list of round events (valid contiguous prefix).
    Read-only: a torn tail is skipped here, never truncated on disk."""
    resolved = _resolve(path)
    try:
        with open(resolved, "rb") as fh:
            raw = fh.read()
    except FileNotFoundError:
        raise FileNotFoundError(
            f"no run journal at {resolved!r}") from None
    return _valid_prefix(raw)[0]


def history_from_journal(path: str) -> list:
    """Reconstruct the `FedResult.history` list (of `RoundLog`) a
    completed run produced, exactly — floats round-trip through JSON
    bit-for-bit, nulls come back as the runtime's NaN placeholders."""
    from repro_torch.core.fed_runtime import RoundLog
    return [RoundLog(iteration=int(e["round"]),
                     wall_clock=float(e["wall_clock_s"]),
                     returned=int(e["returned"]),
                     loss=_nan_if_null(e["loss"]),
                     accuracy=_nan_if_null(e["accuracy"]),
                     n_masked=int(e["n_masked"]),
                     skipped=int(e["skipped"]))
            for e in load_events(path)]


def histories_equal(a: list, b: list) -> bool:
    """Field-exact `RoundLog` list comparison (NaN == NaN, unlike the
    dataclass ``==``, which inherits IEEE NaN inequality)."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        for field in ("iteration", "returned", "n_masked", "skipped"):
            if getattr(ra, field) != getattr(rb, field):
                return False
        for field in ("wall_clock", "loss", "accuracy"):
            va, vb = getattr(ra, field), getattr(rb, field)
            if math.isnan(va) and math.isnan(vb):
                continue
            if va != vb:
                return False
    return True
