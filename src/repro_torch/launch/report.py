"""Run-report surface over the `repro_torch.obs` telemetry artifacts.

The port of ``repro.launch.report``.  A run directory (``root/<run_id>/``)
accumulates up to three telemetry files next to its checkpoints:

  * ``events.jsonl``     — the per-round journal (`repro_torch.obs.events`)
  * ``spans.json``       — span totals (`repro_torch.obs.spans.write_json`)
  * ``attribution.json`` — straggler attribution (`Attribution.to_dict`)

`render_report` turns whatever subset is present into the text report
(round table, span breakdown, top stragglers); the files have the
reference's format, so a directory either package wrote renders to the
same text in both.  `run_telemetry` is the probe of the subsystem's hard
invariants (telemetry-on trajectories bit-identical to telemetry-off,
journal byte-deterministic per (spec, seed), journal replay reconstructing
`FedResult.history` exactly) and measures the enabled-vs-disabled
overhead ratio, which `validate_telemetry` holds below
`MAX_OVERHEAD_RATIO`.

    PYTHONPATH=src python -m repro_torch.launch.run_report [--device cpu]
"""
from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import spans as obs_spans
from repro_torch.obs.events import (histories_equal, history_from_journal,
                                    load_events)

__all__ = ["render_report", "run_telemetry", "validate_telemetry",
           "ATTR_NAME", "MAX_OVERHEAD_RATIO", "REQUIRED_SPANS"]

#: attribution filename inside a run directory
ATTR_NAME = "attribution.json"

#: validator ceiling on the enabled/disabled wall-clock ratio at the
#: default probe size (the reference's)
MAX_OVERHEAD_RATIO = 1.05

#: span names every telemetry probe run must record (the probe runs the
#: coded scheme end to end: setup, solve, encode, the first and the warm
#: blocks of the step, journal)
REQUIRED_SPANS = ("setup/experiment", "solver/two_step", "encode/parity",
                  "scan/compile", "scan/execute", "journal/append")


# ------------------------------------------------------------- rendering
def _fmt_row(cols, widths) -> str:
    return "  ".join(str(c).rjust(w) for c, w in zip(cols, widths))


def render_report(run_dir: str, *, top: int = 5, max_rounds: int = 12) -> str:
    """Text run report from a run directory's telemetry artifacts.

    Sections appear for whichever artifacts exist: the round table and
    summary need ``events.jsonl``; the span breakdown ``spans.json``; the
    top-straggler table ``attribution.json``.  ``max_rounds`` bounds the
    round table (head + tail around an ellipsis).
    """
    lines = [f"run report: {run_dir}"]
    try:
        events = load_events(run_dir)
    except FileNotFoundError:
        events = None
    if events:
        lines.append(f"\nrounds journaled: {len(events)}")
        header = ("round", "t_round_s", "wall_s", "ret", "mask",
                  "skip", "lr_scale", "loss")
        rows = []
        for e in events:
            loss = e.get("loss")
            rows.append((e["round"], f"{e['t_round_s']:.4f}",
                         f"{e['wall_clock_s']:.3f}", e["returned"],
                         e["n_masked"], e["skipped"],
                         f"{e['lr_scale']:.3g}",
                         "-" if loss is None else f"{loss:.5f}"))
        if len(rows) > max_rounds:
            head = rows[:max_rounds - max_rounds // 2]
            tail = rows[len(rows) - max_rounds // 2:]
            rows = head + [("...",) * len(header)] + tail
        widths = [max(len(str(header[i])),
                      *(len(str(r[i])) for r in rows))
                  for i in range(len(header))]
        lines.append(_fmt_row(header, widths))
        lines.extend(_fmt_row(r, widths) for r in rows)
        lines.append(
            f"total simulated wall clock: "
            f"{events[-1]['wall_clock_s']:.3f} s | "
            f"mean returned: "
            f"{np.mean([e['returned'] for e in events]):.2f} | "
            f"rounds degraded: "
            f"{sum(e['n_masked'] > 0 for e in events)} | "
            f"rounds skipped: {sum(e['skipped'] for e in events)}")
        if "t_star_s" in events[-1]:
            stars = ", ".join(f"{t:.4f}" for t in events[-1]["t_star_s"])
            lines.append(f"per-shard deadlines t*_s: [{stars}]")
    else:
        lines.append("\n(no events.jsonl — run with journal_dir= or "
                     "through an enabled ExperimentService)")
    spans_path = os.path.join(run_dir, obs_spans.SPANS_NAME)
    if os.path.exists(spans_path):
        with open(spans_path) as fh:
            totals = json.load(fh)
        lines.append("\nspan breakdown:")
        header = ("span", "count", "total_s", "mean_s", "max_s")
        rows = [(name, rec["count"], f"{rec['total_s']:.4f}",
                 f"{rec['total_s'] / max(rec['count'], 1):.4f}",
                 f"{rec['max_s']:.4f}")
                for name, rec in sorted(
                    totals.items(),
                    key=lambda kv: -kv[1]["total_s"])]
        widths = [max(len(str(header[i])),
                      *(len(str(r[i])) for r in rows)) if rows else
                  len(str(header[i])) for i in range(len(header))]
        lines.append(_fmt_row(header, widths))
        lines.extend(_fmt_row(r, widths) for r in rows)
    attr_path = os.path.join(run_dir, ATTR_NAME)
    if os.path.exists(attr_path):
        with open(attr_path) as fh:
            attr = json.load(fh)
        # one flat dict, or {shard: dict} from the hierarchical tier
        shards = (attr if "miss_rate" not in attr else {"": attr})
        for label, a in shards.items():
            title = "top stragglers" + (f" (shard {label})" if label else "")
            lines.append(f"\n{title} (k={a['k']}, {a['rounds']} rounds):")
            header = ("client", "miss_rate", "missed", "active", "slowest_k")
            rows = [(j, f"{r:.3f}", a["miss_counts"][j],
                     a["active_rounds"][j], a["slowest_k_counts"][j])
                    for j, r in a["top_stragglers"][:top]]
            widths = [max(len(str(header[i])),
                          *(len(str(r[i])) for r in rows)) if rows else
                      len(str(header[i])) for i in range(len(header))]
            lines.append(_fmt_row(header, widths))
            lines.extend(_fmt_row(r, widths) for r in rows)
            if a.get("comp_share_mean") is not None:
                lines.append(f"mean coded-compensation share: "
                             f"{a['comp_share_mean']:.3f}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- benchmark
def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_telemetry(kernel_backend: str = "xla", n_clients: int = 12,
                  l: int = 256, q: int = 256, c: int = 8, iters: int = 120,
                  block: int = 40, repeats: int = 3, seed: int = 0,
                  device=None) -> dict:
    """Telemetry invariants and overhead, as the reference's probe.

    Runs the coded scheme on `device` (default the GPU) and records

      * ``trajectory_bit_identical`` — a telemetry-on run (spans +
        journal) reproduces the telemetry-off trajectory bit-for-bit;
      * ``journal_deterministic`` — two fresh same-(spec, seed) runs
        write byte-identical ``events.jsonl``;
      * ``journal_replay_matches`` — `history_from_journal` reconstructs
        the run's `FedResult.history` exactly;
      * ``overhead_ratio`` — min-of-``repeats`` warm wall-clock of the
        telemetry-on run over the telemetry-off run, interleaved so host
        noise hits both alike; each timed run ends with a device sync.
        At toy sizes the ratio measures journal I/O against nothing and
        the validator ceiling is meaningless (tests override it).

    ``kernel_backend`` is kept in the spec for the round trip with the
    reference only.  Restores the caller's span-enable flag on exit.
    """
    from repro_torch.config import ExperimentSpec, FLConfig, TrainConfig
    from repro_torch.core.fed_runtime import Experiment

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n_clients, l, q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(n_clients, l, c)).astype(np.float32)
    spec = ExperimentSpec(
        fl=FLConfig(n_clients=n_clients, delta=0.2, psi=0.2, seed=seed),
        train=TrainConfig(learning_rate=0.5, l2_reg=1e-5,
                          lr_decay_epochs=(max(1, iters // 2),)),
        scheme="coded", kernel_backend=kernel_backend,
        checkpoint_every=block)

    def build():
        return Experiment(spec, xs, ys, device=dev)

    def timed(fn) -> float:
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        return time.perf_counter() - t0

    prev_enabled = obs_spans.enabled()
    try:
        obs_spans.disable()
        exp_off = build()
        res_off = exp_off.run(iters)       # first blocks + reference run

        obs_spans.reset()
        obs_spans.enable()
        with tempfile.TemporaryDirectory() as tmp:
            exp_on = build()
            res_on = exp_on.run(iters, journal_dir=f"{tmp}/j1")
            exp_on2 = build()
            exp_on2.run(iters, journal_dir=f"{tmp}/j2")
            with open(f"{tmp}/j1/events.jsonl", "rb") as fh:
                j1 = fh.read()
            with open(f"{tmp}/j2/events.jsonl", "rb") as fh:
                j2 = fh.read()
            journal_deterministic = j1 == j2
            replay_matches = histories_equal(
                history_from_journal(f"{tmp}/j1"), res_on.history)
            bit_identical = bool(torch.equal(res_off.theta, res_on.theta))
            # warm interleaved timing: fresh init_state per call, the
            # cached step; each enabled run journals to a fresh dir so
            # journal I/O (part of telemetry's cost) is in the numerator
            t_off = t_on = float("inf")
            for r in range(repeats):
                obs_spans.disable()
                t_off = min(t_off, timed(lambda: exp_off.run(iters)))
                obs_spans.enable()
                t_on = min(t_on, timed(
                    lambda: exp_on.run(iters, journal_dir=f"{tmp}/t{r}")))
        span_totals = obs_spans.totals()
    finally:
        (obs_spans.enable if prev_enabled else obs_spans.disable)()

    return {
        "config": {"n_clients": n_clients, "l": l, "q": q, "c": c,
                   "iters": iters, "block_rounds": block,
                   "repeats": repeats, "seed": seed,
                   "kernel_backend": kernel_backend, "device": str(dev)},
        "trajectory_bit_identical": bit_identical,
        "journal_deterministic": bool(journal_deterministic),
        "journal_replay_matches": bool(replay_matches),
        "disabled_seconds": float(t_off),
        "enabled_seconds": float(t_on),
        "overhead_ratio": float(t_on / t_off),
        "span_totals": span_totals,
    }


def validate_telemetry(section, *,
                       max_overhead_ratio: float = MAX_OVERHEAD_RATIO
                       ) -> "list[str]":
    """Problems with a ``telemetry`` section (empty list == valid).

    Enforces the three boolean invariants, finite positive timings, the
    overhead ceiling (``max_overhead_ratio``, overridable for toy-scale
    test fixtures where journal I/O is not amortized), and presence of
    every `REQUIRED_SPANS` name in the span totals.
    """
    errs = []
    if not isinstance(section, dict):
        return [f"telemetry: must be a dict, got {type(section).__name__}"]
    for flag in ("trajectory_bit_identical", "journal_deterministic",
                 "journal_replay_matches"):
        if section.get(flag) is not True:
            errs.append(f"telemetry/{flag}: must be True, "
                        f"got {section.get(flag)!r}")
    for field in ("disabled_seconds", "enabled_seconds", "overhead_ratio"):
        val = section.get(field)
        if not isinstance(val, (int, float)) or not np.isfinite(val) \
                or val <= 0:
            errs.append(f"telemetry/{field}: bad value {val!r}")
    ratio = section.get("overhead_ratio")
    if isinstance(ratio, (int, float)) and np.isfinite(ratio) \
            and ratio >= max_overhead_ratio:
        errs.append(f"telemetry/overhead_ratio: {ratio:.4f} >= "
                    f"ceiling {max_overhead_ratio}")
    totals = section.get("span_totals")
    if not isinstance(totals, dict):
        errs.append(f"telemetry/span_totals: missing ({totals!r})")
    else:
        for name in REQUIRED_SPANS:
            rec = totals.get(name)
            if not isinstance(rec, dict) or not isinstance(
                    rec.get("count"), int) or rec["count"] < 1:
                errs.append(f"telemetry/span_totals/{name}: missing or "
                            f"never recorded ({rec!r})")
                continue
            total = rec.get("total_s")
            if not isinstance(total, (int, float)) \
                    or not np.isfinite(total) or total < 0:
                errs.append(f"telemetry/span_totals/{name}/total_s: "
                            f"bad value {total!r}")
    return errs
