"""Run telemetry end to end: spans, journal, attribution, text report, as
``examples/run_report.py``.

One CodedFedL run with the `repro_torch.obs` subsystem switched on:

  * ``obs_spans.collecting()`` — span timers over setup, the two-step
    allocation solve, parity encode, the first and the warm blocks of the
    step (``scan/compile``, ``scan/execute``), checkpoint save, and journal
    appends.  Zero overhead when disabled; bit-identical trajectories
    either way (the collector never touches a random stream).
  * ``journal_dir=...`` — an append-only ``events.jsonl``, one event per
    round (wall clock, returned count, guard counters, lr scale, loss),
    deterministic to the byte given (spec, seed), and replayable into
    the exact ``FedResult.history`` via `history_from_journal`.
  * ``Experiment.attribution()`` — post-hoc straggler attribution from
    the realized delay arrays: per-client deadline-miss rates, the
    per-round slowest-k counts, and the coded-compensation share.

Everything lands in one run directory, and the text report is rendered
from those files alone:

    PYTHONPATH=src python -m repro_torch.launch.run_report [--device cpu] \
        [--run-dir DIR]

The port draws the parity generators with its own generator; `main` takes
the reference's draw instead (``parity_generators``, see
``repro_torch.carry``) to compute what the reference's script computes.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api import (ExperimentSpec, build_experiment,
                             histories_equal, history_from_journal,
                             obs_spans)
from repro_torch.config import FLConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.launch.report import ATTR_NAME, render_report

ITERS = 24


def main(device=None, run_dir: Optional[str] = None, parity_generators=None,
         out: Callable[[str], None] = print) -> dict:
    """Run the example into `run_dir` (default a fresh temporary
    directory); returns the run's `FedResult` (``result``), its
    `Attribution` (``attribution``), the span totals (``spans``), the
    rendered report (``report``) and ``run_dir``.  Raises AssertionError
    if telemetry changed the trajectory or the journal does not replay
    into the run's history."""
    dev = resolve_device(device)
    run_dir = run_dir or tempfile.mkdtemp(prefix="obs_demo_")
    rng = np.random.default_rng(0)
    n, l, q, c = 10, 24, 32, 3
    theta_true = rng.normal(size=(q, c)).astype(np.float32)
    xs = rng.normal(size=(n, l, q)).astype(np.float32) * 0.3
    ys = (np.einsum("nlq,qc->nlc", xs, theta_true)
          + 0.005 * rng.normal(size=(n, l, c)).astype(np.float32))
    spec = ExperimentSpec(
        fl=FLConfig(n_clients=n, delta=0.25, psi=0.2, seed=0),
        train=TrainConfig(learning_rate=1.0, l2_reg=0.0),
        scheme="coded", checkpoint_every=6)

    def eval_fn(theta):
        pred = np.einsum("nlq,qc->nlc", xs, theta.cpu().numpy())
        return float(np.mean((pred - ys) ** 2)), 0.0

    def build():
        return build_experiment(spec, xs, ys, device=dev,
                                parity_generators=parity_generators)

    # reference run with telemetry OFF — the invariant under test below
    ref = build().run(ITERS, eval_fn=eval_fn, eval_every=1)

    with obs_spans.collecting():
        exp = build()
        res = exp.run(ITERS, eval_fn=eval_fn, eval_every=1,
                      journal_dir=run_dir)
        attr = exp.attribution()
        obs_spans.write_json(os.path.join(run_dir, obs_spans.SPANS_NAME))
        totals = obs_spans.totals()
    with open(os.path.join(run_dir, ATTR_NAME), "w") as fh:
        json.dump(attr.to_dict(), fh, indent=2, sort_keys=True)
        fh.write("\n")

    assert torch.equal(ref.theta, res.theta), \
        "telemetry must never perturb a trajectory"
    assert histories_equal(history_from_journal(run_dir), res.history), \
        "journal replay must reconstruct the exact history"

    report = render_report(run_dir)
    out(report)
    out(f"run dir: {run_dir} (events.jsonl, spans.json, {ATTR_NAME})")
    out("telemetry-on trajectory == telemetry-off trajectory: OK")
    out("journal replay == FedResult.history: OK")
    return {"result": res, "attribution": attr, "spans": totals,
            "report": report, "run_dir": run_dir}


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--run-dir", default=None,
                    help="run directory (default: a fresh temporary one)")
    args = ap.parse_args(argv)
    main(device=args.device, run_dir=args.run_dir)


if __name__ == "__main__":
    _cli()
