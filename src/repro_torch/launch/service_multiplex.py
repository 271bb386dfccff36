"""ExperimentService: many concurrent CodedFedL runs in one process, as
``examples/service_multiplex.py``.

Submits three heterogeneous jobs — a static coded run, a greedy run with
a different block size, and an adaptive run over a drifting channel — to
one `ExperimentService`, which round-robins one block per job per step
and checkpoints every run under ``root/<run_id>/``.  Midway through, the
service is "killed" (dropped) and a fresh one pointed at the same root
resumes every run from its latest checkpoint; the final models are
bit-identical to an uninterrupted service.

    PYTHONPATH=src python -m repro_torch.launch.service_multiplex \
        [--device cpu]

The port draws the parity generators with its own generator; `main` takes
the reference's draw instead (``parity_generators``, see
``repro_torch.carry``) to compute what the reference's script computes.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api import ExperimentService, ExperimentSpec
from repro_torch.config import FLConfig, TrainConfig
from repro_torch.device import resolve_device

ITERATIONS = 100
KILL_AFTER = 7            # service steps before the kill


def make_data(n=8, l=64, q=128, c=4, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, l, q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(n, l, c)).astype(np.float32)
    return xs, ys


def jobs() -> dict:
    """The example's three jobs: {run_id: spec}."""
    base = ExperimentSpec(
        fl=FLConfig(n_clients=8, delta=0.25, psi=0.25, seed=11),
        train=TrainConfig(learning_rate=0.3),
        scheme="coded", checkpoint_every=20)
    return {
        "coded-static": base,
        "greedy-static": dataclasses.replace(base, scheme="greedy",
                                             checkpoint_every=25),
        "adaptive-drift": dataclasses.replace(
            base, scheme="adaptive_coded", channel_profile="drift_churn",
            adapt_every=10, checkpoint_every=20),
    }


def main(device=None, root: Optional[str] = None, parity_generators=None,
         out: Callable[[str], None] = print) -> dict:
    """Run the example; returns what it printed, as numbers.

    `root` is the checkpoint root (default a fresh temporary directory;
    the uninterrupted control writes next to it, at ``root + "_control"``).
    `parity_generators` (n, u, l) replaces the port's own generator draw
    for the coded and adaptive jobs (the reference draws the same stack
    for both: same seed, same u).  The result holds ``expect`` and
    ``results`` ({run_id: FedResult} of the control and of the resumed
    service), ``steps`` ([(run_id, rounds_done)] before the kill),
    ``resumed_at`` ({run_id: rounds}) and ``identical`` ({run_id: bool}).
    """
    dev = resolve_device(device)
    xs, ys = make_data()
    specs = jobs()
    root = root or tempfile.mkdtemp(prefix="service_runs_")
    out(f"checkpoint root: {root}\n")

    def submit_all(svc):
        return {rid: svc.submit(
            spec, xs, ys, ITERATIONS, run_id=rid,
            parity_generators=(parity_generators
                               if spec.scheme != "greedy" else None))
            for rid, spec in specs.items()}

    # uninterrupted service = the reference
    control = ExperimentService(root + "_control", device=dev)
    submit_all(control)
    expect = control.run_until_complete()

    # interleave blocks, then kill the service mid-flight
    svc = ExperimentService(root, device=dev)
    submit_all(svc)
    steps = []
    for k in range(KILL_AFTER):
        rid = svc.step()
        run = svc.runs[rid]
        steps.append((rid, run.state.rounds_done))
        out(f"step {k}: advanced {rid!r:18s} -> "
            f"{run.state.rounds_done:3d}/{ITERATIONS} rounds")
    out("\n-- service killed --\n")
    del svc

    # a fresh service on the same root picks every run back up
    svc2 = ExperimentService(root, device=dev)
    resumed_at = {}
    for rid, run in submit_all(svc2).items():
        resumed_at[rid] = run.state.rounds_done
        out(f"resubmitted {rid!r:18s} resumed={run.resumed} "
            f"at {run.state.rounds_done} rounds")
    results = svc2.run_until_complete()

    out("")
    identical = {}
    for rid in specs:
        identical[rid] = bool(torch.equal(expect[rid].theta,
                                          results[rid].theta))
        wall = results[rid].history[-1].wall_clock
        out(f"{rid:18s} final wall-clock {wall:8.1f}s   "
            f"bit-identical to uninterrupted = {identical[rid]}")
    return {"expect": expect, "results": results, "steps": steps,
            "resumed_at": resumed_at, "identical": identical}


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    main(device=args.device)


if __name__ == "__main__":
    _cli()
