"""Hierarchical population scale, as ``examples/hier_scale.py``: 10,000
clients over 10 edge aggregators.

The flat engine materializes a dense ``(n, l, q)`` client tensor and
solves the two-step allocation over all n nodes at once — fine at the
paper's n <= 1000, hopeless at a population.  The hierarchical tier
(`repro_torch.hier`) partitions the population into edge-aggregator
shards, runs the static coded round per shard (chunked O(block)-memory
solver), samples a Bernoulli(f) cohort per round from a dedicated RNG
stream, and reweights each shard's parity gradient so the update stays an
unbiased SGD step at every f.  Client tensors exist one shard at a time,
streamed through ``data_fn(lo, hi)``.

This builds a 10k-client deployment (10 shards of 1k, 25% cohorts), runs
a few rounds, shows the O(active cohort) memory contract and the
kill/resume round trip, then prints a tiny scaling curve
(`repro_torch.launch.scale.run_scale`).

    PYTHONPATH=src python -m repro_torch.launch.hier_scale [--device cpu]

The port draws the shards' parity generators with its own generators
(`repro_torch.hier.topology`), so theta differs from the reference
script's; the numbers printed (deadlines, returned counts, the reweight,
memory) do not depend on that draw.  The kill/resume is held against the
uninterrupted run from the same stream positions.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.config import ExperimentSpec, FLConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.hier import HierExperiment
from repro_torch.launch import scale as launch_scale

N, SHARDS, L, Q, C = 10_000, 10, 8, 16, 3
SOLVER = dict(n_golden_search=12, n_bisect=20)


def main(device=None, out: Callable[[str], None] = print) -> dict:
    """Run the example on `device` (the GPU unless the caller asks for the
    CPU); returns what it printed, as numbers: ``setup_s``,
    ``setup_time``, ``peak_bytes``, ``dense_bytes``, ``rounds_s``,
    ``result`` (the `HierResult`), ``bit_identical`` (kill/resume against
    an uninterrupted run), ``max_parity_weight`` and ``section`` (the
    tiny `run_scale` curve)."""
    dev = resolve_device(device)
    # heterogeneity knobs re-exponentiated so the population spans the
    # same rate/compute range as the paper's 12-client cell at any n
    fl = FLConfig(n_clients=N, delta=0.2, seed=0,
                  rate_decay=0.95 ** (12.0 / N),
                  mac_decay=0.8 ** (12.0 / N))
    spec = ExperimentSpec(
        fl=fl, train=TrainConfig(learning_rate=0.5, l2_reg=1e-5),
        scheme="coded", hier_shards=SHARDS, sample_fraction=0.25)

    # streamed client blocks: deterministic synthetic data generated per
    # (lo, hi) range on demand — the dense (N, L, Q) tensor never exists
    def data_fn(lo, hi):
        return launch_scale.synthetic_block(lo, hi, L, Q, C)

    t0 = time.perf_counter()
    exp = HierExperiment(spec, data_fn=data_fn, solver_kwargs=dict(SOLVER),
                         device=dev)
    setup_s = time.perf_counter() - t0
    out(f"setup: {SHARDS} edge aggregators over n={N} clients in "
        f"{setup_s:.1f}s host time "
        f"(simulated parity-upload overhead {exp.setup_time:.2f}s)")
    peak, dense = exp.peak_client_tensor_bytes(), 4 * N * L * (Q + C)
    out(f"peak client-tensor memory: {peak / 1e6:.2f} MB "
        f"(dense flat engine would hold {dense / 1e6:.2f} MB; "
        f"{dense / peak:.0f}x less — O(active cohort))")

    start = exp.init_state(4)
    t0 = time.perf_counter()
    state = exp.run_block(start, 2)                  # two rounds...
    with tempfile.TemporaryDirectory(prefix="hier_scale_ckpt_") as ckpt:
        mid = exp.save_state(os.path.join(ckpt, "ckpt_000002.npz"), state)
        state = exp.run_block(exp.restore_state(mid), 2)  # ...kill/resume
    res = exp.finish(state)
    rounds_s = time.perf_counter() - t0
    # the uninterrupted run from the same stream positions
    control = exp.run_block(start, 4)
    same = bool(torch.equal(control.theta, res.theta)
                and np.array_equal(control.n_ret, res.n_ret))
    out(f"4 rounds in {rounds_s:.1f}s host time; "
        f"server deadline t_round={res.t_round:.4f}s, "
        f"mean in-cohort returns/round "
        f"{res.n_ret.mean():.0f}/{N} (f=0.25); kill/resume "
        f"bit-identical = {same}")
    w = max(p.parity_weight for p in res.plans)
    out(f"coded compensation: max shard parity reweight w(f)={w:.3f} "
        f"(unbiased update; w=1 exactly at f=1)\n")

    out("tiny scaling curve (run_scale records n=1e3..1e5):")
    section = launch_scale.run_scale(
        ns=(1_000, 4_000), l=4, q=8, c=2, rounds=2, trace_rounds=1,
        solver_kwargs=dict(SOLVER), device=dev)
    for e in section["entries"]:
        out(f"  n={e['n']:>6d}: setup {e['setup_seconds']:6.1f}s  "
            f"rounds {e['round_seconds']:5.2f}s  "
            f"peak {e['peak_client_tensor_bytes'] / 1e6:6.2f} MB  "
            f"(dense {e['dense_client_tensor_bytes'] / 1e6:6.2f} MB)")
    ident = section["identity"]
    out(f"identity config (shards=1, f=1.0) routes to the flat engine "
        f"bit-identically: {ident['bit_identical']}")
    return {"setup_s": setup_s, "setup_time": exp.setup_time,
            "peak_bytes": peak, "dense_bytes": dense, "rounds_s": rounds_s,
            "result": res, "bit_identical": same, "max_parity_weight": w,
            "section": section}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    main(device=ap.parse_args().device)
