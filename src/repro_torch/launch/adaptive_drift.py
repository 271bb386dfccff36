"""Adaptive allocation under network drift, as ``examples/adaptive_drift.py``.

The paper's load allocation is solved ONCE from round-0 delay statistics.
This runs the same CodedFedL deployment over a *drifting* wireless channel
(`repro_torch.net`, profile ``degrade_drift``: compute throttles, links
fall down the LTE CQI ladder) twice:

  * ``scheme="coded"``           — the static round-0 allocation;
  * ``scheme="adaptive_coded"``  — online (mu, tau, p) estimation from
    round telemetry and the allocation re-solved every ``adapt_every``
    rounds, applied as per-block mask re-weighting.

Both face the SAME realized channel trace (equal seeds), so the printed gap
is pure allocation policy.

    PYTHONPATH=src python -m repro_torch.launch.adaptive_drift [--device cpu]

The port draws the parity generators with its own generator; `main` takes
the reference's draw instead (``parity_generators``, see
``repro_torch.carry``) to compute what the reference's script computes.
"""
from __future__ import annotations

import argparse
from typing import Callable

import numpy as np

from repro_torch.api import CHANNEL_PROFILES, ExperimentSpec, build_experiment
from repro_torch.config import FLConfig, TrainConfig
from repro_torch.device import resolve_device

PROFILE = "degrade_drift"
ITERS = 60
ADAPT_EVERY = 5


def main(device=None, parity_generators=None,
         out: Callable[[str], None] = print) -> dict:
    """Run the example; returns what it printed, as numbers.

    `parity_generators` (n, u, l) replaces the port's own generator draw
    for both deployments (the reference draws the same stack for both:
    same seed, same u).  The result holds ``static`` and ``adaptive``
    (each the run's `FedResult`), ``target``, ``t_target`` ({"static",
    "adaptive"}: first wall clock at loss <= target), ``t_star``
    (static), ``schedule`` (the adaptive run's `AdaptiveSchedule`).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    n, l, q, c = 10, 24, 32, 3
    theta_true = rng.normal(size=(q, c)).astype(np.float32)
    xs = rng.normal(size=(n, l, q)).astype(np.float32) * 0.3
    ys = (np.einsum("nlq,qc->nlc", xs, theta_true)
          + 0.005 * rng.normal(size=(n, l, c)).astype(np.float32))
    fl = FLConfig(n_clients=n, delta=0.25, psi=0.2, seed=0)
    tc = TrainConfig(learning_rate=1.0, l2_reg=0.0)

    def eval_fn(theta):
        pred = np.einsum("nlq,qc->nlc", xs, theta.cpu().numpy())
        return float(np.mean((pred - ys) ** 2)), 0.0

    def build(spec):
        return build_experiment(spec, xs, ys, device=dev,
                                parity_generators=parity_generators)

    out(f"channel profile {PROFILE!r}: {CHANNEL_PROFILES[PROFILE]}\n")
    base = dict(fl=fl, train=tc, channel_profile=PROFILE)
    static = build(ExperimentSpec(**base, scheme="coded"))
    res_s = static.run(ITERS, eval_fn=eval_fn, eval_every=1)

    adaptive = build(ExperimentSpec(**base, scheme="adaptive_coded",
                                    adapt_every=ADAPT_EVERY))
    res_a = adaptive.run(ITERS, eval_fn=eval_fn, eval_every=1)
    sched = adaptive.last_schedule

    target = max(res_s.history[-1].loss, res_a.history[-1].loss)

    def tt(res):
        return next(h.wall_clock for h in res.history if h.loss <= target)

    out(f"{'':12s} {'final loss':>11s} {'wall-clock':>11s} "
        f"{'t(loss<={:.3g})':>16s}".format(target))
    out(f"{'static':12s} {res_s.history[-1].loss:11.4f} "
        f"{res_s.history[-1].wall_clock:10.2f}s {tt(res_s):15.2f}s")
    out(f"{'adaptive':12s} {res_a.history[-1].loss:11.4f} "
        f"{res_a.history[-1].wall_clock:10.2f}s {tt(res_a):15.2f}s")
    out(f"\nadaptive reaches the target "
        f"{tt(res_s) / tt(res_a):.2f}x sooner")
    out(f"deadline trajectory: t* {static.t_star:.3f}s (static, fixed) "
        f"vs {sched.t_star[0]:.3f}s -> {sched.t_star[-1]:.3f}s over "
        f"{sched.n_blocks} re-allocations (adaptive)")
    out(f"allocated load: {sched.loads_blocks[0].sum():.0f} -> "
        f"{sched.loads_blocks[-1].sum():.0f} points/round as the "
        f"network degrades")
    return {"static": res_s, "adaptive": res_a, "target": target,
            "t_target": {"static": tt(res_s), "adaptive": tt(res_a)},
            "t_star": static.t_star, "schedule": sched}


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    main(device=args.device)


if __name__ == "__main__":
    _cli()
