"""Quickstart of the port: CodedFedL end to end, as ``examples/quickstart.py``.

Builds a small federated deployment (10 clients over a simulated wireless
MEC network) and runs every registered straggler-mitigation scheme through
the declarative experiment API: one frozen `ExperimentSpec` per scheme,
``build_experiment(spec, xs, ys)`` for the runnable deployment.  Prints the
headline comparison (accuracy and wall-clock speedup), runs the kill/resume
round trip of the block-structured runtime (save a `RunState` checkpoint
after the first block, rebuild the experiment from scratch, resume: the
result is bit-identical), then the wall-clock confidence band over 8
independent delay realizations.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

The port draws (Omega, delta) and the parity generators with its own
generators; `main` takes the reference's draws instead (``rff_draw``,
``parity_generators``, see ``repro_torch.carry``) to compute what the
reference's script computes.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api import ExperimentSpec, build_experiment
from repro_torch.config import FLConfig, RFFConfig, TrainConfig
from repro_torch.core import rff
from repro_torch.core.delay_model import mec_network
from repro_torch.data import sharding, synthetic
from repro_torch.device import resolve_device

SCHEMES = ("naive", "greedy", "ideal", "coded", "partial_coded")


def main(rounds: int = 100, realizations: int = 8, device=None,
         rff_draw=None, parity_generators: Optional[dict] = None,
         out: Callable[[str], None] = print) -> dict:
    """Run the quickstart; returns what it printed, as numbers.

    `rounds` and `realizations` default to the reference script's 100 and
    8; the kill comes after the first of four blocks (round rounds // 4).
    `rff_draw` = (omega (64, 256), delta (256,)) and `parity_generators`
    ({scheme: (n, u, l) stack} for the coded family) replace the port's
    own draws.  The result holds the table (``{scheme: {accuracy,
    wall_clock, t_star, privacy_eps, history}}``), ``resume_identical``,
    ``killed_at`` and ``bands`` (``{scheme: (mean, std)}``, each
    (rounds,)).
    """
    dev = resolve_device(device)
    block = max(1, rounds // 4)
    fl = FLConfig(n_clients=10, delta=0.2, psi=0.2)
    ds = synthetic.synthetic_classification(m_train=2000, m_test=500, d=64)

    # 1. distributed kernel embedding (shared-seed RFF, paper §III-A)
    rcfg = RFFConfig(q=256, sigma=2.0)
    if rff_draw is None:
        omega, delta = rff.rff_params(rcfg, d=64, device=dev)
    else:
        omega, delta = (torch.as_tensor(np.array(a, np.float32),
                                        device=dev) for a in rff_draw)
    xh_tr = rff.rff_transform(torch.from_numpy(ds.x_train).to(dev), omega,
                              delta).cpu().numpy()
    xh_te = rff.rff_transform(torch.from_numpy(ds.x_test).to(dev), omega,
                              delta)
    y_te = torch.from_numpy(ds.y_test).to(dev)

    # 2. non-IID partition over the simulated MEC network (paper §V-A)
    nodes = mec_network(fl, d_scalars_per_point=rcfg.q * ds.n_classes)
    shards = sharding.sort_and_shard(xh_tr, ds.y_train, fl.n_clients)
    per_client = sharding.assign_shards_by_speed(shards, nodes, minibatch=200)
    xs = np.stack([c[0] for c in per_client])
    ys = np.stack([ds.one_hot(c[1]) for c in per_client])

    tcfg = TrainConfig(learning_rate=rff.suggest_lr(xh_tr))

    def eval_fn(theta):
        acc = ((xh_te @ theta).argmax(1) == y_te).double().mean()
        return 0.0, float(acc)

    gens = parity_generators or {}

    def build(spec):
        return build_experiment(spec, xs, ys, device=dev,
                                parity_generators=gens.get(spec.scheme))

    # 3. one frozen spec per scheme (the declarative experiment API)
    base_spec = ExperimentSpec(fl=fl, train=tcfg, rff=rcfg)
    out(f"base spec: {base_spec.to_dict()}\n")
    out(f"{'scheme':14s} {'accuracy':>9s} {'wall-clock':>11s}"
        f" {'deadline':>9s} {'eps(bits)':>10s}")
    table = {}
    base_wall = None
    for scheme in SCHEMES:
        res = build(dataclasses.replace(base_spec, scheme=scheme)).run(
            rounds, eval_fn=eval_fn, eval_every=block)
        h = res.history[-1]
        if scheme == "naive":
            base_wall = h.wall_clock
        speed = (f"({base_wall / h.wall_clock:.1f}x)"
                 if scheme != "naive" else "")
        t_star = f"{res.t_star:.2f}s" if res.t_star else "-"
        eps = f"{res.privacy_eps:.2f}" if res.privacy_eps else "-"
        out(f"{scheme:14s} {h.accuracy:9.3f} {h.wall_clock:9.0f}s "
            f"{speed:>6s} {t_star:>9s} {eps:>10s}")
        table[scheme] = {"accuracy": h.accuracy, "wall_clock": h.wall_clock,
                         "t_star": res.t_star,
                         "privacy_eps": res.privacy_eps,
                         "history": res.history}

    # 4. kill/resume round trip: checkpoint_every makes the run a chain of
    # 4 blocks, each saving a RunState checkpoint; the "kill" comes after
    # one block, and a FRESH experiment resumes: the final model is
    # bit-identical to the uninterrupted run's
    ckpt_spec = dataclasses.replace(base_spec, scheme="coded",
                                    checkpoint_every=block)
    control = build(ckpt_spec).run(rounds)
    with tempfile.TemporaryDirectory(prefix="quickstart_ckpt_") as ckpt_dir:
        interrupted = build(ckpt_spec)
        state = interrupted.run_block(interrupted.init_state(rounds))
        interrupted.save_state(
            f"{ckpt_dir}/ckpt_{state.rounds_done:06d}.npz", state)
        killed_at = state.rounds_done
        del interrupted, state                                  # the kill
        resumed = build(ckpt_spec).run(rounds, checkpoint_dir=ckpt_dir,
                                       resume=True)
    identical = (torch.equal(control.theta, resumed.theta)
                 and [h.wall_clock for h in control.history]
                 == [h.wall_clock for h in resumed.history])
    out(f"\nkill at round {killed_at} -> resume in a fresh experiment: "
        f"bit-identical = {identical}")

    # 5. confidence bands over independent delay realizations
    out(f"\nwall-clock over {realizations} delay realizations "
        "(mean ± std, final round):")
    bands = {}
    for scheme in ("naive", "coded"):
        exp = build(dataclasses.replace(base_spec, scheme=scheme))
        mean, std = exp.run_multi(rounds, realizations).wall_clock_bands()
        bands[scheme] = (mean, std)
        out(f"  {scheme:6s} {mean[-1]:8.0f}s ± {std[-1]:.1f}s")
    return {"table": table, "resume_identical": identical,
            "killed_at": killed_at, "bands": bands}


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--realizations", type=int, default=8)
    args = ap.parse_args(argv)
    main(args.rounds, args.realizations, device=args.device)


if __name__ == "__main__":
    _cli()
