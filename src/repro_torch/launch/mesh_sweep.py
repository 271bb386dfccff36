"""Client-mesh sharding and the profile sweep, as ``examples/mesh_sweep.py``.

1. Builds one frozen `ExperimentSpec` (scheme, delay profile, mesh, all
   declarative) and runs CodedFedL with its client axis sharded over the
   ranks of the client mesh: each rank computes its own clients' gradients
   and one all-reduce a round sums the shards, the MEC server reduction of
   paper §III (`repro_torch.launch.mesh`).
2. Sweeps every grid scheme over the heterogeneity profile grid through
   one step a scheme (`Experiment.sweep`, `repro_torch.launch.sweep`),
   unsharded, as in the reference script.

    PYTHONPATH=src python -m repro_torch.launch.mesh_sweep [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.mesh_sweep --ranks 4
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.mesh_sweep

One rank by default; under ``torchrun`` the world's ranks (a group made
from its environment); with ``--ranks k`` k ranks spawned from here
(`repro_torch.launch.mesh.spawn`).  The group's backend follows
`repro_torch.launch.mesh.default_backend`: NCCL when every rank has a card
of its own, gloo otherwise.  Rank 0 prints.

The port draws the parity generators with its own generator; `main`
takes the reference's draw instead (``parity_generators``, see
``repro_torch.carry``) to compute what the reference's script computes.
"""
from __future__ import annotations

import argparse
import datetime
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.api import ExperimentSpec, build_experiment, grid_names
from repro_torch.config import FLConfig, TrainConfig
from repro_torch.core.delay_model import HETEROGENEITY_PROFILES
from repro_torch.launch.mesh import default_backend, spawn

N, L, Q, C = 12, 32, 64, 5
ITERS, REALIZATIONS = 30, 4
#: seconds a spawned or torchrun group waits in a collective
TIMEOUT_S = 120.0


def _data():
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(N, L, Q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(N, L, C)).astype(np.float32)
    return xs, ys


def _spec(ndev: Optional[int]) -> ExperimentSpec:
    return ExperimentSpec(
        fl=FLConfig(n_clients=N, delta=0.2, psi=0.2, seed=0),
        train=TrainConfig(learning_rate=0.5, l2_reg=1e-5,
                          lr_decay_epochs=(15,)),
        scheme="coded", mesh=ndev)


def sharded_run(device=None, parity_generators=None,
                out: Callable[[str], None] = print):
    """Part 1 over every rank of the initialized process group (this
    process alone when there is none); returns the run's `FedResult`."""
    ndev = dist.get_world_size() if dist.is_initialized() else 1
    spec = _spec(ndev)
    out(f"[mesh] sharding {N} clients over {ndev} device(s); "
        f"spec round-trips JSON: "
        f"{ExperimentSpec.from_dict(spec.to_dict()) == spec}")
    xs, ys = _data()
    exp = build_experiment(spec, xs, ys, device=device,
                           parity_generators=parity_generators)
    res = exp.run(ITERS)
    out(f"[mesh] coded: t*={res.t_star:.3f}s  "
        f"finished {ITERS} rounds at {res.history[-1].wall_clock:.1f} "
        f"simulated seconds")
    return res


def _rank_part(rank: int, device, parity_generators) -> dict:
    """Part 1 on one spawned rank: rank 0's printed lines and result."""
    lines = []
    res = sharded_run(device, parity_generators, out=lines.append)
    return {"lines": lines, "theta": res.theta.cpu().numpy(),
            "t_star": res.t_star,
            "wall_clock": [h.wall_clock for h in res.history]}


def profile_sweep(device=None, out: Callable[[str], None] = print):
    """Part 2, unsharded: every grid scheme over every heterogeneity
    profile; returns the `SweepResult`."""
    out(f"[sweep] {len(HETEROGENEITY_PROFILES)} profiles x "
        f"{REALIZATIONS} realizations x schemes {grid_names()}, "
        f"one step a scheme")
    xs, ys = _data()
    spec = _spec(None)
    unsharded = build_experiment(ExperimentSpec(
        fl=spec.fl, train=spec.train, scheme="coded"), xs, ys,
        device=device)
    sw = unsharded.sweep(profiles=HETEROGENEITY_PROFILES, iterations=ITERS,
                         realizations=REALIZATIONS, schemes=grid_names())
    for scheme, per_profile in sw.results.items():
        out(f"[sweep] {scheme}: grid call took "
            f"{sw.host_seconds[scheme]:.2f}s host-side")
        for pname, multi in per_profile.items():
            mean, std = multi.wall_clock_bands()
            out(f"    {pname:>10}: {mean[-1]:8.1f} ± {std[-1]:5.1f} "
                f"simulated s")
    return sw


def main(ranks: Optional[int] = None, device=None, parity_generators=None,
         out: Callable[[str], None] = print) -> dict:
    """Run the example: part 1 on `ranks` spawned ranks, or on the
    initialized group's ranks, or on this process alone; part 2 on this
    process (rank 0 of a group; the other ranks return after part 1).
    Returns ``{"mesh": rank 0's part-1 result, "sweep": SweepResult or
    None}``."""
    if ranks is not None:
        mesh = spawn(_rank_part, int(ranks), args=(device, parity_generators),
                     timeout=TIMEOUT_S)[0]
        for line in mesh["lines"]:
            out(line)
    else:
        lead = not dist.is_initialized() or dist.get_rank() == 0
        res = sharded_run(device, parity_generators,
                          out=out if lead else (lambda line: None))
        mesh = {"theta": res.theta.cpu().numpy(), "t_star": res.t_star,
                "wall_clock": [h.wall_clock for h in res.history]}
        if not lead:
            return {"mesh": mesh, "sweep": None}
    return {"mesh": mesh, "sweep": profile_sweep(device, out)}


def _cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="spawn this many ranks for part 1 (default: one, "
                    "or the world of torchrun)")
    ap.add_argument("--device", default=None,
                    help="device of every rank (default: its card)")
    args = ap.parse_args()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.ranks is None and world > 1:
        # torchrun: the group comes from its environment
        if torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("RANK", "0"))
                                  % torch.cuda.device_count())
        dist.init_process_group(
            default_backend(world), init_method="env://",
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            main(device=args.device)
        finally:
            dist.destroy_process_group()
        return
    main(ranks=args.ranks, device=args.device)


if __name__ == "__main__":
    _cli()
