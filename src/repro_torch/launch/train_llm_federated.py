"""End-to-end driver: federated training of a transformer LM with the
paper's deadline-based aggregation (the port of
``examples/train_llm_federated.py``).

Each simulated MEC client owns a data shard; per round, client round-trip
delays are sampled from the paper's §II-B models, the load allocator picks
the deadline t*, stragglers are dropped, and surviving gradients are
reweighted by 1/P(T_j <= t*) so the aggregate stays unbiased.

Default is a ~20M-param qwen3-family model for a quick run; use
--params 100m --steps 300 for the full deliverable-scale run (on the GPU).

    PYTHONPATH=src python -m repro_torch.launch.train_llm_federated [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train_llm_federated --params 100m --steps 300
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.config import FLConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch.train import train


def model_cfg(size: str):
    base = smoke_variant(get_config("qwen3-4b"))
    if size == "20m":
        return dataclasses.replace(base, n_layers=4, d_model=256, d_ff=1024,
                                   vocab=8192, n_heads=4, n_kv_heads=2)
    if size == "100m":
        return dataclasses.replace(base, n_layers=8, d_model=512, d_ff=2048,
                                   vocab=32768, n_heads=8, n_kv_heads=4)
    raise ValueError(size)


def main(params: str = "20m", steps: int = 30, clients: int = 8,
         batch: int = 2, seq: int = 128, device=None,
         history: dict | None = None):
    """The example's run; returns (losses, sim_wall).  `history` as in
    `train`."""
    cfg = model_cfg(params)
    n_param_est = (cfg.n_layers * (4 * cfg.d_model * cfg.d_ff
                                   + 4 * cfg.d_model * cfg.d_model)
                   + 2 * cfg.vocab * cfg.d_model)
    print(f"arch=qwen3-family ~{n_param_est / 1e6:.0f}M params, "
          f"{clients} federated clients, deadline aggregation")
    t0 = time.time()
    _, losses, sim_wall = train(
        cfg, steps=steps, batch=batch, seq=seq,
        federated=True, fl_cfg=FLConfig(n_clients=clients),
        log_every=max(1, steps // 10), device=device, history=history)
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {steps} steps "
          f"({time.time() - t0:.0f}s real, {sim_wall:.0f}s simulated "
          f"MEC wall-clock)")
    assert losses[-1] < losses[0], "training must reduce loss"
    return losses, sim_wall


def _cli(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="20m", choices=["20m", "100m"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    main(args.params, args.steps, args.clients, args.batch, args.seq,
         args.device)


if __name__ == "__main__":
    _cli()
