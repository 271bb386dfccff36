"""Training driver of the model zoo (the counterpart of
``repro.launch.train``), every family.

Two modes:
  * plain      — LM training on packed synthetic tokens (`make_batch`);
  * federated  — CodedFedL-style deadline aggregation generalized to deep
                 models: each data-parallel shard is a simulated MEC client
                 with the paper's delay model; gradients that miss the
                 optimized deadline t* are dropped and the survivors are
                 reweighted by 1/P(T_j <= t*) (the unbiasedness logic of
                 §III-E applied at the gradient-aggregation layer; the
                 parity-coded gradient itself is linear-model-only, see
                 ``repro_torch.core.coded_probe``).

The host quantities (the delay network, the allocation, the delay draws,
the batches) are NumPy copies of the reference's and match it bit for bit;
the gradients are plain autograd on the experiment's device.  The port's
initial weights come from a ``torch.Generator`` (other numbers than the
reference's ``jax.random``): `train(..., params=...)` takes carried ones
(``repro_torch.carry.model_params_from_reference``).  A VLM's `seq`
counts its patch positions (internvl2: seq > 256 at full width).

    PYTHONPATH=src python -m repro_torch.launch.train [--arch ARCH] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --full-config
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.configs import ARCH_IDS, get_config, smoke_variant
from repro_torch.core import load_allocation
from repro_torch.core.delay_model import mec_network, packet_bits, scale_tau
from repro_torch.data.pipeline import PackedLMDataset, PipelineConfig
from repro_torch.device import resolve_device, synchronize
from repro_torch.models.common import dtype_of
from repro_torch.models.model_zoo import build
from repro_torch.optim import optimizers
from repro_torch.optim.schedule import cosine


def make_batch(cfg, batch: int, seq: int, seed: int, shard_id: int = 0):
    """Training batch from the packed-LM pipeline (+ modality stubs), as
    CPU tensors; the tokens are those of ``repro.launch.train.make_batch``."""
    rng = np.random.default_rng(seed)
    out = {}
    ntok = seq
    if cfg.is_encdec:
        out["frames"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model))
        ).to(dtype_of(cfg))
    elif cfg.n_prefix_patches:
        out["patch_embeds"] = torch.from_numpy(
            rng.normal(size=(batch, cfg.n_prefix_patches, cfg.d_model))
        ).to(dtype_of(cfg))
        ntok = seq - cfg.n_prefix_patches
    ds = PackedLMDataset(PipelineConfig(
        vocab=cfg.vocab, seq_len=ntok, batch=batch, seed=seed * 1000003,
        n_shards=max(shard_id + 1, 1), shard_id=shard_id))
    b = ds.batch_at(0)
    out["tokens"] = torch.from_numpy(b["tokens"])
    out["labels"] = torch.from_numpy(b["labels"])
    return out


def federated_plan(fl: FLConfig, n_param: int, batch: int, seq: int):
    """The federated mode's delay network and deadline: (nodes, allocation,
    p_ret), p_ret[j] = P(T_j <= t*) at client j's load (host NumPy)."""
    nodes = [scale_tau(nd, packet_bits(fl, int(n_param)))
             for nd in mec_network(fl, d_scalars_per_point=seq * 4)]
    alloc = load_allocation.two_step_allocate(
        nodes, [float(batch)] * fl.n_clients, server=None,
        u_max=0.25 * batch * fl.n_clients, m=float(batch * fl.n_clients))
    p_ret = np.array([nd.cdf(alloc.t_star, float(l))
                      for nd, l in zip(nodes, alloc.loads)])
    return nodes, alloc, p_ret


def train(cfg, steps: int = 20, batch: int = 4, seq: int = 64,
          lr: float = 3e-3, optimizer: str = "adam", *,
          federated: bool = False, fl_cfg: FLConfig | None = None,
          log_every: int = 5, seed: int = 0, device=None, params=None,
          history: dict | None = None):
    """Returns (params, losses, wall_clock_sim).

    `device` defaults to the GPU; "cpu" runs there.  `params`: initial
    weights (a `Transformer` or an `EncDec`, moved to `device` and trained
    in place);
    default the port's seeded draw.  A step where no client returns before
    t* (federated) logs a NaN loss and updates nothing.  `history`, where
    given, receives ``step_s`` (each step's seconds, the device synced at
    its end) and, federated, ``t_star``, ``loads``, ``p_ret`` and
    ``returned`` (each step's returned clients, in client order)."""
    dev = resolve_device(device)
    model = build(cfg)
    if params is None:
        params = model.init_params(seed=seed, device=dev)
    params.to(dev).requires_grad_(True)
    named = dict(params.named_parameters())
    opt_init, opt_update = optimizers.get(optimizer)
    opt_state = opt_init(named)
    lr_fn = cosine(lr, steps, warmup=min(10, steps // 10))
    rec = history if history is not None else {}
    rec["step_s"] = []

    def grad_fn(b):
        for p in named.values():
            p.grad = None
        loss = model.loss_fn(params, b, remat=False)
        loss.backward()
        grads = {k: p.grad for k, p in named.items()}
        for p in named.values():
            p.grad = None
        return loss.detach(), grads

    # federated setup: n simulated clients, one delay node each
    sim_wall = 0.0
    if federated:
        fl = fl_cfg or FLConfig(n_clients=8)
        n_param = sum(p.numel() for p in named.values())
        nodes, alloc, p_ret = federated_plan(fl, n_param, batch, seq)
        t_star = alloc.t_star
        rng = np.random.default_rng(seed + 5)
        rec.update(t_star=t_star, loads=list(alloc.loads),
                   p_ret=p_ret.tolist(), returned=[])

    losses = []
    for step in range(steps):
        t0 = time.perf_counter()
        if not federated:
            b = make_batch(cfg, batch, seq, seed + step)
            loss, grads = grad_fn(b)
        else:
            # every client computes a gradient on its shard; stragglers drop
            total, got, loss_acc, returned = None, 0, 0.0, []
            for j in range(fl.n_clients):
                t_j = nodes[j].sample(rng, float(alloc.loads[j]))[0]
                if t_j > t_star:
                    continue
                b = make_batch(cfg, batch, seq, seed + step * 131 + j)
                loss_j, g_j = grad_fn(b)
                w = 1.0 / max(p_ret[j], 1e-3)      # expected-return reweight
                if total is None:
                    total = {k: g * w for k, g in g_j.items()}
                else:
                    for k, g in g_j.items():
                        total[k].add_(g * w)
                del g_j
                loss_acc += float(loss_j)
                got += 1
                returned.append(j)
            sim_wall += t_star
            rec["returned"].append(returned)
            if total is None:
                losses.append(float("nan"))
                rec["step_s"].append(time.perf_counter() - t0)
                continue
            grads = {k: g.div_(fl.n_clients) for k, g in total.items()}
            loss = loss_acc / max(got, 1)
        opt_update(named, grads, opt_state, lr_fn(step))
        del grads
        losses.append(float(loss))
        synchronize(dev)
        rec["step_s"].append(time.perf_counter() - t0)
        if log_every and step % log_every == 0:
            print(f"step {step:4d} loss {float(loss):.4f}")
    return params, losses, sim_wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--federated", action="store_true")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-smoke) config — not for CPU")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                    "plain path on the host)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = smoke_variant(cfg)
    t0 = time.time()
    _, losses, sim_wall = train(cfg, steps=args.steps, batch=args.batch,
                                seq=args.seq, federated=args.federated,
                                device=args.device)
    print(f"final loss {losses[-1]:.4f}  ({time.time() - t0:.1f}s"
          + (f", simulated FL wall-clock {sim_wall:.1f}s" if args.federated
               else "") + ")")


if __name__ == "__main__":
    main()
