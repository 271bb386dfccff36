"""The paper's reproduction driver (Fig. 4 / Tables II-III, MNIST scale) on
the port: the counterpart of ``examples/mnist_codedfedl.py`` and of the
experiment it drives, ``benchmarks/bench_fed_training.py``.

Trains the paper's workload — RFF kernel regression, (sigma, q) = (5,
2000) at 784 features, 30 clients, the LTE-parameterized delay network,
the non-IID sort-and-shard split — under naive, greedy and coded, and
reports time-to-accuracy speedups: gamma = 0.95 x naive's final
accuracy, tU/tC and tG/tC, the non-IID accuracy gap, the wall-clock bands
of naive and coded over 8 delay realizations, and the host speedup of the
batched engine over the legacy per-client loop (coded, n = 32).  MNIST
itself is not available offline; a statistically matched synthetic task
stands in (`repro_torch.data.synthetic`).  Wall-clock numbers are
simulated seconds from the paper's delay models.

    PYTHONPATH=src python -m repro_torch.launch.mnist_codedfedl [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.mnist_codedfedl --full

``--full`` is the paper's scale: m = 12000, q = 2000, d = 784, sigma = 5,
350 rounds, n = 30.  The embedding runs through the ``rff_embed`` kernel on
the card; the test-set accuracy is a plain ``torch.matmul`` on the
experiment's device.  The port draws (Omega, delta) and the parity
generators with its own generators; `main` takes the reference's draws
instead (``rff_draw``, ``parity_generators``, see ``repro_torch.carry``).
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api import ExperimentSpec, build_experiment
from repro_torch.config import FLConfig, RFFConfig, TrainConfig
from repro_torch.core import rff
from repro_torch.core.delay_model import mec_network
from repro_torch.data import sharding, synthetic
from repro_torch.device import resolve_device, synchronize

SCHEMES = ("naive", "greedy", "coded")
#: --full: the paper's scale
FULL = dict(m_train=12000, q=2000, d=784, iters=350)
#: realizations of the wall-clock bands
BAND_REALIZATIONS = 8


def engine_runs(n_clients: int = 32, l: int = 64, q: int = 128, c: int = 10,
                iters: int = 150, seed: int = 0, device=None) -> dict:
    """Coded at `n_clients` on the batched engine and on the legacy
    per-client loop: {engine: {"experiment", "result", "seconds",
    "rng_state"}}, ``seconds`` one cold `run()` from a synchronized device
    to a synchronized device (the batched one pays its first-call costs),
    ``rng_state`` the experiment's host generator before the run (its
    delays replay from there)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n_clients, l, q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(n_clients, l, c)).astype(np.float32)
    fl = FLConfig(n_clients=n_clients, delta=0.2, psi=0.2, seed=seed)
    tcfg = TrainConfig(learning_rate=0.5, l2_reg=1e-5)
    runs = {}
    for engine in ("batched", "legacy"):
        exp = build_experiment(ExperimentSpec(fl=fl, train=tcfg,
                                              scheme="coded", engine=engine),
                               xs, ys, device=dev)
        state = exp.rng.bit_generator.state
        synchronize(dev)
        t0 = time.perf_counter()
        res = exp.run(iters)
        synchronize(dev)
        runs[engine] = {"experiment": exp, "result": res,
                        "seconds": time.perf_counter() - t0,
                        "rng_state": state}
    return runs


def engine_speedup(runs: dict) -> list:
    """Host wall-clock of `engine_runs`' two runs, batched vs. legacy
    per-client loop, as the reference's row."""
    batched, legacy = runs["batched"]["seconds"], runs["legacy"]["seconds"]
    n = runs["batched"]["experiment"].n
    return [(f"fed_engine_speedup_coded_n{n}", batched * 1e6,
             f"legacy_us={legacy * 1e6:.0f};speedup={legacy / batched:.1f}x")]


def run_paper(m_train: int = 3000, q: int = 256, d: int = 64,
              n_clients: int = 30, iters: int = 200, delta: float = 0.2,
              psi: float = 0.2, seed: int = 0, device=None, rff_draw=None,
              parity_generators: Optional[dict] = None,
              engine_kwargs: Optional[dict] = None) -> dict:
    """The experiment of ``benchmarks/bench_fed_training.run`` on `device`.

    Returns ``rows`` (the reference's CSV rows), ``results`` ({scheme:
    FedResult}, accuracy every 5 rounds), ``experiments``, ``rng_states``
    (each experiment's host generator before its run), ``setup_s`` and
    ``run_s`` per scheme (device-synchronized), ``gamma`` and ``t_gamma``
    ({scheme: first wall clock at accuracy >= gamma, inf if never}),
    ``bands`` ({scheme: (mean, std)}), ``engine`` (`engine_runs`' output
    at its defaults, or at `engine_kwargs`) and the deployment (``xs``,
    ``ys``, ``specs``).  `rff_draw` = (omega (d, q), delta (q,)) and
    `parity_generators` ({scheme: (n, u, l) stack}) replace the port's own
    draws.
    """
    dev = resolve_device(device)
    fl = FLConfig(n_clients=n_clients, delta=delta, psi=psi, seed=seed)
    ds = synthetic.synthetic_classification(m_train=m_train,
                                            m_test=max(500, m_train // 6),
                                            d=d, seed=seed)
    rcfg = RFFConfig(q=q, sigma=2.0 if d < 256 else 5.0)
    if rff_draw is None:
        om, de = rff.rff_params(rcfg, d, device=dev)
    else:
        om, de = (torch.as_tensor(np.array(a, np.float32), device=dev)
                  for a in rff_draw)
    xh_tr = rff.rff_transform(torch.from_numpy(ds.x_train).to(dev), om,
                              de).cpu().numpy()
    xh_te = rff.rff_transform(torch.from_numpy(ds.x_test).to(dev), om, de)
    y_te = torch.from_numpy(ds.y_test).to(dev)
    lr = rff.suggest_lr(xh_tr)
    nodes = mec_network(fl, d_scalars_per_point=q * ds.n_classes)
    shards = sharding.sort_and_shard(xh_tr, ds.y_train, n_clients)
    minibatch = xh_tr.shape[0] // n_clients
    per_client = sharding.assign_shards_by_speed(shards, nodes, minibatch)
    xs = np.stack([cl[0] for cl in per_client])
    ys = np.stack([ds.one_hot(cl[1]) for cl in per_client])
    tcfg = TrainConfig(learning_rate=lr,
                       lr_decay_epochs=(int(iters * 0.55), int(iters * 0.8)))

    def eval_fn(theta):
        acc = (torch.matmul(xh_te, theta).argmax(1) == y_te).double().mean()
        return 0.0, float(acc)

    gens = parity_generators or {}
    out = {"results": {}, "experiments": {}, "rng_states": {},
           "setup_s": {}, "run_s": {}, "specs": {}, "xs": xs, "ys": ys}
    rows = []
    for scheme in SCHEMES:
        spec = ExperimentSpec(fl=fl, train=tcfg, rff=rcfg, scheme=scheme)
        synchronize(dev)
        t0 = time.perf_counter()
        sim = build_experiment(spec, xs, ys, device=dev,
                               parity_generators=gens.get(scheme))
        synchronize(dev)
        t1 = time.perf_counter()
        out["rng_states"][scheme] = sim.rng.bit_generator.state
        res = sim.run(iters, eval_fn=eval_fn, eval_every=5)
        synchronize(dev)
        t2 = time.perf_counter()
        out["results"][scheme], out["experiments"][scheme] = res, sim
        out["specs"][scheme] = spec
        out["setup_s"][scheme], out["run_s"][scheme] = t1 - t0, t2 - t1
        final = res.history[-1]
        rows.append((f"fed_{scheme}_sim", (t2 - t0) * 1e6,
                     f"acc={final.accuracy:.3f};wall={final.wall_clock:.0f}s"))

    # time-to-accuracy speedups (Tables II/III analog)
    results = out["results"]
    target = 0.95 * results["naive"].history[-1].accuracy

    def t_gamma(res):
        for h in res.history:
            if not np.isnan(h.accuracy) and h.accuracy >= target:
                return h.wall_clock
        return float("inf")

    tU, tG, tC = (t_gamma(results[s]) for s in ("naive", "greedy", "coded"))
    out["gamma"] = target
    out["t_gamma"] = {"naive": tU, "greedy": tG, "coded": tC}
    rows.append(("fed_speedup_vs_naive", 0.0,
                 f"gamma={target:.3f};tU/tC={tU / tC:.2f}x"))
    rows.append(("fed_speedup_vs_greedy", 0.0,
                 f"tG/tC={tG / tC if np.isfinite(tG) else float('inf'):.2f}x"
                 if np.isfinite(tG) else "greedy_never_reaches_target"))
    acc_gap = (results["naive"].history[-1].accuracy
               - results["greedy"].history[-1].accuracy)
    rows.append(("fed_noniid_acc_gap_naive_minus_greedy", 0.0,
                 f"{acc_gap:.3f}"))

    # Fig 4/5 confidence bands: R independent delay realizations on the
    # deployments above (their generators continue after the runs)
    out["bands"] = {}
    for scheme in ("naive", "coded"):
        synchronize(dev)
        t0 = time.perf_counter()
        multi = out["experiments"][scheme].run_multi(iters,
                                                     BAND_REALIZATIONS)
        synchronize(dev)
        us = (time.perf_counter() - t0) * 1e6
        mean, std = multi.wall_clock_bands()
        out["bands"][scheme] = (mean, std)
        rows.append((f"fed_{scheme}_wall_bands_r{BAND_REALIZATIONS}", us,
                     f"final={mean[-1]:.0f}s±{std[-1]:.1f}s"))

    out["engine"] = engine_runs(device=dev, **(engine_kwargs or {}))
    out["rows"] = rows + engine_speedup(out["engine"])
    return out


def main(full: bool = False, delta: float = 0.2, psi: float = 0.2,
         device=None, rff_draw=None,
         parity_generators: Optional[dict] = None,
         out: Callable[[str], None] = print, **sizes) -> dict:
    """Run the driver and print what ``examples/mnist_codedfedl.py``
    prints: the CSV rows, then the accuracy-vs-iteration table.  `sizes`
    (m_train, q, d, n_clients, iters, seed, engine_kwargs) override the
    reduced scale; `full` takes the paper's.  Returns `run_paper`'s dict."""
    kw = dict(delta=delta, psi=psi, **sizes)
    if full:
        kw.update(FULL)
    res = run_paper(device=device, rff_draw=rff_draw,
                    parity_generators=parity_generators, **kw)
    out("name,us_per_call,derived")
    for name, us, derived in res["rows"]:
        out(f"{name},{us:.1f},{derived}")
    out("\naccuracy vs iteration (coded should track naive, greedy lag):")
    hist = {s: r.history for s, r in res["results"].items()}
    for i in range(0, len(hist["naive"]), max(1, len(hist["naive"]) // 12)):
        row = {s: hist[s][i].accuracy for s in hist}
        out(f"  iter {i:4d}  naive={row['naive']:.3f} "
            f"greedy={row['greedy']:.3f} coded={row['coded']:.3f}")
    return res


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="paper scale: m=12000, q=2000, d=784, 350 iters")
    ap.add_argument("--delta", type=float, default=0.2,
                    help="coding redundancy u_max/m (paper: 0.1 / 0.2)")
    ap.add_argument("--psi", type=float, default=0.2,
                    help="greedy drop fraction (paper: 0.1 / 0.2)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    main(args.full, args.delta, args.psi, device=args.device)


if __name__ == "__main__":
    _cli()
