#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs CUDA

Phases, each printed as one JSON object per line:

  1. card:   the GPU's name and power limit, as nvidia-smi reports them;
  2. build:  nvcc builds every CUDA kernel of the port from csrc/;
  3. main:   the port's main path at the paper's MNIST-RFF width (n = 30
             clients, m = 12000, d = 784, q = 2000, c = 10, delta = 0.2,
             psi = 0.2): synthetic MNIST-like data embedded through the
             rff_embed kernel, sort-and-shard over 30 clients, then
             build_experiment(...).run(20) for coded, naive and greedy.
             Launch counts are reset before and read after, and asserted;
  4. cpu:    the same coded deployment for 3 rounds on the card and on the
             CPU (plain versions); returned counts and wall clock must be
             identical and theta must agree within the stated tolerance;
  5. kernel: each kernel against its plain PyTorch version on the card, at
             the main path's shapes (its own inputs) and at edge shapes one
             below, at and one above a tile multiple; times with CUDA events;
  6. the kernels table, then the final line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failure raises and the script exits non-zero without the final line.
It exits 2 at once where there is no CUDA device or no src/repro_torch.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"

# the paper's MNIST-RFF workload (src/repro/configs/mnist_rff.py) at the
# settings of examples/mnist_codedfedl.py --full
SIZE = dict(n_clients=30, m_train=12000, m_test=2000, d=784, q=2000)
ROUNDS = 20
CPU_ROUNDS = 3
PEAK_FLOPS = 67e12        # H100 SXM float32, outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# |kernel - plain| <= REL_TOL * max(1, max|plain|): float32 sums of up to
# K = 2400 terms taken in another order than the plain version's (cuBLAS,
# TF32 off); the expected error is ~sqrt(K) ulp of the output's scale
REL_TOL = 1e-5
# theta after CPU_ROUNDS rounds, card vs CPU: the same float32 differences,
# carried through the parity set and three SGD updates
THETA_REL_TOL = 1e-4

TPU_KERNELS = [
    ("rff_embed", "src/repro/kernels/rff_embed.py:39",
     "src/repro_torch/kernels/csrc/rff_embed.cu"),
    ("parity_encode_batched", "src/repro/kernels/parity_encode.py:75",
     "src/repro_torch/kernels/csrc/parity_encode.cu"),
    ("linreg_grad_masked", "src/repro/kernels/linreg_grad.py:128",
     "src/repro_torch/kernels/csrc/linreg_grad.cu"),
]
NOT_YET_PORTED = [
    ("rff_linreg_grad_masked", "src/repro/kernels/rff_linreg_grad.py:110",
     "fused_embed=True path"),
    ("linreg_grad", "src/repro/kernels/linreg_grad.py:83",
     "fused_coded=False path and the legacy oracle"),
    ("parity_encode", "src/repro/kernels/parity_encode.py:39",
     "per-client encoding.encode_local"),
    ("gqa_decode", "src/repro/kernels/gqa_decode.py:67",
     "model zoo only"),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name, power = (s.strip() for s in out.split(",", 1))
    return {"phase": "card", "nvidia_smi": out, "name": name,
            "power_limit": power}


def time_ms(torch, fn, reps: int) -> float:
    """Mean ms per call over `reps` calls after one warm-up, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, want) -> tuple[float, float]:
    err = float((got - want).abs().max())
    tol = REL_TOL * max(1.0, float(want.abs().max()))
    check(math.isfinite(err) and err <= tol,
          f"kernel disagrees with its plain version: {err} > {tol}")
    return err, tol


def main_path(torch, dev):
    """The port's main path at MNIST-RFF width; returns what the kernel
    checks reuse (the main path's own tensors)."""
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.config import FLConfig, RFFConfig, TrainConfig
    from repro_torch.core import encoding, load_allocation, rff
    from repro_torch.core.delay_model import mec_network
    from repro_torch.data import sharding, synthetic
    from repro_torch.kernels import ops

    n_clients, m_train, d, q = (SIZE[k] for k in ("n_clients", "m_train",
                                                  "d", "q"))
    t0 = time.perf_counter()
    ds = synthetic.synthetic_classification(
        m_train=m_train, m_test=SIZE["m_test"], d=d, seed=0)
    data_s = time.perf_counter() - t0
    rcfg = RFFConfig(q=q, sigma=5.0)
    fl = FLConfig(n_clients=n_clients, delta=0.2, psi=0.2, seed=0)

    ops.reset_launch_counts()
    # 1. shared-seed RFF embedding of the client data, on the card
    t0 = time.perf_counter()
    omega, delta = rff.rff_params(rcfg, d, device=dev)
    x_tr = torch.from_numpy(ds.x_train).to(dev)
    xh_tr = rff.rff_transform(x_tr, omega, delta)
    xh_te = rff.rff_transform(torch.from_numpy(ds.x_test).to(dev), omega,
                              delta)
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    # 2. non-IID partition over the MEC network (host, as the reference)
    t0 = time.perf_counter()
    xh_tr_host = xh_tr.cpu().numpy()
    lr = rff.suggest_lr(xh_tr_host)
    nodes = mec_network(fl, d_scalars_per_point=q * ds.n_classes)
    shards = sharding.sort_and_shard(xh_tr_host, ds.y_train, n_clients)
    per_client = sharding.assign_shards_by_speed(
        shards, nodes, minibatch=m_train // n_clients)
    xs = np.stack([c[0] for c in per_client])
    ys = np.stack([ds.one_hot(c[1]) for c in per_client])
    shard_s = time.perf_counter() - t0
    emit({"phase": "data", "x_stack": list(xs.shape),
          "y_stack": list(ys.shape), "lr": lr, "make_data_s": data_s,
          "embed_s": embed_s, "shard_s": shard_s})

    y_te = torch.from_numpy(ds.y_test).to(dev)
    y_te_hot = torch.from_numpy(ds.one_hot(ds.y_test)).to(dev)

    def eval_fn(theta):
        pred = xh_te @ theta
        loss = float(((pred - y_te_hot) ** 2).mean())
        return loss, float((pred.argmax(1) == y_te).float().mean())

    # the process's first cuBLAS call sets up its handle: take it here, so
    # that it does not land in the first scheme's round time
    eval_fn(torch.zeros((q, ds.n_classes), device=dev))
    torch.cuda.synchronize()

    tc = TrainConfig(learning_rate=lr, lr_decay_epochs=(
        int(ROUNDS * 0.55), int(ROUNDS * 0.8)))
    base = ExperimentSpec(fl=fl, train=tc, rff=rcfg)
    results = {}
    for scheme in ("coded", "naive", "greedy"):
        before = dict(ops.LAUNCHES)
        t0 = time.perf_counter()
        exp = build_experiment(dataclasses.replace(base, scheme=scheme),
                               xs, ys, device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = exp.run(ROUNDS, eval_fn=eval_fn, eval_every=10)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
        theta_ok = bool(torch.isfinite(res.theta).all())
        h = res.history[-1]
        emit({"phase": "main", "scheme": scheme, "rounds": ROUNDS,
              "t_star": res.t_star, "u": getattr(exp, "u", None),
              "wall_clock": h.wall_clock, "setup_time": res.setup_time,
              "returned": [r.returned for r in res.history],
              "accuracy": h.accuracy, "loss": h.loss,
              "mean_round_time": (h.wall_clock - res.setup_time) / ROUNDS,
              "privacy_eps": res.privacy_eps, "setup_s": setup_s,
              "ms_per_round": run_s / ROUNDS * 1e3, "launches": launches,
              "theta_finite": theta_ok})
        check(theta_ok, f"{scheme}: theta is not finite")
        check(h.accuracy > 0.1, f"{scheme}: accuracy {h.accuracy} <= 0.1")
        check(launches["linreg_grad_masked"] == ROUNDS,
              f"{scheme}: linreg_grad_masked launched "
              f"{launches['linreg_grad_masked']} times in {ROUNDS} rounds")
        check(launches["parity_encode_batched"]
              == (2 if scheme == "coded" else 0),
              f"{scheme}: parity_encode_batched launched "
              f"{launches['parity_encode_batched']} times")
        results[scheme] = (exp, res)
    main_launches = dict(ops.LAUNCHES)
    check(main_launches["rff_embed"] >= 1, "rff_embed never launched")
    for name, count in main_launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    # the first run of a process pays one-time costs (lazily loaded CUDA
    # modules of the PyTorch ops, the round tensors): run each deployment
    # again, without eval, for the steady per-round time
    warm = {}
    for scheme, (exp, _) in results.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.run(ROUNDS)
        torch.cuda.synchronize()
        warm[scheme] = (time.perf_counter() - t0) / ROUNDS * 1e3
    emit({"phase": "warm", "rounds": ROUNDS, "ms_per_round": warm})
    # where the coded setup's time goes: its host-side steps, timed alone
    exp = results["coded"][0]
    t0 = time.perf_counter()
    load_allocation.two_step_allocate(
        exp.nodes, [float(exp.l)] * exp.n, server=None, u_max=float(exp.u),
        m=float(exp.m))
    alloc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_stack = encoding.generator_stack(exp.fl.seed + 99, exp.n, exp.u,
                                       exp.l, device=dev)
    torch.cuda.synchronize()
    generators_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exp.scheme_obj.privacy_budget(exp)
    privacy_s = time.perf_counter() - t0
    emit({"phase": "setup", "scheme": "coded", "alloc_s": alloc_s,
          "generators_s": generators_s, "privacy_s": privacy_s})
    naive = results["naive"][1].history[-1].wall_clock / ROUNDS
    emit({"phase": "main", "launches": main_launches,
          "coded_t_star": results["coded"][1].t_star,
          "naive_mean_round_time": naive})
    return dict(spec=dataclasses.replace(base, scheme="coded"), xs=xs, ys=ys,
                x_tr=x_tr, omega=omega, delta=delta, coded=results["coded"],
                g_stack=g_stack,
                launches=main_launches)


def cpu_twin(torch, dev, state) -> None:
    """Coded for CPU_ROUNDS rounds on the card and on the CPU."""
    from repro_torch.api import build_experiment
    runs = {}
    for device in (dev, "cpu"):
        t0 = time.perf_counter()
        res = build_experiment(state["spec"], state["xs"], state["ys"],
                               device=device).run(CPU_ROUNDS)
        runs[str(device)] = (res, time.perf_counter() - t0)
    (gpu, gpu_s), (cpu, cpu_s) = runs[str(dev)], runs["cpu"]
    th_gpu, th_cpu = gpu.theta.cpu(), cpu.theta
    err = float((th_gpu - th_cpu).abs().max())
    tol = THETA_REL_TOL * max(1.0, float(th_cpu.abs().max()))
    same_clock = ([h.wall_clock for h in gpu.history]
                  == [h.wall_clock for h in cpu.history])
    same_ret = ([h.returned for h in gpu.history]
                == [h.returned for h in cpu.history])
    emit({"phase": "cpu", "rounds": CPU_ROUNDS, "theta_max_abs_err": err,
          "tol": tol, "tol_reason": "float32 sums in another order, through "
          "the parity encode and 3 SGD updates; relative to max|theta|",
          "wall_clock_identical": same_clock, "returned_identical": same_ret,
          "gpu_s": gpu_s, "cpu_s": cpu_s})
    check(same_clock and same_ret, "card and CPU runs saw other rounds")
    check(err <= tol, f"card theta differs from CPU theta: {err} > {tol}")


def kernel_checks(torch, dev, state) -> list:
    """Each kernel against its plain version on the card; timings."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def unif(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    exp, res = state["coded"]
    consts = exp.build_consts()
    g_stack = state["g_stack"]     # the main path's generators, redrawn
    q_true = state["omega"].shape[1]

    # (name, main-path inputs, edge inputs, library call, bytes, flops)
    rff_main = (state["x_tr"], state["omega"], state["delta"])
    m, d = rff_main[0].shape
    rff_edges = [(unif(mm, dd), randn(dd, qq, scale=0.2),
                  unif(qq, hi=2 * math.pi))
                 for mm, dd, qq in ((63, 15, 63), (64, 16, 64), (65, 17, 65))]

    def rff_lib(x, om, de):
        return torch.addmm(de, x, om).cos_().mul_(math.sqrt(2.0 / om.shape[1]))

    par_main = (g_stack, exp.w_stack, exp.x)
    par_y = (g_stack, exp.w_stack, exp.y)
    n, u, l = g_stack.shape
    par_edges = [(randn(nn, uu, ll), unif(nn, ll, lo=0.2), randn(nn, ll, qq))
                 for nn, uu, ll, qq in ((2, 63, 15, 63), (2, 64, 16, 64),
                                        (3, 65, 17, 65))] + [par_y]

    def par_lib(g, w, x):
        return torch.bmm(g, x * w[:, :, None])

    lin_main = (consts["gx"], res.theta, consts["gy"], consts["gmask"])
    rows, L, q = lin_main[0].shape
    c = lin_main[1].shape[1]
    lin_edges = [(randn(nn, LL, qq, scale=0.3), randn(qq, cc, scale=0.3),
                  randn(nn, LL, cc), unif(nn, LL))
                 for nn, LL, qq, cc in ((2, 63, 127, 15), (2, 64, 128, 16),
                                        (2, 65, 129, 17))]

    def lin_lib(x, th, y, mask):
        r = torch.baddbmm(y, x, th.expand(x.shape[0], *th.shape), beta=-1)
        return torch.bmm(x.mT, r * mask[:, :, None])

    specs = [
        ("rff_embed", lambda *a: ops.rff_embed(*a, q_true=q_true),
         lambda *a: ref.rff_embed(*a, q_true=q_true), rff_lib,
         rff_main, rff_edges,
         4 * (m * d + d * q_true + q_true + m * q_true),
         2 * m * d * q_true, 10),
        ("parity_encode_batched", ops.parity_encode_batched,
         ref.parity_encode_batched, par_lib, par_main, par_edges,
         4 * (n * u * l + n * l + n * l * exp.q + n * u * exp.q),
         2 * n * u * l * exp.q, 5),
        ("linreg_grad_masked", ops.linreg_grad_masked,
         ref.linreg_grad_masked, lin_lib, lin_main, lin_edges,
         4 * (rows * L * q + q * c + rows * L * c + rows * L + rows * q * c),
         4 * rows * L * q * c, 20),
    ]
    table = []
    for (name, kern, plain, lib, main, edges, nbytes, flops,
         reps), (_, replaces, source) in zip(specs, TPU_KERNELS):
        checks = []
        for args in [main] + edges:
            got = kern(*args)
            torch.cuda.synchronize()
            err, tol = max_err(torch, got, plain(*args))
            checks.append({"shape": [list(a.shape) for a in args],
                           "max_abs_err": err, "tol": tol})
        lib_err, _ = max_err(torch, lib(*main), plain(*main))
        kernel_ms = time_ms(torch, lambda: kern(*main), reps)
        plain_ms = time_ms(torch, lambda: plain(*main), reps)
        library_ms = time_ms(torch, lambda: lib(*main), reps)
        bound_ms, bound_by = bound(nbytes, flops)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": state["launches"][name],
               "max_abs_err": checks[0]["max_abs_err"], "ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms,
               "shape": checks[0]["shape"], "status": "ported, checked"}
        emit({"phase": "kernel", **row, "kernel_ms": kernel_ms,
              "checks": checks, "library_max_abs_err": lib_err,
              "tol_reason": f"|kernel - plain| <= {REL_TOL} * "
              "max(1, max|plain|): float32 sums in another order",
              "bytes": nbytes, "flops": flops, "reps": reps})
        table.append(row)
    return table


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run this "
              "script from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from repro_torch.kernels import build

    emit(card_line())
    t0 = time.perf_counter()
    build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    t0 = time.perf_counter()
    state = main_path(torch, dev)
    emit({"phase": "main", "seconds": time.perf_counter() - t0})
    cpu_twin(torch, dev, state)
    table = kernel_checks(torch, dev, state)
    emit({"kernels": table, "not_yet_ported": [
        {"name": name, "replaces": where, "status": "not yet ported",
         "path": path} for name, where, path in NOT_YET_PORTED]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
