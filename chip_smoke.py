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
  5. fused_embed: coded, naive and greedy with fused_embed=True on the RAW
             (30, 400, 784) shards, one rff_linreg_grad_masked launch a
             round (the coded round passes its live rows, l_max client rows
             and u parity rows); the coded run against its two-pass control
             (the main path's coded deployment, whose embedded shards are
             shown to be the same bits), its device memory held far below
             one (rows, L, q) tensor, and its warm ms per round;
  6. unfused: coded with fused_coded=False, the coded gradient a separate
             linreg_grad launch a round, against the main path's coded run;
  7. legacy: coded, naive and greedy on engine="legacy", the per-client
             oracle, against the main path's batched runs;
  8. encode_local: the per-client parity_encode loop over the coded
             deployment's 30 clients, then aggregate_parity, against the
             batched encode of the main path, bit for bit;
  9. resume: the main path's coded deployment with checkpoint_every = 5:
             one block, a checkpoint in the git-ignored build/, the kill,
             then a freshly built experiment restores it (digest verified)
             and finishes; theta, wall clock and returned counts bit-identical
             to the uninterrupted blocked run, 20 linreg_grad_masked launches
             over the killed and the resumed run; save and restore times;
 10. multi:  run_multi(20, 8) on the main path's coded and naive
             deployments: the (8, 20) wall clock and returned counts equal
             to the delay draw replayed on the host, bit for bit; 8 x 20
             launches; run_multi(20, 1) equal to run(20) from the same
             generator position; warm ms per realization-round;
 11. alloc:  MNIST-RFF at n = 100 clients (l = 120): the vectorized
             allocator in float64 on the card against the scalar one on the
             host (both timed; t* within 2e-6 (1 + t*), loads within 1e-4,
             node for node within 1e-6 (1 + l)), then a coded deployment
             whose auto backend picks the vectorized solver, run 20 rounds;
 12. quickstart: repro_torch.launch.quickstart.main() on the card: five
             schemes, kill/resume bit-identical, bands over 8 realizations;
 13. channel: the main path's deployment under channel profiles: "static"
             for coded, naive and greedy, bit-identical to the main path's
             runs; coded, naive, greedy and ideal under drift_churn, 20
             rounds each, wall clock and returned counts equal to the host
             replay of the trace and the traced delays, 20
             linreg_grad_masked launches a run, warm ms per round beside
             the stationary round's; coded card against CPU for 3 rounds;
             fused_embed coded (20 rff_linreg_grad_masked launches) and
             fused_coded=False coded (20 linreg_grad launches) under the
             channel against the channel coded run; warm runs of the
             stationary and the channel deployments timed in turns (6
             pairs each of coded, naive, greedy: the traced round's host
             cost), each beside its device time a round (torch.profiler);
             run_multi(20, 4) of
             coded and naive against the host replay (one trace stream a
             realization);
 14. adaptive: adaptive_coded under degrade_drift, adapt_every 5,
             checkpoint_every 5, 20 rounds: re-plan times (3, on the
             scalar solver), ms per round without them and of the round
             loop alone (replayed from the schedule: the same theta bits),
             beside the stationary coded round; the schedule bit-identical
             to a CPU run of the same spec and theta within tolerance;
             killed after one block and resumed in a fresh experiment,
             bit-identical (theta, rounds, schedule); adaptive_greedy under
             churn, card against CPU; adaptive_coded at n = 100 (l = 120),
             auto re-planning on the vectorized solver on the card;
             repro_torch.launch.adaptive_drift.main() (120 launches, the
             adaptive run sooner to the target);
 15. faults: return faults at MNIST-RFF width: coded (fused and
             fused_coded=False) under "chaos" (NaN/inf mix, stale replay,
             parity corruption) and naive under "flaky_clients" with the
             guard on and off, 20 rounds each; wall clock and returned
             counts bit-identical to the clean twin (the main path's run),
             n_masked to the host replay of the fault stream
             (default_rng((seed + 7717,))); under stale replay each round
             launches linreg_grad_masked twice (40 a run, + 20 linreg_grad
             unfused), naive 20; coded ends finite with no skipped round,
             naive unguarded skips rounds and backs its lr off; warm ms per
             round beside the clean twin's; coded card against CPU for 3
             rounds; checkpoint_every = 5 with stale faults: the newest two
             checkpoints corrupted (truncate, bitflip), a fresh experiment
             resumes from the newest intact one bit for bit (theta_prev and
             fault_rng_state in the checkpoint);
 16. secure_agg: the coded deployment with secure_aggregation=True: its
             global parity within secure_agg.rounding_tolerance of the main
             path's unmasked one (the gap printed), 2 parity_encode_batched
             launches, the 20-round run's wall clock and returned counts
             equal to the main coded run's and theta within tolerance; the
             setup split into the solver, the encode and the masks;
 17. sweep:  launch.sweep.run_sweep over uniform, paper and extreme with
             every grid scheme, R = 4, T = 20: 1200 linreg_grad_masked
             launches; each cell against the deployment's run_multi(20, 4)
             from the same generator position (wall clock and returned
             counts equal, theta bit for bit); host_seconds beside the
             looped time;
 18. telemetry: run telemetry (repro_torch.obs) at MNIST-RFF width: a
             coded deployment built inside collecting(), 20 rounds with
             checkpoint_every 5 and a journal under the git-ignored
             build/chip_smoke_obs; theta, wall clock and returned counts
             bit-identical to a telemetry-off run from the same generator
             position, history_from_journal equal to the run's history, two
             same-seed journals byte-identical, every REQUIRED_SPANS name
             recorded, 20 linreg_grad_masked launches; the span totals,
             attribution's top stragglers and comp_share_mean, the warm
             ms/round with spans off and on in turns, the head of
             render_report; then launch.report.run_telemetry on the card at
             its defaults: its three invariants, and overhead_ratio beside
             the reference's ceiling of 1.05 (printed, not a gate);
 19. service: launch.service.ExperimentService at MNIST-RFF width: a coded
             and a naive job (20 rounds, checkpoint_every 5, spans on, so
             each is journaled) through an uninterrupted control service,
             and through a service dropped after 3 steps and resumed by a
             fresh one on its root (build/chip_smoke_service): theta,
             history and events.jsonl bytes equal to the control's; 80
             linreg_grad_masked launches; health_report's block and
             checkpoint-save times per block; then
             launch.resilience.run_resilience on the card at the
             reference's defaults, validate_resilience == [];
 20. hier:   the hierarchical tier at MNIST-RFF width: the main path's
             embedded shards over 3 edge aggregators (n_s = 10, l = 400,
             q = 2000, c = 10, u_s = 800), sample_fraction 0.5, 20 rounds
             in blocks of 5, built and run with telemetry on and a journal
             under the git-ignored build/chip_smoke_hier: 6
             parity_encode_batched launches a build, 60 linreg_grad_masked
             and 60 linreg_grad a run; returned counts and wall clock equal
             to the host replay of the delay and cohort streams; the spans
             hier/shard_setup, solver/two_step, encode/parity,
             hier/round_block, one attribution a shard, t_star_s in every
             journal event; card against CPU for 3 rounds (loads equal, t*
             within 2e-6 (1 + t*), returned counts equal, theta within
             tolerance); killed after one block and resumed in a fresh
             experiment, and blocks of 4, bit-identical to blocks of 5; the
             f = 1 twin (same plans and delay stream, reweight 1); setup
             split by span, warm ms/round, and the share of a round that
             uploads the shards' client blocks;
 21. hier_scale: repro_torch.launch.hier_scale.main() on the card (n =
             10,000 over 10 shards, l = 8, q = 16, c = 3, f = 0.25, the
             kill/resume against the uninterrupted run), then
             launch.scale.run_scale over n = 1e3, 1e4, 1e5 at the
             reference's defaults, validate_scale == []; each rung's device
             peak memory beside its peak client tensor and the dense bytes;
 22. serve:  the model zoo's serving path, qwen3-4b at full width (36
             layers, d_model 2560, bf16) from seeded random weights: 8
             requests of 4096-token prompts (make_batch), 64 greedy tokens
             each (max_seq 4160, window 0) through
             repro_torch.launch.serve.serve; 36 x 63 gqa_decode launches,
             none in prefill; prefill ms, warm decode ms per step against
             its byte bound, tokens/s; then torch.profiler over 4 warm
             decode steps after a second prefill: device busy and idle
             share of a step, the top kernels, and gqa_decode's share;
 23. serve_check: full width at 4 layers, float32: the last decode step's
             logits against the last-position logits of a prefill over
             prompt + generated tokens, at window 0 and at window 1024 over
             a 4096-token prompt (a rolling cache);
 24. serve_cpu: the qwen3-4b smoke variant served on the card and on the
             CPU (plain versions): identical tokens, logits within tolerance;
 25. kernel: each kernel against its plain PyTorch version on the card, at
             the main path's shapes (its own inputs; gqa_decode at the
             serving shape) and at edge shapes one below, at and one above a
             tile multiple; times with CUDA events.  linreg_grad_masked at
             the coded round's live rows (consts["live_rows"]) is held
             against its plain version over every row, and timed there,
             over every row and at the naive round's tensor, each beside
             library calls over the same rows and its bound; kernels 2, 3
             and 5 add `hier` variants at the tier's shapes (hier's shard 0,
             the shards of hier_scale's example and of run_scale), each held
             against its plain version, rerun, and timed beside its library
             call and its bound; parity_encode_batched is timed at the feature shape and at the
             label shape (q = c = 10), each with its bound (the feature
             product in 3xTF32 on the tensor cores); rff_linreg_grad_masked
             at the round's live rows is held against its plain version over
             every row, in f32 and bf16, with and without the parity row,
             with every row live, and with NaN inputs; each variant is timed
             (also with x and Omega cut to 16 features, which leaves the
             cost outside the embedding) beside a library chain over the
             same rows and its own bound (the embedding at the peak of the
             units that run it: TF32 tensor cores, three products each,
             for 3xTF32 in f32; bf16 tensor cores in bf16; the
             contractions at the FFMA peak).  linreg_grad is timed at the
             parity set and at one legacy client, each with its library
             time and its device time (torch.profiler).  rff_embed is
             checked at edges around its 128 x 128 tile and 16-step K stage
             (and x off a 16-byte boundary), with a NaN feature and a rerun,
             and timed by events and on the device beside addmm + cos, its
             bound the product in 3xTF32 on the tensor cores.  gqa_decode is
             checked at its 32-slot tile and split edges (gqa_plan on this
             card), G = 1..16, hd_v != hd, head dims off the score mma and
             off the 16-byte copies, NaN in masked slots, and reruns; timed
             by events, on the device (device_ms, library_device_ms) and on
             the host (host_ms: the wrapper's enqueue), beside SDPA with its
             mask made once outside the timed calls;
 26. the kernels table, then the final line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Each path phase sets every launch count to 0 just before it drives its
path and reads the counts just after; each kernel's `launches` in the
table is the sum over the path phases.

Any failure raises and the script exits non-zero without the final line.
It exits 2 at once where there is no CUDA device or no src/repro_torch.
"""
import contextlib
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
RESUME_EVERY = 5          # the resume phase's checkpoint_every
MULTI_R = 8               # the multi phase's realizations
ALLOC_CLIENTS = 100       # where auto picks the vectorized allocator
CHANNEL = "drift_churn"   # the channel phase's profile
CHANNEL_MULTI_R = 4       # its run_multi realizations
HOST_COST_PAIRS = 6       # stationary/channel warm runs timed in turns
ADAPT_PROFILE = "degrade_drift"   # the adaptive phase's profile
ADAPT_EVERY = 5
FAULTS_CODED = "chaos"            # NaN/inf mix, stale replay, bad parity
FAULTS_NAIVE = "flaky_clients"    # NaN uploads
SWEEP_PROFILES = ("uniform", "paper", "extreme")
SWEEP_R = 4                       # the sweep's realizations
# the resume phase's checkpoints, under the git-ignored build/
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
FAULT_CKPT_DIR = CKPT_DIR.parent / "chip_smoke_fault_ckpt"
OBS_DIR = CKPT_DIR.parent / "chip_smoke_obs"          # telemetry's run dirs
SERVICE_DIR = CKPT_DIR.parent / "chip_smoke_service"  # the services' roots
OBS_EVERY = 5             # checkpoint_every of the telemetry and service jobs
TELEMETRY_PAIRS = 3       # spans-off / spans-on warm runs timed in turns
REPORT_LINES = 14         # first lines of render_report printed
SERVICE_DROP_AFTER = 3    # service steps before the drop
# the hierarchical tier at MNIST-RFF width: edge aggregators, the sampled
# fraction, rounds a block; its run directories under the git-ignored build/
HIER_SHARDS = 3
HIER_F = 0.5
HIER_EVERY = 5
HIER_DIR = CKPT_DIR.parent / "chip_smoke_hier"
# launch.scale.run_scale's rungs: the reference's REQUIRED_NS, uncut
SCALE_NS = (1_000, 10_000, 100_000)
PEAK_FLOPS = 67e12        # H100 SXM float32, outside the tensor cores
PEAK_BF16 = 989e12        # H100 SXM bf16 tensor cores, dense
PEAK_TF32 = 495e12        # H100 SXM TF32 tensor cores, dense
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
# |kernel - plain| <= REL_TOL * max(1, max|plain|): float32 sums of up to
# K = 2400 terms taken in another order than the plain version's (cuBLAS,
# TF32 off); the expected error is ~sqrt(K) ulp of the output's scale
REL_TOL = 1e-5
# theta after CPU_ROUNDS rounds, card vs CPU: the same float32 differences,
# carried through the parity set and three SGD updates; the same tolerance
# holds theta after ROUNDS rounds of one path against another on the card
THETA_REL_TOL = 1e-4
# the fused kernel against its plain version: the cosine's argument
# x.omega + delta (d = 784 terms, several units large) is summed in another
# order than cuBLAS's, and its float32 rounding (~1e-6 of phi's scale) is
# carried through both contractions (q = 2000 terms, then L = 2400)
FUSED_REL_TOL = 1e-4
# the legacy oracle's wall clock sums float64 round times on the host, the
# batched engine's float32 ones
WALL_REL_TOL = 1e-6

TPU_KERNELS = [
    ("rff_embed", "src/repro/kernels/rff_embed.py:39",
     "src/repro_torch/kernels/csrc/rff_embed.cu"),
    ("parity_encode_batched", "src/repro/kernels/parity_encode.py:75",
     "src/repro_torch/kernels/csrc/parity_encode.cu"),
    ("linreg_grad_masked", "src/repro/kernels/linreg_grad.py:128",
     "src/repro_torch/kernels/csrc/linreg_grad.cu"),
    ("rff_linreg_grad_masked", "src/repro/kernels/rff_linreg_grad.py:110",
     "src/repro_torch/kernels/csrc/rff_linreg_grad.cu"),
    ("linreg_grad", "src/repro/kernels/linreg_grad.py:83",
     "src/repro_torch/kernels/csrc/linreg_grad.cu"),
    ("parity_encode", "src/repro/kernels/parity_encode.py:39",
     "src/repro_torch/kernels/csrc/parity_encode.cu"),
    ("gqa_decode", "src/repro/kernels/gqa_decode.py:67",
     "src/repro_torch/kernels/csrc/gqa_decode.cu"),
]
# the kernels of the main phase (the first slice's path)
MAIN_KERNELS = ("rff_embed", "parity_encode_batched", "linreg_grad_masked")
NOT_YET_PORTED = []

# the serving phase: qwen3-4b (src/repro/configs/qwen3_4b.py), full width
SERVE_ARCH = "qwen3-4b"
SERVE = dict(batch=8, prompt_len=4096, gen_len=64, window=0, seed=0)
CHECK_LAYERS = 4               # serve_check's depth cut
PROFILE_STEPS = 4              # decode steps under torch.profiler
CHECK_GEN = 8
CHECK_WINDOW = 1024
SMOKE_SERVE = dict(batch=4, prompt_len=64, gen_len=16, seed=0)
# logits of the kernel decode path against a prefill over the same tokens
# (float32, 4 layers of width 2560 and a 151936-wide head): the repository's
# own decode-vs-prefill tolerance, tests/test_models_smoke.py:87
CHECK_ATOL, CHECK_RTOL = 2e-3, 1e-2
# the smoke variant on the card against the CPU: float32 sums of <= 512
# terms in another order through 2 layers
SMOKE_LOGIT_ATOL = 1e-4
# gqa_decode in bfloat16: kernel and plain version round the same float32
# result to bf16, at most one ulp (2^-8 relative) apart
BF16_REL_TOL = 2 ** -7


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


def host_ms(torch, fn, reps: int) -> float:
    """Mean host ms per call over `reps` calls after one warm-up: the time
    the host takes to enqueue a call, the synchronize left out."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def bound(nbytes: float, flops: float, bf16_flops: float = 0.0,
          tf32x3_flops: float = 0.0) -> tuple[float, str]:
    """The least time (ms): bytes over the HBM rate against the operations
    over the peak of the units that run them: float32 FFMA, bf16 tensor
    cores, and 3xTF32 (three TF32 products for each float32 one)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (flops / PEAK_FLOPS + bf16_flops / PEAK_BF16
             + 3 * tf32x3_flops / PEAK_TF32) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_kernels_ms(torch, fn, reps: int, tries: int = 3) -> dict:
    """{device op name: ms per call} (kernels, copies, fills), from
    torch.profiler over `reps` calls after one warm-up.  The profiler can
    drop device events of a window (seen on the card as an empty or a
    short table), so the window is profiled `tries` times and the one with
    the most device time is kept: a dropped event only lowers the sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        got = {evt.key: evt.device_time_total / 1e3 / reps
               for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA}
        if sum(got.values()) > sum(best.values()):
            best = got
    return best


def device_ms(torch, fn, reps: int) -> float:
    """ms of device time per call (kernels, copies, fills), from
    torch.profiler over `reps` calls after one warm-up: the time the card
    spends, without the host's gaps between calls."""
    total = sum(device_kernels_ms(torch, fn, reps).values())
    check(total > 0, "the profiler saw no device time")
    return total


def max_err(torch, got, want, rel_tol=REL_TOL) -> tuple[float, float]:
    err = float((got - want).abs().max())
    tol = rel_tol * max(1.0, float(want.abs().max()))
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
    for name in MAIN_KERNELS:
        check(main_launches[name] > 0,
              f"{name} was not launched on the main path")
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
                g_stack=g_stack, results=results, ds=ds, nodes=nodes,
                launches=main_launches, warm=warm)


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


def add_launches(state, counts: dict) -> None:
    """Add one path phase's launch counts to the running totals."""
    for name, count in counts.items():
        state["launches"][name] += count


def same_rounds(torch, res, want, name: str, wall_rel_tol=0.0) -> float:
    """Check that `res` saw the rounds of `want` (returned counts; wall
    clock identical, or within `wall_rel_tol`) and that theta agrees
    within THETA_REL_TOL; returns max |delta theta|."""
    check([h.returned for h in res.history]
          == [h.returned for h in want.history],
          f"{name}: returned counts differ from the reference run")
    wall = np.array([h.wall_clock for h in res.history])
    wall_ref = np.array([h.wall_clock for h in want.history])
    if wall_rel_tol == 0.0:
        check(np.array_equal(wall, wall_ref),
              f"{name}: wall clock differs from the reference run")
    else:
        check(np.allclose(wall, wall_ref, rtol=wall_rel_tol, atol=0.0),
              f"{name}: wall clock beyond rtol {wall_rel_tol}")
    th, th_ref = res.theta.float(), want.theta.float()
    err = float((th - th_ref).abs().max())
    tol = THETA_REL_TOL * max(1.0, float(th_ref.abs().max()))
    check(math.isfinite(err) and err <= tol,
          f"{name}: theta differs by {err} > {tol}")
    return err


def warm_ms(torch, exp) -> float:
    """ms per round of a second, warm run of the deployment (no eval)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp.run(ROUNDS)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ROUNDS * 1e3


def fused_embed_path(torch, dev, state) -> None:
    """Path A: fused_embed=True on the raw shards, one
    rff_linreg_grad_masked launch a round."""
    from repro_torch.api import build_experiment
    from repro_torch.data import sharding
    from repro_torch.kernels import ops

    ds, n = state["ds"], state["xs"].shape[0]
    # the main path's partition of the raw features (it sorts by label)
    shards = sharding.sort_and_shard(ds.x_train, ds.y_train, n)
    per_client = sharding.assign_shards_by_speed(
        shards, state["nodes"], minibatch=ds.x_train.shape[0] // n)
    xs_raw = np.stack([c[0] for c in per_client])
    base = dataclasses.replace(state["spec"], fused_embed=True)
    runs = {}
    for scheme in ("coded", "naive", "greedy"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        exp = build_experiment(dataclasses.replace(base, scheme=scheme),
                               xs_raw, state["ys"], device=dev,
                               rff_draw=(state["omega"], state["delta"]))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = exp.run(ROUNDS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        add_launches(state, launches)
        emit({"phase": "fused_embed", "scheme": scheme, "rounds": ROUNDS,
              "x_raw": list(exp.x.shape), "setup_s": setup_s,
              "ms_per_round": run_s / ROUNDS * 1e3, "launches": launches,
              "wall_clock": res.history[-1].wall_clock,
              "privacy_eps": res.privacy_eps})
        check(launches["rff_linreg_grad_masked"] == ROUNDS,
              f"fused {scheme}: rff_linreg_grad_masked launched "
              f"{launches['rff_linreg_grad_masked']} times in {ROUNDS} "
              "rounds")
        check(launches["linreg_grad_masked"] == 0,
              f"fused {scheme}: linreg_grad_masked launched")
        check(launches["parity_encode_batched"]
              == (2 if scheme == "coded" else 0),
              f"fused {scheme}: parity_encode_batched launched "
              f"{launches['parity_encode_batched']} times")
        check(bool(torch.isfinite(res.theta).all()),
              f"fused {scheme}: theta is not finite")
        runs[scheme] = (exp, res)

    exp, res = runs["coded"]
    control_exp, control = state["coded"]
    # the two-pass control is the main path's coded deployment: the same
    # raw shards embedded with the same (omega, delta), as these bits show
    same_phi = torch.equal(exp.embedded_x(), control_exp.x)
    check(same_phi, "the fused deployment's embedded shards differ from "
          "the main path's")
    check(res.privacy_eps == control.privacy_eps,
          "fused coded: privacy epsilon differs from the two-pass control")
    err = same_rounds(torch, res, control, "fused coded vs two-pass")
    # the round allocates its (rows, q, c) gradients and the partial
    # gradients of its groups of slabs, never a (rows, L, q) embedded tensor
    consts = exp.build_consts()
    rows, L = consts["gmask"].shape
    consts_live = consts["live_rows"]
    phi_bytes = rows * L * exp.q * 4
    del consts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ms = warm_ms(torch, exp)
    peak = torch.cuda.max_memory_allocated() - before
    emit({"phase": "fused_embed", "scheme": "coded", "control": "main path "
          "coded (same embedded bits)", "embedded_identical": same_phi,
          "live_rows": list(consts_live), "L": L,
          "theta_max_abs_err": err, "warm_ms_per_round": ms,
          "warm_peak_extra_bytes": peak, "embedded_tensor_bytes": phi_bytes,
          "warm_ms_per_round_naive": warm_ms(torch, runs["naive"][0]),
          "warm_ms_per_round_greedy": warm_ms(torch, runs["greedy"][0])})
    check(peak < phi_bytes / 10, f"fused coded round allocated {peak} bytes "
          f"beyond its consts; one (rows, L, q) tensor is {phi_bytes}")
    state["fused"] = (exp, res)
    state["xs_raw"] = xs_raw


def unfused_path(torch, dev, state) -> None:
    """Path B: fused_coded=False, the coded gradient a separate
    linreg_grad launch a round."""
    from repro_torch.api import build_experiment
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    exp = build_experiment(dataclasses.replace(state["spec"],
                                               fused_coded=False),
                           state["xs"], state["ys"], device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = exp.run(ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    err = same_rounds(torch, res, state["coded"][1], "unfused coded")
    emit({"phase": "unfused", "scheme": "coded", "rounds": ROUNDS,
          "setup_s": setup_s, "ms_per_round": run_s / ROUNDS * 1e3,
          "warm_ms_per_round": warm_ms(torch, exp), "launches": launches,
          "theta_max_abs_err": err,
          "n_masked": sum(h.n_masked for h in res.history)})
    for name in ("linreg_grad_masked", "linreg_grad"):
        check(launches[name] == ROUNDS, f"unfused: {name} launched "
              f"{launches[name]} times in {ROUNDS} rounds")
    check(launches["parity_encode_batched"] == 2,
          "unfused: parity_encode_batched not launched twice")


def legacy_path(torch, dev, state) -> None:
    """Path C: engine="legacy", the per-client oracle, against the main
    path's batched runs of the same rounds."""
    import copy

    from repro_torch.api import build_experiment
    from repro_torch.core.delay_model import sample_round_times
    from repro_torch.kernels import ops

    for scheme in ("coded", "naive", "greedy"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        exp = build_experiment(
            dataclasses.replace(state["spec"], scheme=scheme,
                                engine="legacy"),
            state["xs"], state["ys"], device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        # the delays the run will draw, redrawn from a copy of its generator
        times = sample_round_times(exp.nodes, np.asarray(exp.loads, float),
                                   copy.deepcopy(exp.rng), ROUNDS)
        t0 = time.perf_counter()
        res = exp.run(ROUNDS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        add_launches(state, launches)
        err = same_rounds(torch, res, state["results"][scheme][1],
                          f"legacy {scheme}", wall_rel_tol=WALL_REL_TOL)
        if scheme == "coded":
            loaded = int(((times <= exp.t_star)
                          & (exp.loads > 0)[None, :]).sum())
            want = {"linreg_grad": loaded + ROUNDS, "linreg_grad_masked": 0}
        else:
            want = {"linreg_grad": 0, "linreg_grad_masked": ROUNDS}
        emit({"phase": "legacy", "scheme": scheme, "rounds": ROUNDS,
              "setup_s": setup_s, "ms_per_round": run_s / ROUNDS * 1e3,
              "launches": launches, "expected": want,
              "theta_max_abs_err": err})
        for name, count in want.items():
            check(launches[name] == count, f"legacy {scheme}: {name} "
                  f"launched {launches[name]} times, expected {count}")


def encode_local_path(torch, dev, state) -> None:
    """encoding.encode_local client by client with the main path's
    generators, then aggregate_parity, against the batched encode."""
    from repro_torch.core import encoding
    from repro_torch.kernels import ops

    exp = state["coded"][0]
    g = state["g_stack"]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    parity = encoding.aggregate_parity([
        encoding.encode_local(g[j], exp.x[j], exp.y[j], exp.w_stack[j])
        for j in range(exp.n)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    # an output's sum order depends on its row, column and inputs, never on
    # n: each client's parity set is the same bits from either entry point,
    # and both aggregations sum the same (n, u, .) stack
    same_x = bool(torch.equal(parity.x, exp.parity.x))
    same_y = bool(torch.equal(parity.y, exp.parity.y))
    emit({"phase": "encode_local", "clients": exp.n, "launches": launches,
          "seconds": seconds, "x_identical": same_x, "y_identical": same_y,
          "max_abs_err_x": float((parity.x - exp.parity.x).abs().max()),
          "max_abs_err_y": float((parity.y - exp.parity.y).abs().max())})
    check(launches["parity_encode"] == 2 * exp.n,
          f"encode_local: parity_encode launched {launches['parity_encode']}"
          f" times for {exp.n} clients")
    check(same_x and same_y, "encode_local: the per-client encode differs "
          "from the batched encode")


def resume_path(torch, dev, state) -> None:
    """The main path's coded deployment with checkpoint_every =
    RESUME_EVERY: killed after one block, resumed in a fresh experiment,
    against the uninterrupted blocked run."""
    import shutil

    from repro_torch.api import build_experiment
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.kernels import ops

    spec = dataclasses.replace(state["spec"], checkpoint_every=RESUME_EVERY)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    exp = build_experiment(spec, state["xs"], state["ys"], device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # one block, then a checkpoint: run_block reads the stream position
    # from the state, so the experiment's own generator is untouched and
    # run() below starts the uninterrupted run from the same position
    first = exp.run_block(exp.init_state(ROUNDS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = exp.save_state(
        str(CKPT_DIR / f"{ckpt_io.CKPT_PREFIX}{first.rounds_done:06d}.npz"),
        first)
    save_ms = (time.perf_counter() - t0) * 1e3
    killed = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    control = exp.run(ROUNDS)
    torch.cuda.synchronize()
    blocked_ms = (time.perf_counter() - t0) / ROUNDS * 1e3
    control_launches = {k: ops.LAUNCHES[k] - killed[k] for k in killed}
    del exp, first                                       # the kill
    t0 = time.perf_counter()
    fresh = build_experiment(spec, state["xs"], state["ys"], device=dev)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored = fresh.restore_state(path)        # digest verified
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    arrays, meta = ckpt_io.restore_state(path, verify=True)
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    resumed = fresh.run(ROUNDS, checkpoint_dir=str(CKPT_DIR), resume=True)
    torch.cuda.synchronize()
    resumed_ms = (time.perf_counter() - t0) / (ROUNDS - RESUME_EVERY) * 1e3
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    rounds_launched = (killed["linreg_grad_masked"]
                       + launches["linreg_grad_masked"]
                       - before["linreg_grad_masked"])
    same_theta = bool(torch.equal(resumed.theta, control.theta))
    same_wall = ([h.wall_clock for h in resumed.history]
                 == [h.wall_clock for h in control.history])
    same_ret = ([h.returned for h in resumed.history]
                == [h.returned for h in control.history])
    ckpts = sorted(p.name for p in CKPT_DIR.iterdir())
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    emit({"phase": "resume", "rounds": ROUNDS,
          "checkpoint_every": RESUME_EVERY, "killed_at": restored.rounds_done,
          "checkpoints": ckpts, "digest_verified": True,
          "checkpoint_bytes": sum(a.nbytes for a in arrays.values()),
          "theta_identical": same_theta, "wall_clock_identical": same_wall,
          "returned_identical": same_ret, "setup_s": setup_s,
          "rebuild_s": rebuild_s, "save_ms": save_ms,
          "restore_ms": restore_ms, "blocked_ms_per_round": blocked_ms,
          "resumed_ms_per_round": resumed_ms,
          "linreg_grad_masked_killed_and_resumed": rounds_launched,
          "control_launches": control_launches, "launches": launches,
          "format": meta["format"]})
    check(restored.rounds_done == RESUME_EVERY,
          f"resume: restored {restored.rounds_done} rounds")
    check(same_theta and same_wall and same_ret,
          "resume: the resumed run differs from the uninterrupted one")
    check(rounds_launched == ROUNDS,
          f"resume: linreg_grad_masked launched {rounds_launched} times over "
          f"the killed and the resumed run of {ROUNDS} rounds")
    check(control_launches["linreg_grad_masked"] == ROUNDS,
          "resume: the uninterrupted run launched linreg_grad_masked "
          f"{control_launches['linreg_grad_masked']} times")
    check(len(ckpts) == ROUNDS // RESUME_EVERY,
          f"resume: checkpoints {ckpts}")


def _replay_multi(exp, rng_state, rounds: int, R: int):
    """(wall clock (R, rounds), returned (R, rounds)) of run_multi,
    replayed on the host from the same draw: R * rounds delay rows, float32
    deadlines, as the round step takes them."""
    from repro_torch.core.delay_model import sample_round_times

    rng = np.random.default_rng()
    rng.bit_generator.state = rng_state
    times = sample_round_times(exp.nodes, np.asarray(exp.loads, float),
                               rng, R * rounds).astype(np.float32)
    times = times.reshape(R, rounds, exp.n)
    if exp.step_kind == "coded":
        t_round = np.full((R, rounds), np.float32(exp.t_star))
        returned = (times <= np.float32(exp.t_star)).sum(-1)
    else:                                           # naive
        t_round = times.max(-1)
        returned = np.full((R, rounds), exp.n)
    wall = exp.setup_time + np.cumsum(t_round.astype(np.float64), axis=1)
    return wall, returned


def multi_path(torch, dev, state) -> None:
    """run_multi(ROUNDS, MULTI_R) on the main path's coded and naive
    deployments, against the draw replayed on the host, and
    run_multi(ROUNDS, 1) against run(ROUNDS) from the same position."""
    from repro_torch.kernels import ops

    for scheme in ("coded", "naive"):
        exp = state["results"][scheme][0]
        ops.reset_launch_counts()
        start = exp.rng.bit_generator.state
        t0 = time.perf_counter()
        res = exp.run_multi(ROUNDS, MULTI_R)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        wall, returned = _replay_multi(exp, start, ROUNDS, MULTI_R)
        same_wall = bool(np.array_equal(res.wall_clock, wall))
        same_ret = bool(np.array_equal(res.returned, returned))
        # warm: a second run_multi of the same deployment
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.run_multi(ROUNDS, MULTI_R)
        torch.cuda.synchronize()
        warm = (time.perf_counter() - t0) / (ROUNDS * MULTI_R) * 1e3
        # R = 1 from a known position against run() from the same one
        pos = exp.rng.bit_generator.state
        one = exp.run(ROUNDS)
        exp.rng.bit_generator.state = pos
        multi_one = exp.run_multi(ROUNDS, 1)
        same_one = (bool(torch.equal(multi_one.theta[0], one.theta))
                    and multi_one.wall_clock[0].tolist()
                    == [h.wall_clock for h in one.history])
        all_launches = dict(ops.LAUNCHES)
        add_launches(state, all_launches)
        mean, std = res.wall_clock_bands()
        finite = bool(torch.isfinite(res.theta).all())
        emit({"phase": "multi", "scheme": scheme, "rounds": ROUNDS,
              "realizations": MULTI_R, "wall_clock_shape":
              list(res.wall_clock.shape), "wall_clock_replayed": same_wall,
              "returned_replayed": same_ret, "one_realization_is_run":
              same_one, "final_mean": float(mean[-1]),
              "final_std": float(std[-1]), "first_s": first_s,
              "warm_ms_per_realization_round": warm,
              "launches": launches, "phase_launches": all_launches,
              "theta_finite": finite})
        check(same_wall and same_ret, f"multi {scheme}: wall clock or "
              "returned counts differ from the host replay")
        check(same_one, f"multi {scheme}: run_multi(ROUNDS, 1) differs "
              "from run(ROUNDS)")
        check(finite, f"multi {scheme}: theta is not finite")
        check(launches["linreg_grad_masked"] == ROUNDS * MULTI_R,
              f"multi {scheme}: linreg_grad_masked launched "
              f"{launches['linreg_grad_masked']} times, expected "
              f"{ROUNDS * MULTI_R}")


def alloc_path(torch, dev, state) -> None:
    """MNIST-RFF at ALLOC_CLIENTS clients: the vectorized allocator on the
    card against the scalar one on the host, then a coded deployment whose
    auto backend picks it."""
    from repro_torch.api import build_experiment
    from repro_torch.config import FLConfig
    from repro_torch.core import load_allocation as la
    from repro_torch.core import rff
    from repro_torch.core.delay_model import mec_network
    from repro_torch.data import sharding
    from repro_torch.kernels import ops

    ds, n = state["ds"], ALLOC_CLIENTS
    ops.reset_launch_counts()
    xh = rff.rff_transform(state["x_tr"], state["omega"],
                           state["delta"]).cpu().numpy()
    fl = dataclasses.replace(state["spec"].fl, n_clients=n)
    q, c = xh.shape[1], ds.n_classes
    nodes = mec_network(fl, d_scalars_per_point=q * c)
    shards = sharding.sort_and_shard(xh, ds.y_train, n)
    per_client = sharding.assign_shards_by_speed(
        shards, nodes, minibatch=xh.shape[0] // n)
    xs = np.stack([cl[0] for cl in per_client])
    ys = np.stack([ds.one_hot(cl[1]) for cl in per_client])
    spec = dataclasses.replace(state["spec"], fl=fl)
    state["alloc"] = (spec, xs, ys)
    t0 = time.perf_counter()
    exp = build_experiment(spec, xs, ys, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    backend = exp._pick_alloc_backend()
    l, caps = exp.l, [float(exp.l)] * n
    args = (exp.nodes, caps, None, float(exp.u), float(exp.m))
    times = []
    for _ in range(2):          # the first call pays the lazy CUDA modules
        t0 = time.perf_counter()
        vec = la.two_step_allocate_vectorized(*args, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    sca = la.two_step_allocate(*args)
    scalar_s = time.perf_counter() - t0
    t_err = abs(vec.t_star - sca.t_star) / (1.0 + sca.t_star)
    load_err = float(np.max(np.abs(vec.loads - sca.loads)))
    lv, _ = la.vectorized_optimal_loads(exp.nodes, vec.t_star, caps,
                                        device=dev)
    node_err = max(abs(lv[j] - la.optimal_load(nd, vec.t_star, l)[0])
                   for j, nd in enumerate(exp.nodes)) / (1.0 + l)
    floored = np.minimum(np.floor(sca.loads).astype(int), l)
    before = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    res = exp.run(ROUNDS)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) / ROUNDS * 1e3
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    run_launches = {k: launches[k] - before[k] for k in launches}
    finite = bool(torch.isfinite(res.theta).all())
    emit({"phase": "alloc", "clients": n, "l": l, "u": exp.u,
          "backend": backend, "grid_width": la.vectorized_grid_width(
              exp.nodes), "vectorized_s": times, "scalar_s": scalar_s,
          "t_star_vectorized": vec.t_star, "t_star_scalar": sca.t_star,
          "t_star_rel_err": t_err, "loads_max_abs_err": load_err,
          "node_for_node_err": node_err,
          "floored_loads_differ": int((exp.loads != floored).sum()),
          "experiment_t_star": exp.t_star, "setup_s": setup_s,
          "alloc_s": times[-1], "ms_per_round": run_ms,
          "returned": [h.returned for h in res.history],
          "wall_clock": res.history[-1].wall_clock,
          "launches": launches, "theta_finite": finite})
    check(backend == "vectorized", f"alloc: auto picked {backend!r}")
    check(t_err <= 2e-6, f"alloc: t* {vec.t_star} vs {sca.t_star}")
    check(load_err <= 1e-4 * (1.0 + l), f"alloc: loads differ by {load_err}")
    check(node_err <= 1e-6, f"alloc: node-for-node error {node_err}")
    check(abs(exp.t_star - sca.t_star) <= 2e-6 * (1.0 + sca.t_star),
          f"alloc: the experiment's t* {exp.t_star}")
    check(finite, "alloc: theta is not finite")
    check(run_launches["linreg_grad_masked"] == ROUNDS,
          f"alloc: linreg_grad_masked launched "
          f"{run_launches['linreg_grad_masked']} times in {ROUNDS} rounds")
    check(launches["parity_encode_batched"] == 2,
          "alloc: parity_encode_batched not launched twice")
    del exp, res
    _release(torch)


def quickstart_path(torch, dev, state) -> None:
    """repro_torch.launch.quickstart.main() on the card."""
    from repro_torch.kernels import ops
    from repro_torch.launch import quickstart

    ops.reset_launch_counts()
    lines = []
    t0 = time.perf_counter()
    rounds, R = 100, 8                     # the reference script's
    out = quickstart.main(rounds, R, device=dev, out=lines.append)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    bands = {k: [float(v[0][-1]), float(v[1][-1])]
             for k, v in out["bands"].items()}
    finite = all(np.isfinite(v[0]).all() and np.isfinite(v[1]).all()
                 for v in out["bands"].values())
    table = {k: {"accuracy": v["accuracy"], "wall_clock": v["wall_clock"],
                 "t_star": v["t_star"], "privacy_eps": v["privacy_eps"]}
             for k, v in out["table"].items()}
    # 5 schemes, the control, the killed block and the resumed rest, and
    # run_multi over R realizations for naive and coded
    want = 5 * rounds + 2 * rounds + 2 * R * rounds
    emit({"phase": "quickstart", "seconds": seconds, "table": table,
          "resume_identical": out["resume_identical"],
          "killed_at": out["killed_at"], "bands_final": bands,
          "launches": launches, "expected_linreg_grad_masked": want})
    check(out["resume_identical"], "quickstart: resume not bit-identical")
    check(finite, "quickstart: bands not finite")
    check(launches["linreg_grad_masked"] == want,
          f"quickstart: linreg_grad_masked launched "
          f"{launches['linreg_grad_masked']} times, expected {want}")
    check(all(math.isfinite(v["accuracy"]) and v["accuracy"] > 0.5
              for v in table.values()), "quickstart: accuracy")


def _replay_channel(exp, rng, trace_call: int, rounds: int):
    """(wall clock (rounds,), returned (rounds,)) of a traced run of
    `exp` (naive, greedy, coded or ideal), replayed on the host: the trace
    of stream `trace_call`, the traced delays drawn from `rng` (advanced),
    float32 deadlines as the round step takes them."""
    from repro_torch.net.trace import (TraceState, generate_trace_block,
                                       sample_round_times_traced)

    trace, _ = generate_trace_block(
        exp.nodes, exp.channel, rounds,
        TraceState.init(exp.n, exp._trace_rng(trace_call)))
    times = sample_round_times_traced(
        exp.nodes, np.asarray(exp.loads, float), rng, trace).astype(
            np.float32)
    active = trace.active
    zero = np.float32(0.0)
    if exp.step_kind == "coded":
        t_round = np.full(rounds, np.float32(exp.t_star))
        returned = ((times <= t_round[:, None]) & active).sum(1)
    elif exp.step_kind == "naive":
        t_round = np.where(active, times, zero).max(1)
        returned = active.sum(1)
    elif exp.step_kind == "greedy":
        srt = np.sort(np.where(active, times, np.float32(np.inf)), axis=1)
        n_act = active.sum(1)
        k = np.clip(np.minimum(exp.n_wait, n_act), 1, exp.n)
        t_round = np.where(n_act > 0, srt[np.arange(rounds), k - 1], zero)
        returned = ((times <= t_round[:, None]) & active).sum(1)
    else:                                                   # ideal
        t_round = np.full(rounds, np.float32(exp.t_ideal))
        returned = active.sum(1)
    wall = exp.setup_time + np.cumsum(t_round.astype(np.float64))
    return wall, returned


def _host_rng(exp):
    rng = np.random.default_rng()
    rng.bit_generator.state = exp.rng.bit_generator.state
    return rng


def channel_path(torch, dev, state) -> None:
    """The main path's deployments under the CHANNEL profile: static
    against the main path's runs, coded/naive/greedy/ideal against the
    host replay of the trace, coded card against CPU, fused_embed and
    fused_coded=False under the channel, and run_multi."""
    from repro_torch.api import build_experiment
    from repro_torch.kernels import ops

    base = state["spec"]
    # 1. the static profile is the main path's run, bit for bit
    static = {}
    for scheme in ("coded", "naive", "greedy"):
        ops.reset_launch_counts()
        exp = build_experiment(
            dataclasses.replace(base, scheme=scheme,
                                channel_profile="static"),
            state["xs"], state["ys"], device=dev)
        res = exp.run(ROUNDS)
        launches = dict(ops.LAUNCHES)
        add_launches(state, launches)
        want = state["results"][scheme][1]
        same = (bool(torch.equal(res.theta, want.theta))
                and [h.wall_clock for h in res.history]
                == [h.wall_clock for h in want.history]
                and [h.returned for h in res.history]
                == [h.returned for h in want.history])
        static[scheme] = same
        check(same, f"channel static {scheme}: differs from the main "
              "path's run")
        check(launches["linreg_grad_masked"] == ROUNDS,
              f"channel static {scheme}: linreg_grad_masked launched "
              f"{launches['linreg_grad_masked']} times")
    emit({"phase": "channel", "profile": "static",
          "identical_to_main_path": static})

    # 2. the four schemes under the channel, against the host replay
    spec = dataclasses.replace(base, channel_profile=CHANNEL)
    runs = {}
    for scheme in ("coded", "naive", "greedy", "ideal"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        exp = build_experiment(dataclasses.replace(spec, scheme=scheme),
                               state["xs"], state["ys"], device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        wall, returned = _replay_channel(exp, _host_rng(exp),
                                         exp._trace_calls, ROUNDS)
        t0 = time.perf_counter()
        res = exp.run(ROUNDS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        add_launches(state, launches)
        same_wall = (np.array([h.wall_clock for h in res.history]).tolist()
                     == wall.tolist())
        same_ret = [h.returned for h in res.history] == returned.tolist()
        finite = bool(torch.isfinite(res.theta).all())
        emit({"phase": "channel", "profile": CHANNEL, "scheme": scheme,
              "rounds": ROUNDS, "setup_s": setup_s,
              "ms_per_round": run_s / ROUNDS * 1e3,
              "warm_ms_per_round": warm_ms(torch, exp),
              "stationary_warm_ms_per_round":
                  state["warm"].get(scheme),
              "returned": [h.returned for h in res.history],
              "wall_clock": res.history[-1].wall_clock,
              "wall_clock_replayed": same_wall,
              "returned_replayed": same_ret, "launches": launches,
              "theta_finite": finite})
        check(same_wall and same_ret, f"channel {scheme}: wall clock or "
              "returned counts differ from the host replay of the trace")
        check(launches["linreg_grad_masked"] == ROUNDS,
              f"channel {scheme}: linreg_grad_masked launched "
              f"{launches['linreg_grad_masked']} times in {ROUNDS} rounds")
        check(finite, f"channel {scheme}: theta is not finite")
        runs[scheme] = (exp, res)

    # the traced round's host cost: warm runs of the stationary and the
    # channel deployment in turns (stationary, channel, channel,
    # stationary, ...), ms per round
    turns = {}
    for scheme in ("coded", "naive", "greedy"):
        pair = {"stationary": state["results"][scheme][0],
                "channel": runs[scheme][0]}
        ms = {"stationary": [], "channel": []}
        for i in range(HOST_COST_PAIRS):
            order = ("stationary", "channel") if i % 2 == 0 else (
                "channel", "stationary")
            for name in order:
                ms[name].append(warm_ms(torch, pair[name]))
        turns[scheme] = {
            name: {"ms": v, "median": float(np.median(v)),
                   # the card's busy time a round (torch.profiler over two
                   # warm runs): what the host leaves idle is the rest
                   "device_ms_per_round": device_ms(
                       torch, lambda: pair[name].run(ROUNDS), 2) / ROUNDS}
            for name, v in ms.items()}
    emit({"phase": "channel", "profile": CHANNEL,
          "warm_ms_per_round_in_turns": turns})

    # 3. coded, card against CPU
    coded_spec = dataclasses.replace(spec, scheme="coded")
    gpu = build_experiment(coded_spec, state["xs"], state["ys"],
                           device=dev).run(CPU_ROUNDS)
    cpu = build_experiment(coded_spec, state["xs"], state["ys"],
                           device="cpu").run(CPU_ROUNDS)
    th_gpu, th_cpu = gpu.theta.cpu(), cpu.theta
    err = float((th_gpu - th_cpu).abs().max())
    tol = THETA_REL_TOL * max(1.0, float(th_cpu.abs().max()))
    same = ([h.wall_clock for h in gpu.history]
            == [h.wall_clock for h in cpu.history]
            and [h.returned for h in gpu.history]
            == [h.returned for h in cpu.history])
    emit({"phase": "channel", "profile": CHANNEL, "scheme": "coded",
          "cpu_rounds": CPU_ROUNDS, "theta_max_abs_err": err, "tol": tol,
          "wall_clock_and_returned_identical": same})
    check(same, "channel coded: card and CPU runs saw other rounds")
    check(err <= tol, f"channel coded: card theta differs from CPU theta: "
          f"{err} > {tol}")

    # 4. fused_embed and fused_coded=False under the channel, against the
    # channel coded run (same trace, same delays, same loads)
    control = runs["coded"][1]
    for name, over, xs, kernel in (
            ("fused_embed", dict(fused_embed=True), state["xs_raw"],
             "rff_linreg_grad_masked"),
            ("unfused", dict(fused_coded=False), state["xs"],
             "linreg_grad")):
        ops.reset_launch_counts()
        exp = build_experiment(
            dataclasses.replace(coded_spec, **over), xs, state["ys"],
            device=dev, rff_draw=((state["omega"], state["delta"])
                                  if name == "fused_embed" else None))
        t0 = time.perf_counter()
        res = exp.run(ROUNDS)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        add_launches(state, launches)
        err = same_rounds(torch, res, control, f"channel {name}")
        emit({"phase": "channel", "profile": CHANNEL, "scheme": "coded",
              "path": name, "rounds": ROUNDS,
              "ms_per_round": run_s / ROUNDS * 1e3, "launches": launches,
              "theta_max_abs_err": err})
        check(launches[kernel] == ROUNDS, f"channel {name}: {kernel} "
              f"launched {launches[kernel]} times in {ROUNDS} rounds")

    # 5. run_multi under the channel: one trace stream a realization
    for scheme in ("coded", "naive"):
        exp = runs[scheme][0]
        ops.reset_launch_counts()
        rng, base_call = _host_rng(exp), exp._trace_calls
        replay = [_replay_channel(exp, rng, base_call + r, ROUNDS)
                  for r in range(CHANNEL_MULTI_R)]
        t0 = time.perf_counter()
        res = exp.run_multi(ROUNDS, CHANNEL_MULTI_R)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        add_launches(state, launches)
        same_wall = bool(np.array_equal(
            res.wall_clock, np.stack([w for w, _ in replay])))
        same_ret = bool(np.array_equal(
            res.returned, np.stack([r for _, r in replay])))
        finite = bool(torch.isfinite(res.theta).all())
        emit({"phase": "channel", "profile": CHANNEL, "scheme": scheme,
              "run_multi": [ROUNDS, CHANNEL_MULTI_R],
              "wall_clock_replayed": same_wall,
              "returned_replayed": same_ret, "seconds": seconds,
              "ms_per_realization_round":
                  seconds / (ROUNDS * CHANNEL_MULTI_R) * 1e3,
              "final_mean": float(res.wall_clock[:, -1].mean()),
              "launches": launches, "theta_finite": finite})
        check(same_wall and same_ret, f"channel run_multi {scheme}: wall "
              "clock or returned counts differ from the host replay")
        check(finite, f"channel run_multi {scheme}: theta is not finite")
        check(launches["linreg_grad_masked"] == ROUNDS * CHANNEL_MULTI_R,
              f"channel run_multi {scheme}: linreg_grad_masked launched "
              f"{launches['linreg_grad_masked']} times")
    del runs
    _release(torch)


@contextlib.contextmanager
def timed_replans(torch, exp, times: list):
    """Time each re-plan of `exp`'s scheme (seconds, appended to `times`)
    while the block runs."""
    scheme = exp.scheme_obj
    replan = type(scheme).replan

    def timed(exp_, estimator):
        t0 = time.perf_counter()
        out = replan(scheme, exp_, estimator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    scheme.replan = timed
    try:
        yield times
    finally:
        del scheme.replan


def same_schedule(torch, got, want) -> bool:
    """Two AdaptiveSchedules field for field, the masks bit for bit."""
    for f in ("times", "active", "block_idx", "loads_blocks", "t_star",
              "n_wait"):
        g, w = getattr(got, f), getattr(want, f)
        if (g is None) != (w is None) or (
                w is not None and not np.array_equal(g, w)):
            return False
    for eg, ew in zip(got.estimates, want.estimates):
        if eg["rounds_seen"] != ew["rounds_seen"] or not all(
                np.array_equal(eg[k], ew[k])
                for k in ("mu", "tau", "p", "avail")):
            return False
    if (got.gmask_blocks is None) != (want.gmask_blocks is None):
        return False
    return (len(got.estimates) == len(want.estimates)
            and (want.gmask_blocks is None or bool(torch.equal(
                got.gmask_blocks.cpu(), want.gmask_blocks.cpu()))))


def _round_loop_ms(torch, exp, sched, theta_want) -> tuple[float, bool]:
    """ms per round of the adaptive_coded round loop alone, replayed from
    the run's schedule (the plan's host work left out), after one warm
    pass; and whether the replay gives the run's theta bit for bit."""
    lrs = exp._device(exp._lr_schedule(ROUNDS))
    consts = dict(exp._get_consts(), gmask_blocks=sched.gmask_blocks)
    xs = (exp._device(sched.times), lrs, exp._device(sched.active),
          exp._device(sched.t_star), sched.block_idx.tolist())

    def loop():
        theta0 = torch.zeros((exp.q, exp.c), device=exp.device)
        return exp._rounds(theta0, 1.0, xs, consts=consts)[0][0]

    same = bool(torch.equal(loop(), theta_want))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / ROUNDS * 1e3, same


def adaptive_path(torch, dev, state) -> None:
    """adaptive_coded under ADAPT_PROFILE at n = 30 (card against CPU,
    kill/resume), adaptive_greedy under churn, adaptive_coded at n = 100
    on the vectorized solver, and repro_torch.launch.adaptive_drift."""
    import shutil

    from repro_torch.api import build_experiment
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.kernels import ops
    from repro_torch.launch import adaptive_drift

    spec = dataclasses.replace(
        state["spec"], scheme="adaptive_coded", channel_profile=ADAPT_PROFILE,
        adapt_every=ADAPT_EVERY, checkpoint_every=RESUME_EVERY)
    xs, ys = state["xs"], state["ys"]
    # 1. on the card: re-plan times, rounds, the schedule
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    exp = build_experiment(spec, xs, ys, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    replans = []
    t0 = time.perf_counter()
    with timed_replans(torch, exp, replans):
        res = exp.run(ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    sched = exp.last_schedule
    loop_ms, loop_same = _round_loop_ms(torch, exp, sched, res.theta)
    add_launches(state, dict(ops.LAUNCHES))
    finite = bool(torch.isfinite(res.theta).all())
    emit({"phase": "adaptive", "scheme": "adaptive_coded", "clients": exp.n,
          "profile": ADAPT_PROFILE, "adapt_every": ADAPT_EVERY,
          "rounds": ROUNDS, "backend": exp._pick_alloc_backend(),
          "setup_s": setup_s, "replan_s": replans,
          "ms_per_round_without_replans":
              (run_s - sum(replans)) / ROUNDS * 1e3,
          "round_loop_ms_per_round": loop_ms,
          "round_loop_replay_identical": loop_same,
          "stationary_coded_warm_ms_per_round": state["warm"]["coded"],
          "t_star_blocks": [float(t) for t in sched.t_star[::ADAPT_EVERY]],
          "load_blocks": [float(b.sum()) for b in sched.loads_blocks],
          "setup_t_star": exp.t_star,
          "returned": [h.returned for h in res.history],
          "wall_clock": res.history[-1].wall_clock, "launches": launches,
          "theta_finite": finite})
    check(len(replans) == ROUNDS // ADAPT_EVERY - 1,
          f"adaptive: {len(replans)} re-plans in {ROUNDS} rounds")
    check(launches["linreg_grad_masked"] == ROUNDS,
          f"adaptive: linreg_grad_masked launched "
          f"{launches['linreg_grad_masked']} times in {ROUNDS} rounds")
    check(launches["parity_encode_batched"] == 2,
          "adaptive: parity_encode_batched not launched twice")
    check(finite and loop_same, "adaptive: theta not finite, or the round "
          "loop replayed from the schedule gives another theta")

    # 2. the same spec on the CPU: the plan is host NumPy, so the schedule
    # is the same bits; theta within tolerance
    cpu_exp = build_experiment(spec, xs, ys, device="cpu")
    cpu_res = cpu_exp.run(ROUNDS)
    same_sched = same_schedule(torch, sched, cpu_exp.last_schedule)
    err = float((res.theta.cpu() - cpu_res.theta).abs().max())
    tol = THETA_REL_TOL * max(1.0, float(cpu_res.theta.abs().max()))
    same_host = ([h.wall_clock for h in res.history]
                 == [h.wall_clock for h in cpu_res.history]
                 and [h.returned for h in res.history]
                 == [h.returned for h in cpu_res.history])
    emit({"phase": "adaptive", "scheme": "adaptive_coded",
          "cpu_schedule_identical": same_sched,
          "cpu_wall_clock_and_returned_identical": same_host,
          "theta_max_abs_err": err, "tol": tol})
    check(same_sched and same_host, "adaptive: the card's schedule or "
          "rounds differ from the CPU's")
    check(err <= tol, f"adaptive: card theta differs from CPU theta: "
          f"{err} > {tol}")
    del cpu_exp, cpu_res

    # 3. kill after one block, resume in a fresh experiment
    ckpt_dir = CKPT_DIR / "adaptive"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ops.reset_launch_counts()
    interrupted = build_experiment(spec, xs, ys, device=dev)
    first = interrupted.run_block(interrupted.init_state(ROUNDS))
    path = interrupted.save_state(
        str(ckpt_dir / f"{ckpt_io.CKPT_PREFIX}{first.rounds_done:06d}.npz"),
        first)
    del interrupted, first                               # the kill
    fresh = build_experiment(spec, xs, ys, device=dev)
    restored = fresh.restore_state(path)
    resumed = fresh.run(ROUNDS, checkpoint_dir=str(ckpt_dir), resume=True)
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    same = (bool(torch.equal(resumed.theta, res.theta))
            and [h.wall_clock for h in resumed.history]
            == [h.wall_clock for h in res.history]
            and [h.returned for h in resumed.history]
            == [h.returned for h in res.history]
            and same_schedule(torch, fresh.last_schedule, sched))
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    emit({"phase": "adaptive", "scheme": "adaptive_coded",
          "killed_at": restored.rounds_done, "resume_identical": same,
          "launches": launches})
    check(same, "adaptive: the resumed run differs from the uninterrupted "
          "one")
    check(launches["linreg_grad_masked"] == ROUNDS,
          "adaptive: the killed and the resumed run launched "
          f"linreg_grad_masked {launches['linreg_grad_masked']} times")
    del fresh, resumed

    # 4. adaptive_greedy under churn, card against CPU
    g_spec = dataclasses.replace(
        state["spec"], scheme="adaptive_greedy", channel_profile="churn",
        adapt_every=ADAPT_EVERY)
    ops.reset_launch_counts()
    g_exp = build_experiment(g_spec, xs, ys, device=dev)
    t0 = time.perf_counter()
    g_res = g_exp.run(ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    g_cpu = build_experiment(g_spec, xs, ys, device="cpu")
    g_cpu_res = g_cpu.run(ROUNDS)
    same_sched = same_schedule(torch, g_exp.last_schedule,
                               g_cpu.last_schedule)
    err = float((g_res.theta.cpu() - g_cpu_res.theta).abs().max())
    tol = THETA_REL_TOL * max(1.0, float(g_cpu_res.theta.abs().max()))
    emit({"phase": "adaptive", "scheme": "adaptive_greedy",
          "profile": "churn", "rounds": ROUNDS,
          "ms_per_round": run_s / ROUNDS * 1e3,
          "warm_ms_per_round": warm_ms(torch, g_exp),
          "stationary_greedy_warm_ms_per_round": state["warm"]["greedy"],
          "n_wait_blocks": [int(k) for k in
                            g_exp.last_schedule.n_wait[::ADAPT_EVERY]],
          "returned": [h.returned for h in g_res.history],
          "cpu_schedule_identical": same_sched,
          "theta_max_abs_err": err, "tol": tol, "launches": launches})
    check(launches["linreg_grad_masked"] == ROUNDS,
          f"adaptive_greedy: linreg_grad_masked launched "
          f"{launches['linreg_grad_masked']} times in {ROUNDS} rounds")
    check(same_sched, "adaptive_greedy: the card's schedule differs from "
          "the CPU's")
    check(err <= tol, f"adaptive_greedy: card theta differs from CPU "
          f"theta: {err} > {tol}")

    # 5. adaptive_coded at n = 100: auto re-plans on the vectorized solver
    a_spec, a_xs, a_ys = state["alloc"]
    a_spec = dataclasses.replace(
        a_spec, scheme="adaptive_coded", channel_profile=ADAPT_PROFILE,
        adapt_every=ADAPT_EVERY)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    big = build_experiment(a_spec, a_xs, a_ys, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    replans = []
    t0 = time.perf_counter()
    with timed_replans(torch, big, replans):
        b_res = big.run(ROUNDS)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    b_sched = big.last_schedule
    finite = bool(torch.isfinite(b_res.theta).all()) and bool(
        np.isfinite(b_sched.t_star).all() and (b_sched.t_star > 0).all())
    emit({"phase": "adaptive", "scheme": "adaptive_coded",
          "clients": big.n, "l": big.l, "u": big.u,
          "backend": big._pick_alloc_backend(), "setup_s": setup_s,
          "replan_s": replans,
          "ms_per_round_without_replans":
              (run_s - sum(replans)) / ROUNDS * 1e3,
          "t_star_blocks": [float(t) for t in
                            b_sched.t_star[::ADAPT_EVERY]],
          "returned": [h.returned for h in b_res.history],
          "launches": launches, "finite": finite})
    check(big._pick_alloc_backend() == "vectorized",
          "adaptive n = 100: auto did not pick the vectorized solver")
    check(len(replans) == ROUNDS // ADAPT_EVERY - 1,
          f"adaptive n = 100: {len(replans)} re-plans")
    check(launches["linreg_grad_masked"] == ROUNDS,
          f"adaptive n = 100: linreg_grad_masked launched "
          f"{launches['linreg_grad_masked']} times in {ROUNDS} rounds")
    check(finite, "adaptive n = 100: theta or a deadline is not finite")
    del big, b_res

    # 6. the port of examples/adaptive_drift.py
    ops.reset_launch_counts()
    lines = []
    t0 = time.perf_counter()
    out = adaptive_drift.main(device=dev, out=lines.append)
    seconds = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    want = 2 * adaptive_drift.ITERS
    emit({"phase": "adaptive", "example": "adaptive_drift",
          "seconds": seconds, "lines": lines[1:],
          "t_target": out["t_target"], "launches": launches})
    check(launches["linreg_grad_masked"] == want,
          f"adaptive_drift: linreg_grad_masked launched "
          f"{launches['linreg_grad_masked']} times, expected {want}")
    check(out["t_target"]["adaptive"] < out["t_target"]["static"],
          "adaptive_drift: the adaptive run is not sooner to the target")
    _release(torch)


def _replay_fault_masks(exp, rng_state, rounds: int) -> list:
    """Per-round n_masked of a faulty run, replayed on the host: the
    delay draw (float32 deadlines) gives the clients that returned, the
    fault stream (default_rng((seed + 7717,))) their codes; a returned
    client with a NaN/inf code is masked, and on coded a corrupted-parity
    round masks the parity contribution too.  Without the guard nothing
    is masked."""
    from repro_torch.core.delay_model import sample_round_times
    from repro_torch.faults import CODE_INF, CODE_NAN, sample_fault_rows

    if not exp.nonfinite_guard:
        return [0] * rounds
    rng = np.random.default_rng()
    rng.bit_generator.state = rng_state
    times = sample_round_times(exp.nodes, np.asarray(exp.loads, float), rng,
                               rounds).astype(np.float32)
    codes, fpar = sample_fault_rows(
        exp.faults, np.random.default_rng((exp.fl.seed + 7717,)), rounds,
        exp.n)
    if exp.step_kind == "coded":
        ret = (times <= np.float32(exp.t_star)) & (exp.loads > 0)
        extra = fpar.astype(np.int64)
    else:                                           # naive
        ret = np.ones_like(times, bool)
        extra = np.zeros(rounds, np.int64)
    bad = np.isin(codes, (CODE_NAN, CODE_INF)) & ret
    return (bad.sum(axis=1) + extra).tolist()


def faults_path(torch, dev, state) -> None:
    """Return faults at MNIST-RFF width: coded (fused and unfused) under
    FAULTS_CODED, naive under FAULTS_NAIVE with the guard on and off, each
    against its clean twin (the main path's run) and the host replay of
    the fault stream; coded card against CPU; kill/resume with stale
    faults on and corrupted newest checkpoints."""
    import shutil

    from repro_torch.api import build_experiment
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.faults import corrupt_checkpoint
    from repro_torch.kernels import ops

    base = state["spec"]
    runs = (("coded", "coded", FAULTS_CODED, {}),
            ("coded_unfused", "coded", FAULTS_CODED,
             dict(fused_coded=False)),
            ("naive_guarded", "naive", FAULTS_NAIVE, {}),
            ("naive_unguarded", "naive", FAULTS_NAIVE,
             dict(nonfinite_guard=False)))
    kept = {}
    for name, scheme, profile, over in runs:
        spec = dataclasses.replace(base, scheme=scheme,
                                   fault_profile=profile, **over)
        t0 = time.perf_counter()
        exp = build_experiment(spec, state["xs"], state["ys"], device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        start = exp.rng.bit_generator.state
        want_masked = _replay_fault_masks(exp, start, ROUNDS)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = exp.run(ROUNDS)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) / ROUNDS * 1e3
        launches = dict(ops.LAUNCHES)
        clean_exp, clean = state["results"][scheme]
        same_wall = ([h.wall_clock for h in res.history]
                     == [h.wall_clock for h in clean.history])
        same_ret = ([h.returned for h in res.history]
                    == [h.returned for h in clean.history])
        got_masked = [h.n_masked for h in res.history]
        warm = warm_ms(torch, exp)
        clean_warm = warm_ms(torch, clean_exp)
        add_launches(state, dict(ops.LAUNCHES))
        finite = bool(torch.isfinite(res.theta).all())
        h = res.health
        emit({"phase": "faults", "run": name, "profile": profile,
              "stale": exp.stale_faults, "rounds": ROUNDS,
              "setup_s": setup_s, "wall_clock_identical_to_clean": same_wall,
              "returned_identical_to_clean": same_ret,
              "n_masked": got_masked, "n_masked_replayed": want_masked,
              "skipped": [r.skipped for r in res.history],
              "health": dataclasses.asdict(h), "theta_finite": finite,
              "accuracy_clean": clean.history[-1].accuracy,
              "first_ms_per_round": first_ms, "warm_ms_per_round": warm,
              "clean_warm_ms_per_round": clean_warm, "launches": launches})
        check(same_wall and same_ret, f"faults {name}: wall clock or "
              "returned counts differ from the clean twin")
        check(got_masked == want_masked, f"faults {name}: n_masked "
              f"{got_masked} differs from the host replay {want_masked}")
        check(finite, f"faults {name}: theta is not finite")
        sums = 2 if exp.stale_faults else 1
        check(launches["linreg_grad_masked"] == sums * ROUNDS,
              f"faults {name}: linreg_grad_masked launched "
              f"{launches['linreg_grad_masked']} times, expected "
              f"{sums * ROUNDS}")
        check(launches["linreg_grad"]
              == (ROUNDS if name == "coded_unfused" else 0),
              f"faults {name}: linreg_grad launched "
              f"{launches['linreg_grad']} times")
        if scheme == "coded":
            check(h.rounds_skipped == 0 and h.returns_masked > 0,
                  f"faults {name}: health {h}")
        elif name == "naive_unguarded":
            check(h.rounds_skipped > 0 and h.lr_scale < 1.0,
                  f"faults {name}: the unguarded run did not stall: {h}")
        else:
            check(h.rounds_skipped == 0 and h.returns_masked > 0,
                  f"faults {name}: health {h}")
        kept[name] = (exp, start)

    # coded under faults, card against CPU from the same positions
    exp, start = kept["coded"]
    exp.rng.bit_generator.state = start
    ops.reset_launch_counts()
    gpu = exp.run(CPU_ROUNDS)
    add_launches(state, dict(ops.LAUNCHES))
    cpu = build_experiment(exp.spec, state["xs"], state["ys"],
                           device="cpu").run(CPU_ROUNDS)
    err = float((gpu.theta.cpu() - cpu.theta).abs().max())
    tol = THETA_REL_TOL * max(1.0, float(cpu.theta.abs().max()))
    same = all([getattr(a, f) for a in gpu.history]
               == [getattr(b, f) for b in cpu.history]
               for f in ("wall_clock", "returned", "n_masked", "skipped"))
    emit({"phase": "faults", "run": "coded", "cpu_rounds": CPU_ROUNDS,
          "theta_max_abs_err": err, "tol": tol,
          "rounds_and_masks_identical": same})
    check(same, "faults coded: card and CPU runs saw other rounds")
    check(err <= tol, f"faults coded: card theta differs from CPU theta: "
          f"{err} > {tol}")
    del kept, exp

    # kill and resume with stale faults on: the uninterrupted run writes a
    # checkpoint a block; the newest two are corrupted (truncated, flipped
    # bits), so a fresh experiment resumes from the newest intact one
    spec = dataclasses.replace(base, fault_profile=FAULTS_CODED,
                               checkpoint_every=RESUME_EVERY)
    shutil.rmtree(FAULT_CKPT_DIR, ignore_errors=True)
    ops.reset_launch_counts()
    control = build_experiment(spec, state["xs"], state["ys"],
                               device=dev).run(
        ROUNDS, checkpoint_dir=str(FAULT_CKPT_DIR))
    paths = sorted(FAULT_CKPT_DIR.iterdir())
    arrays, meta = ckpt_io.restore_state(str(paths[-1]))
    carried = {"theta_prev": list(arrays["theta_prev"].shape)
               if "theta_prev" in arrays else None,
               "fault_rng_state": meta.get("fault_rng_state") is not None}
    kinds = [corrupt_checkpoint(str(paths[-1]), "truncate"),
             corrupt_checkpoint(str(paths[-2]), "bitflip")]
    fallback = ckpt_io.latest_checkpoint(str(FAULT_CKPT_DIR),
                                         valid_only=True)
    before = dict(ops.LAUNCHES)
    resumed = build_experiment(spec, state["xs"], state["ys"],
                               device=dev).run(
        ROUNDS, checkpoint_dir=str(FAULT_CKPT_DIR), resume=True)
    torch.cuda.synchronize()
    resumed_masked = (ops.LAUNCHES["linreg_grad_masked"]
                      - before["linreg_grad_masked"])
    add_launches(state, dict(ops.LAUNCHES))
    same = (bool(torch.equal(resumed.theta, control.theta))
            and all([getattr(a, f) for a in resumed.history]
                    == [getattr(b, f) for b in control.history]
                    for f in ("wall_clock", "returned", "n_masked",
                              "skipped"))
            and resumed.health == control.health)
    shutil.rmtree(FAULT_CKPT_DIR, ignore_errors=True)
    emit({"phase": "faults", "run": "resume", "profile": FAULTS_CODED,
          "checkpoint_every": RESUME_EVERY,
          "checkpoints": [p.name for p in paths], "corrupted": kinds,
          "resumed_from": Path(fallback).name if fallback else None,
          "carried": carried, "bit_identical": same,
          "linreg_grad_masked_resumed": resumed_masked})
    check(carried["theta_prev"] == [SIZE["q"], 10]
          and carried["fault_rng_state"],
          f"faults resume: the checkpoint carries {carried}")
    check(fallback == str(paths[-3]), f"faults resume: fell back to "
          f"{fallback}, expected {paths[-3].name}")
    check(same, "faults resume: the resumed run differs from the "
          "uninterrupted one")
    check(resumed_masked == 2 * (ROUNDS - 2 * RESUME_EVERY),
          f"faults resume: linreg_grad_masked launched {resumed_masked} "
          "times after the restore")
    _release(torch)


def secure_agg_path(torch, dev, state) -> None:
    """A coded deployment with secure_aggregation=True: its global parity
    against the main path's unmasked one, its run against the main path's
    coded run, and its setup split into solver, encode and masks."""
    from repro_torch.api import build_experiment
    from repro_torch.core import encoding, load_allocation, secure_agg
    from repro_torch.kernels import ops

    spec = dataclasses.replace(state["spec"], secure_aggregation=True)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    exp = build_experiment(spec, state["xs"], state["ys"], device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_launches = dict(ops.LAUNCHES)
    res = exp.run(ROUNDS)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    main_exp, main_res = state["coded"]
    # the setup's parts, each timed alone on the same inputs
    t0 = time.perf_counter()
    load_allocation.two_step_allocate(
        exp.nodes, [float(exp.l)] * exp.n, server=None, u_max=float(exp.u),
        m=float(exp.m))
    solver_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stacked = encoding.encode_local_batched(state["g_stack"], exp.x, exp.y,
                                            exp.w_stack)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    parity = secure_agg.secure_aggregate(
        secure_agg.masked_uploads(exp.fl.seed + 1234, stacked))
    torch.cuda.synchronize()
    masks_s = time.perf_counter() - t0
    rerun_identical = bool(torch.equal(parity.x, exp.parity.x)
                           and torch.equal(parity.y, exp.parity.y))
    gap_x = float((exp.parity.x - main_exp.parity.x).abs().max())
    gap_y = float((exp.parity.y - main_exp.parity.y).abs().max())
    x_max = float(stacked.x.abs().max())
    tol_x = secure_agg.rounding_tolerance(exp.n, 1.0, x_max)
    tol_y = secure_agg.rounding_tolerance(exp.n, 1.0,
                                          float(stacked.y.abs().max()))
    same_wall = ([h.wall_clock for h in res.history]
                 == [h.wall_clock for h in main_res.history])
    same_ret = ([h.returned for h in res.history]
                == [h.returned for h in main_res.history])
    err = float((res.theta - main_res.theta).abs().max())
    tol = THETA_REL_TOL * max(1.0, float(main_res.theta.abs().max()))
    emit({"phase": "secure_agg", "rounds": ROUNDS, "n": exp.n, "u": exp.u,
          "parity_gap_x": gap_x, "parity_gap_y": gap_y,
          "tol_x": tol_x, "tol_y": tol_y, "local_parity_abs_max": x_max,
          "global_parity_abs_max": float(main_exp.parity.x.abs().max()),
          "tol_reason": "4 eps n^1.5 (mask scale + max|x_j|), "
          "secure_agg.rounding_tolerance", "rerun_identical":
          rerun_identical, "wall_clock_identical": same_wall,
          "returned_identical": same_ret, "theta_max_abs_err": err,
          "theta_tol": tol, "setup_s": setup_s, "solver_s": solver_s,
          "encode_s": encode_s, "masks_and_sum_s": masks_s,
          "setup_launches": setup_launches, "launches": launches})
    check(gap_x <= tol_x and gap_y <= tol_y, f"secure_agg: the masked "
          f"parity is {gap_x} / {gap_y} from the unmasked one, beyond "
          f"{tol_x} / {tol_y}")
    check(gap_x > 0.0, "secure_agg: the masked parity equals the unmasked "
          "one bit for bit: were the masks added?")
    check(rerun_identical, "secure_agg: the masks drawn again differ")
    check(same_wall and same_ret, "secure_agg: wall clock or returned "
          "counts differ from the main path's coded run")
    check(err <= tol, f"secure_agg: theta differs by {err} > {tol}")
    check(setup_launches["parity_encode_batched"] == 2,
          "secure_agg: parity_encode_batched launched "
          f"{setup_launches['parity_encode_batched']} times at setup")
    check(launches["linreg_grad_masked"] == ROUNDS,
          f"secure_agg: linreg_grad_masked launched "
          f"{launches['linreg_grad_masked']} times")
    del exp, stacked, parity
    _release(torch)


def sweep_path(torch, dev, state) -> None:
    """run_sweep over SWEEP_PROFILES with every grid scheme, R = SWEEP_R,
    T = ROUNDS, each cell against the same deployment's run_multi from the
    same generator position."""
    from repro_torch.api import build_experiment
    from repro_torch.core.delay_model import HETEROGENEITY_PROFILES
    from repro_torch.kernels import ops
    from repro_torch.launch import sweep as sweep_mod

    base = state["spec"]
    profiles = {p: HETEROGENEITY_PROFILES[p] for p in SWEEP_PROFILES}
    sims, build_s, reused = {}, {}, []
    for scheme in sweep_mod.SCHEMES:
        sims[scheme] = {}
        for pname, knobs in profiles.items():
            spec = dataclasses.replace(
                base, scheme=scheme, delay_profile=None,
                fl=dataclasses.replace(base.resolved_fl(), **knobs))
            main = state["results"].get(scheme)
            if main is not None and main[0].spec == spec:
                sims[scheme][pname] = main[0]       # the main path's own
                reused.append(f"{scheme}/{pname}")
                continue
            t0 = time.perf_counter()
            sims[scheme][pname] = build_experiment(
                spec, state["xs"], state["ys"], device=dev)
            torch.cuda.synchronize()
            build_s[f"{scheme}/{pname}"] = time.perf_counter() - t0
    starts = {(s, p): sims[s][p].rng.bit_generator.state
              for s in sims for p in profiles}
    ops.reset_launch_counts()
    sw = sweep_mod.run_sweep(
        state["xs"], state["ys"], profiles=profiles, train_cfg=base.train,
        iterations=ROUNDS, realizations=SWEEP_R, schemes=sweep_mod.SCHEMES,
        sims=sims, base_spec=base)
    sweep_launches = dict(ops.LAUNCHES)
    add_launches(state, sweep_launches)
    cells = len(sweep_mod.SCHEMES) * len(profiles)
    check(sweep_launches["linreg_grad_masked"]
          == cells * SWEEP_R * ROUNDS,
          f"sweep: linreg_grad_masked launched "
          f"{sweep_launches['linreg_grad_masked']} times, expected "
          f"{cells * SWEEP_R * ROUNDS}")
    ops.reset_launch_counts()
    for scheme in sweep_mod.SCHEMES:
        looped_s, bits, errs, lens = 0.0, {}, {}, {}
        for pname in profiles:
            exp = sims[scheme][pname]
            exp.rng.bit_generator.state = starts[(scheme, pname)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop = exp.run_multi(ROUNDS, SWEEP_R)
            torch.cuda.synchronize()
            looped_s += time.perf_counter() - t0
            got = sw.results[scheme][pname]
            check(np.array_equal(got.wall_clock, loop.wall_clock)
                  and np.array_equal(got.returned, loop.returned),
                  f"sweep {scheme}/{pname}: wall clock or returned counts "
                  "differ from run_multi")
            bits[pname] = bool(torch.equal(got.theta, loop.theta))
            errs[pname] = float((got.theta - loop.theta).abs().max())
            lens[pname] = exp.consts_point_len()
            check(bits[pname], f"sweep {scheme}/{pname}: theta differs from "
                  f"run_multi's by {errs[pname]} (the padding rows past the "
                  "live ones must keep the bits)")
        emit({"phase": "sweep", "scheme": scheme,
              "profiles": list(profiles), "realizations": SWEEP_R,
              "rounds": ROUNDS, "point_len": lens,
              "l_target": max(lens.values()), "theta_bit_identical": bits,
              "theta_max_abs_err": errs,
              "host_seconds": sw.host_seconds[scheme],
              "looped_run_multi_seconds": looped_s,
              "final_mean_wall_clock": {
                  p: float(sw.results[scheme][p].wall_clock[:, -1].mean())
                  for p in profiles}})
    looped = dict(ops.LAUNCHES)
    add_launches(state, looped)
    emit({"phase": "sweep", "cells": cells, "reused_main_deployments":
          reused, "build_s": build_s, "sweep_launches": sweep_launches,
          "looped_launches": looped})
    del sims, sw
    _release(torch)


def telemetry_path(torch, dev, state) -> None:
    """Run telemetry at MNIST-RFF width: a coded deployment built inside
    `collecting()`, run with checkpoints and a journal, against a
    telemetry-off run and a second journaled run from the same generator
    position; spans, attribution, the report, the warm ms/round with
    spans off and on in turns; then `run_telemetry` at its defaults."""
    import shutil

    from repro_torch.api import (build_experiment, histories_equal,
                                 history_from_journal, obs_spans)
    from repro_torch.kernels import ops
    from repro_torch.launch import report
    from repro_torch.obs.events import EVENTS_NAME

    spec = dataclasses.replace(state["spec"], checkpoint_every=OBS_EVERY)
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    run_dir = OBS_DIR / "run"
    ops.reset_launch_counts()
    with obs_spans.collecting():
        t0 = time.perf_counter()
        exp = build_experiment(spec, state["xs"], state["ys"], device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        start = exp.rng.bit_generator.state
        before = dict(ops.LAUNCHES)
        on = exp.run(ROUNDS, checkpoint_dir=str(OBS_DIR / "ckpt"),
                     journal_dir=str(run_dir))
        on_masked = (ops.LAUNCHES["linreg_grad_masked"]
                     - before["linreg_grad_masked"])
        attr = exp.attribution()
        totals = obs_spans.totals()
        obs_spans.write_json(str(run_dir / obs_spans.SPANS_NAME))
    (run_dir / report.ATTR_NAME).write_text(
        json.dumps(attr.to_dict(), indent=2, sort_keys=True) + "\n")
    replay_ok = histories_equal(history_from_journal(str(run_dir)),
                                on.history)
    # telemetry off: the same deployment from the same generator position
    exp.rng.bit_generator.state = start
    off = exp.run(ROUNDS)
    same = (bool(torch.equal(on.theta, off.theta))
            and [h.wall_clock for h in on.history]
            == [h.wall_clock for h in off.history]
            and [h.returned for h in on.history]
            == [h.returned for h in off.history])
    # a second same-seed run journals the same bytes
    exp.rng.bit_generator.state = start
    with obs_spans.collecting():
        exp.run(ROUNDS, journal_dir=str(OBS_DIR / "run2"))
    same_bytes = ((run_dir / EVENTS_NAME).read_bytes()
                  == (OBS_DIR / "run2" / EVENTS_NAME).read_bytes())

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / ROUNDS * 1e3

    off_ms, on_ms = [], []
    for k in range(TELEMETRY_PAIRS):
        off_ms.append(timed(lambda: exp.run(ROUNDS)))
        with obs_spans.collecting():
            on_ms.append(timed(lambda: exp.run(
                ROUNDS, journal_dir=str(OBS_DIR / f"warm{k}"))))
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    text = report.render_report(str(run_dir)).splitlines()
    missing = [n for n in report.REQUIRED_SPANS if n not in totals]
    emit({"phase": "telemetry", "rounds": ROUNDS,
          "checkpoint_every": OBS_EVERY, "setup_s": setup_s,
          "span_totals": totals,
          "top_stragglers": attr.top_stragglers(),
          "comp_share_mean": attr.to_dict()["comp_share_mean"],
          "theta_rounds_identical_to_off": same,
          "journal_replay_matches": replay_ok,
          "journal_deterministic": same_bytes,
          "journal_bytes": (run_dir / EVENTS_NAME).stat().st_size,
          "warm_ms_per_round_off": off_ms, "warm_ms_per_round_on": on_ms,
          "linreg_grad_masked_on_run": on_masked, "launches": launches,
          "report_head": text[:REPORT_LINES]})
    check(same, "telemetry: the telemetry-on run differs from the off run")
    check(replay_ok, "telemetry: the journal does not replay the history")
    check(same_bytes, "telemetry: two same-seed journals differ")
    check(not missing, f"telemetry: spans {missing} never recorded")
    check(totals["checkpoint/save"]["count"] == ROUNDS // OBS_EVERY,
          f"telemetry: checkpoint/save {totals['checkpoint/save']}")
    check(on_masked == ROUNDS, f"telemetry: linreg_grad_masked launched "
          f"{on_masked} times in the {ROUNDS}-round run")
    runs = 3 + 2 * TELEMETRY_PAIRS
    check(launches["linreg_grad_masked"] == runs * ROUNDS,
          f"telemetry: linreg_grad_masked launched "
          f"{launches['linreg_grad_masked']} times in {runs} runs")
    check(launches["parity_encode_batched"] == 2,
          f"telemetry: parity_encode_batched launched "
          f"{launches['parity_encode_batched']} times")
    del exp, on, off
    shutil.rmtree(OBS_DIR, ignore_errors=True)

    # the reference's probe at its defaults, on the card
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    section = report.run_telemetry(device=dev)
    probe_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    cfg = section["config"]
    runs = 3 + 2 * cfg["repeats"]
    emit({"phase": "telemetry", "probe": "run_telemetry",
          "config": cfg, "seconds": probe_s,
          "trajectory_bit_identical": section["trajectory_bit_identical"],
          "journal_deterministic": section["journal_deterministic"],
          "journal_replay_matches": section["journal_replay_matches"],
          "disabled_seconds": section["disabled_seconds"],
          "enabled_seconds": section["enabled_seconds"],
          "overhead_ratio": section["overhead_ratio"],
          "reference_ceiling": report.MAX_OVERHEAD_RATIO,
          "span_totals": section["span_totals"], "launches": launches})
    # the ratio is a measurement here, not a gate (host noise, PERF.md)
    errs = report.validate_telemetry(section, max_overhead_ratio=math.inf)
    check(errs == [], f"telemetry probe: {errs}")
    check(launches["linreg_grad_masked"] == runs * cfg["iters"],
          f"telemetry probe: linreg_grad_masked launched "
          f"{launches['linreg_grad_masked']} times in {runs} runs of "
          f"{cfg['iters']} rounds")


def service_path(torch, dev, state) -> None:
    """The experiment service at MNIST-RFF width: a coded and a naive job
    (ROUNDS rounds, checkpoint_every OBS_EVERY, spans on) through an
    uninterrupted control service, and through a service dropped after
    SERVICE_DROP_AFTER steps and resumed by a fresh one on its root:
    theta, history and journal bytes equal; then `run_resilience` at the
    reference's defaults."""
    import shutil

    from repro_torch.api import (ExperimentService, histories_equal,
                                 obs_spans)
    from repro_torch.kernels import ops
    from repro_torch.launch import resilience
    from repro_torch.obs.events import EVENTS_NAME

    base = dataclasses.replace(state["spec"], checkpoint_every=OBS_EVERY)
    jobs = {"coded": base, "naive": dataclasses.replace(base,
                                                        scheme="naive")}
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)

    def service(name):
        svc = ExperimentService(str(SERVICE_DIR / name), device=dev)
        runs = {rid: svc.submit(spec, state["xs"], state["ys"], ROUNDS,
                                run_id=rid) for rid, spec in jobs.items()}
        return svc, runs

    ops.reset_launch_counts()
    with obs_spans.collecting():
        t0 = time.perf_counter()
        control, _ = service("control")
        torch.cuda.synchronize()
        submit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        expect = control.run_until_complete()
        control_s = time.perf_counter() - t0
        control_masked = ops.LAUNCHES["linreg_grad_masked"]
        dropped, _ = service("dropped")
        stepped = [dropped.step() for _ in range(SERVICE_DROP_AFTER)]
        del dropped                                      # the drop
        fresh, runs = service("dropped")
        resumed_at = {rid: run.state.rounds_done for rid, run in runs.items()}
        got = fresh.run_until_complete()
        totals = obs_spans.totals()
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    same = {}
    for rid in jobs:
        same[rid] = (bool(torch.equal(expect[rid].theta, got[rid].theta))
                     and histories_equal(expect[rid].history,
                                         got[rid].history)
                     and (SERVICE_DIR / "control" / rid / EVENTS_NAME)
                     .read_bytes()
                     == (SERVICE_DIR / "dropped" / rid / EVENTS_NAME)
                     .read_bytes())
    timing = {}
    for rid, rep in control.last_health.items():
        t = rep["timing"]
        timing[rid] = dict(t, block_ms_per_block=t["block_seconds"]
                           / t["blocks_run"] * 1e3,
                           ckpt_save_ms_per_block=t["ckpt_save_seconds"]
                           / t["blocks_run"] * 1e3)
    shutil.rmtree(SERVICE_DIR, ignore_errors=True)
    blocks = ROUNDS // OBS_EVERY
    emit({"phase": "service", "jobs": list(jobs), "rounds": ROUNDS,
          "checkpoint_every": OBS_EVERY, "submit_s": submit_s,
          "control_s": control_s, "stepped_before_drop": stepped,
          "resumed_at": resumed_at, "bit_identical": same,
          "health_timing": timing,
          "theta_finite": {rid: bool(torch.isfinite(got[rid].theta).all())
                           for rid in jobs},
          "span_totals": totals, "launches": launches})
    check(all(same.values()), f"service: the resumed jobs differ from the "
          f"control's: {same}")
    check(all(bool(torch.isfinite(got[rid].theta).all()) for rid in jobs),
          "service: theta is not finite")
    check(resumed_at == {"coded": 2 * OBS_EVERY, "naive": OBS_EVERY},
          f"service: resumed at {resumed_at}")
    check(control_masked == len(jobs) * ROUNDS,
          f"service: the control launched linreg_grad_masked "
          f"{control_masked} times")
    # control, then the dropped service's steps, then the resumed rest
    want = 2 * len(jobs) * ROUNDS
    check(launches["linreg_grad_masked"] == want,
          f"service: linreg_grad_masked launched "
          f"{launches['linreg_grad_masked']} times, expected {want}")
    check(launches["parity_encode_batched"] == 2 * 3,
          f"service: parity_encode_batched launched "
          f"{launches['parity_encode_batched']} times in 3 coded builds")
    check(all(t["blocks_run"] == blocks for t in timing.values()),
          f"service: blocks run {timing}")

    # the reference's resilience runner at its defaults, on the card
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    section = resilience.run_resilience(device=dev)
    res_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    errs = resilience.validate_resilience(section)
    svc = section["service"]
    emit({"phase": "service", "probe": "run_resilience",
          "config": section["config"], "seconds": res_s,
          "coded_speedup_vs_naive": {
              p: c["coded_speedup_vs_naive"]
              for p, c in section["cases"].items()},
          "host_seconds": {p: c["host_seconds"]
                           for p, c in section["cases"].items()},
          "health": {p: {v: c[v]["health"] for v in
                         ("coded", "naive", "naive_unguarded")}
                     for p, c in section["cases"].items()},
          "crash_retries": svc["crash_retries"],
          "service": svc, "errors": errs, "launches": launches})
    check(errs == [], f"resilience: {errs}")
    check(launches["linreg_grad_masked"] > 0,
          "resilience: linreg_grad_masked never launched")
    _release(torch)


def _hier_spec(state, f: float):
    """The main path's coded deployment over HIER_SHARDS edge aggregators,
    sampled at f, in blocks of HIER_EVERY rounds."""
    return dataclasses.replace(state["spec"], hier_shards=HIER_SHARDS,
                               sample_fraction=f,
                               checkpoint_every=HIER_EVERY)


def _replay_hier(exp, rng_state, srng_state, rounds: int):
    """(returned (rounds,), wall clock (rounds,)) of a hier run from the
    given stream positions, on the host: the delay rows and the cohort
    block drawn as the reference draws them, each shard against its own
    deadline."""
    from repro_torch.core.delay_model import sample_round_times_stacked

    rng = np.random.default_rng()
    rng.bit_generator.state = rng_state
    srng = np.random.default_rng()
    srng.bit_generator.state = srng_state
    loads = np.concatenate([p.loads for p in exp.plans]).astype(np.float64)
    times = np.concatenate([sample_round_times_stacked(exp._prm, loads, rng,
                                                       1)
                            for _ in range(rounds)])
    cohort = srng.random((rounds, exp.n)) < exp.sample_fraction
    ret = np.zeros(rounds, np.int64)
    for p in exp.plans:
        ret += ((times[:, p.lo:p.hi] <= p.t_star)
                & cohort[:, p.lo:p.hi]).sum(axis=1)
    t_round = max(p.t_star for p in exp.plans)
    wall = exp.setup_time + np.cumsum(np.full(rounds, t_round))
    return ret, wall


def hier_path(torch, dev, state) -> None:
    """The hierarchical tier at MNIST-RFF width: the main path's embedded
    shards over HIER_SHARDS edge aggregators, sampled at HIER_F, ROUNDS
    rounds in blocks of HIER_EVERY, built and run with telemetry on and a
    journal; launches asserted, the host replay of both streams, card
    against CPU, kill/resume and another block partition, the f = 1 twin;
    setup split by span, warm ms/round and the upload's share of it."""
    import shutil

    from repro_torch.api import build_experiment, load_events, obs_spans
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.kernels import ops

    spec = _hier_spec(state, HIER_F)
    xs, ys = state["xs"], state["ys"]
    shutil.rmtree(HIER_DIR, ignore_errors=True)

    def build(s, device=dev):
        return build_experiment(s, xs, ys, device=device)

    # build and run with telemetry on: spans, attribution, the journal
    ops.reset_launch_counts()
    with obs_spans.collecting():
        t0 = time.perf_counter()
        exp = build(spec)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        build_launches = dict(ops.LAUNCHES)
        rng0 = exp.rng.bit_generator.state
        srng0 = exp._sample_rng.bit_generator.state
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = exp.run(ROUNDS, journal_dir=str(HIER_DIR / "run"))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        run_launches = dict(ops.LAUNCHES)
        attr = exp.attribution()
        totals = obs_spans.totals()
    add_launches(state, build_launches)
    add_launches(state, run_launches)
    plans = exp.plans
    n_s = [p.n_clients for p in plans]
    check(build_launches["parity_encode_batched"] == 2 * HIER_SHARDS,
          f"hier: parity_encode_batched launched "
          f"{build_launches['parity_encode_batched']} times in a build of "
          f"{HIER_SHARDS} shards")
    for name in ("linreg_grad_masked", "linreg_grad"):
        check(run_launches[name] == HIER_SHARDS * ROUNDS,
              f"hier: {name} launched {run_launches[name]} times in "
              f"{ROUNDS} rounds of {HIER_SHARDS} shards")
    check(bool(torch.isfinite(res.theta).all()), "hier: theta not finite")
    # both streams replayed on the host at the run's own plans
    ret_want, wall_want = _replay_hier(exp, rng0, srng0, ROUNDS)
    check(np.array_equal(res.n_ret, ret_want),
          "hier: returned counts differ from the host replay")
    check(np.array_equal(res.wall_clock, wall_want),
          "hier: wall clock differs from the host replay")
    # telemetry: the tier's spans, one attribution a shard, the journal
    spans = ("setup/experiment", "hier/shard_setup", "solver/two_step",
             "encode/parity", "hier/round_block")
    missing = [s for s in spans if s not in totals]
    check(not missing, f"hier: spans {missing} not recorded")
    check(sorted(attr) == list(range(HIER_SHARDS)),
          f"hier: attribution keys {sorted(attr)}")
    events = load_events(str(HIER_DIR / "run"))
    t_stars = [p.t_star for p in plans]
    check(len(events) == ROUNDS
          and all(e["t_star_s"] == t_stars for e in events)
          and [e["returned"] for e in events] == res.n_ret.tolist(),
          "hier: the journal does not carry the run's rounds and t_star_s")

    # the same deployment on the CPU (plain versions) for CPU_ROUNDS
    t0 = time.perf_counter()
    cpu = build(spec, "cpu")
    cpu_s = time.perf_counter() - t0
    start_cpu = cpu.init_state(CPU_ROUNDS)
    got_cpu = cpu.run_block(start_cpu)
    got_card = exp.run_block(dataclasses.replace(
        start_cpu, theta=start_cpu.theta.to(dev)))
    t_err = max(abs(a.t_star - b.t_star) / (1.0 + b.t_star)
                for a, b in zip(plans, cpu.plans))
    same_loads = all(np.array_equal(a.loads, b.loads)
                     for a, b in zip(plans, cpu.plans))
    th_err = float((got_card.theta.cpu() - got_cpu.theta).abs().max())
    th_tol = THETA_REL_TOL * max(1.0, float(got_cpu.theta.abs().max()))
    check(same_loads, "hier: card and CPU loads differ")
    check(t_err <= 2e-6, f"hier: card and CPU t* differ by {t_err} "
          "relative to 1 + t*")
    check(np.array_equal(got_card.n_ret, got_cpu.n_ret),
          "hier: card and CPU returned counts differ")
    check(th_err <= th_tol, f"hier: card theta differs from CPU theta by "
          f"{th_err} > {th_tol}")

    # kill after one block, resume in a fresh experiment; another partition
    first = exp.run_block(dataclasses.replace(
        exp.init_state(ROUNDS), rng_state=rng0, sample_rng_state=srng0))
    path = exp.save_state(str(HIER_DIR / "ckpt" / (
        f"{ckpt_io.CKPT_PREFIX}{first.rounds_done:06d}.npz")), first)
    del first                                            # the kill
    t0 = time.perf_counter()
    fresh = build(spec)
    torch.cuda.synchronize()
    rebuild_s = time.perf_counter() - t0
    resumed = fresh.run(ROUNDS, checkpoint_dir=str(HIER_DIR / "ckpt"),
                        resume=True)
    same_resume = (bool(torch.equal(resumed.theta, res.theta))
                   and np.array_equal(resumed.n_ret, res.n_ret)
                   and np.array_equal(resumed.wall_clock, res.wall_clock))
    check(same_resume, "hier: the resumed run differs from the "
          "uninterrupted one")
    part = dataclasses.replace(fresh.init_state(ROUNDS), rng_state=rng0,
                               sample_rng_state=srng0)
    while not part.done:
        part = fresh.run_block(part, HIER_EVERY - 1)
    same_part = (bool(torch.equal(part.theta, res.theta))
                 and np.array_equal(part.n_ret, res.n_ret))
    check(same_part, f"hier: blocks of {HIER_EVERY - 1} differ from blocks "
          f"of {HIER_EVERY}")

    # the twin at f = 1: the same plans and delay stream, every client in
    twin = build(_hier_spec(state, 1.0))
    twin_res = twin.run(ROUNDS)
    same_plans = all(a.t_star == b.t_star and np.array_equal(a.loads, b.loads)
                     and torch.equal(a.parity_x, b.parity_x)
                     for a, b in zip(plans, twin.plans))
    check(same_plans, "hier: the f = 1 twin's plans differ")
    check(all(p.parity_weight == 1.0 for p in twin.plans)
          and all(p.parity_weight > 1.0 for p in plans),
          "hier: parity reweights off (1 at f = 1, > 1 below)")
    check(bool(np.all(twin_res.n_ret >= res.n_ret)),
          "hier: the f = 1 twin returned fewer clients than f = 0.5")
    check(twin.rng.bit_generator.state == exp.rng.bit_generator.state,
          "hier: sampling shifted the delay stream")

    # warm ms/round, and the upload of a round's shard blocks alone
    warm = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exp.run(ROUNDS)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) / ROUNDS * 1e3)

    def uploads():
        for p in plans:
            exp._shard_data(p.lo, p.hi)

    upload_ms = [time_ms(torch, uploads, ROUNDS) for _ in range(3)]
    shutil.rmtree(HIER_DIR, ignore_errors=True)
    emit({"phase": "hier", "shards": HIER_SHARDS, "sample_fraction": HIER_F,
          "n_s": n_s, "l": exp.l, "q": exp.q, "c": exp.c,
          "u_s": [p.u for p in plans], "rounds": ROUNDS,
          "checkpoint_every": HIER_EVERY,
          "t_star_s": t_stars, "t_round": res.t_round,
          "loads": [p.loads.tolist() for p in plans],
          "parity_weight": [p.parity_weight for p in plans],
          "returned": res.n_ret.tolist(),
          "twin_returned": twin_res.n_ret.tolist(),
          "wall_clock": float(res.wall_clock[-1]),
          "setup_s": setup_s, "rebuild_s": rebuild_s, "cpu_build_s": cpu_s,
          "setup_spans_s": {s: totals[s]["total_s"] for s in spans[:4]},
          "round_block_s": totals["hier/round_block"]["total_s"],
          "first_run_ms_per_round": run_s / ROUNDS * 1e3,
          "warm_ms_per_round": warm, "upload_ms_per_round": upload_ms,
          "upload_share": min(upload_ms) / min(warm),
          "host_replay_identical": True,
          "cpu": {"rounds": CPU_ROUNDS, "t_star_rel_err": t_err,
                  "loads_equal": same_loads, "theta_max_abs_err": th_err,
                  "tol": th_tol},
          "resume_identical": same_resume,
          "partition_identical": same_part,
          "attribution_miss_rate_max": [
              float(np.max(a.miss_rate)) for a in attr.values()],
          "build_launches": build_launches, "run_launches": run_launches})
    state["hier"] = (exp, res.theta)


def hier_scale_path(torch, dev, state) -> None:
    """`repro_torch.launch.hier_scale.main()` on the card at the example's
    settings, then `launch.scale.run_scale` at the reference's defaults
    over SCALE_NS, `validate_scale` empty; device peak memory beside the
    peak client tensor and the dense bytes, a rung each."""
    from repro_torch.kernels import ops
    from repro_torch.launch import hier_scale, scale

    ops.reset_launch_counts()
    lines = []
    t0 = time.perf_counter()
    out = hier_scale.main(device=dev, out=lines.append)
    example_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    check(out["bit_identical"], "hier_scale: kill/resume differs")
    check(out["section"]["identity"]["bit_identical"],
          "hier_scale: the identity configuration is not the flat run")
    check(launches["linreg_grad_masked"] > 0 and launches["linreg_grad"] > 0
          and launches["parity_encode_batched"] > 0,
          f"hier_scale: launches {launches}")
    emit({"phase": "hier_scale", "example": hier_scale.__name__,
          "seconds": example_s, "printed": lines,
          "t_round": out["result"].t_round,
          "mean_returned": float(out["result"].n_ret.mean()),
          "peak_client_tensor_bytes": out["peak_bytes"],
          "dense_bytes": out["dense_bytes"], "launches": launches})
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    section = scale.run_scale(ns=SCALE_NS, device=dev)
    scale_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    errs = scale.validate_scale(section)
    emit({"phase": "hier_scale", "probe": "run_scale", "ns": list(SCALE_NS),
          "cut": None, "seconds": scale_s,
          "rungs": [{k: e[k] for k in (
              "n", "shards", "setup_seconds", "round_seconds",
              "trace_seconds", "t_round", "mean_returned",
              "device_max_allocated_bytes", "device_peak_bytes",
              "peak_client_tensor_bytes",
              "dense_client_tensor_bytes", "population_tensor_bytes")}
              for e in section["entries"]],
          "identity": section["identity"], "errors": errs,
          "launches": launches})
    check(errs == [], f"hier_scale: validate_scale: {errs}")


def _release(torch) -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def serve_path(torch, dev, state) -> None:
    """qwen3-4b at full width, bf16: 8 x 4096-token prompts, 64 tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer

    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=SERVE["seed"], device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
    B, S, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen_len"]
    T = S + gen
    # a decode step reads every weight but the embedding table (B rows of
    # it), and the whole cache: K and V of every layer
    elem = params.embed.element_size()
    step_weight_bytes = (param_bytes - params.embed.numel() * elem
                         + B * cfg.d_model * elem)
    cache_bytes = (cfg.n_layers * 2 * B * T * cfg.n_kv_heads * cfg.head_dim
                   * elem)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve(cfg, params=params, device=dev, verbose=False, **SERVE)
    launches = dict(ops.LAUNCHES)
    add_launches(state, launches)
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * (gen - 1)
    tokens_ok = (tuple(res.tokens.shape) == (B, gen)
                 and int(res.tokens.min()) >= 0
                 and int(res.tokens.max()) < cfg.vocab)
    logits_ok = bool(torch.isfinite(res.logits).all())
    bound_ms = (step_weight_bytes + cache_bytes) / PEAK_BYTES * 1e3
    emit({"phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype, "params": n_params,
          "param_bytes": param_bytes, **SERVE, "max_seq": T,
          "init_s": init_s, "prefill_ms": res.prefill_ms,
          "first_decode_ms": res.first_decode_ms,
          "decode_ms_per_step": res.decode_ms_per_step,
          "tokens_per_s": res.tokens_per_s,
          "step_weight_bytes": step_weight_bytes,
          "cache_bytes": cache_bytes, "step_bound_ms": bound_ms,
          "step_over_bound": res.decode_ms_per_step / bound_ms,
          "peak_bytes": peak, "launches": launches,
          "expected_gqa_decode": want, "tokens_ok": tokens_ok,
          "logits_finite": logits_ok,
          "first_tokens": res.tokens[0, :8].tolist()})
    check(launches["gqa_decode"] == want, f"serve: gqa_decode launched "
          f"{launches['gqa_decode']} times, expected {want}")
    check(tokens_ok and logits_ok, "serve: tokens out of range or logits "
          "not finite")
    # where a decode step's time goes: torch.profiler over PROFILE_STEPS
    # warm decode steps of a second prefill of the same prompts, driven
    # through the model's own entry points
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.train import make_batch
    from repro_torch.models.model_zoo import build
    model = build(cfg)
    prompt = make_batch(cfg, B, S, SERVE["seed"])["tokens"].to(dev)
    logits, cache = model.prefill(params, {"tokens": prompt}, cache_len=T)
    tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
    logits, cache = model.decode_step(params, cache, tok, S)    # warm-up
    tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(PROFILE_STEPS):
            logits, cache = model.decode_step(params, cache, tok, S + 1 + i)
            tok = logits.argmax(dim=-1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(ops.LAUNCHES["gqa_decode"] == cfg.n_layers * PROFILE_STEPS,
          "serve (profiled): gqa_decode launch count")
    # device-side events (kernels, copies, fills), by name
    from torch.autograd import DeviceType
    by_name, host, aten_calls = {}, {}, 0
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.key] = evt.device_time_total / 1e3 / PROFILE_STEPS
        else:
            host[evt.key] = evt.self_cpu_time_total / 1e3 / PROFILE_STEPS
            aten_calls += evt.count if evt.key.startswith("aten::") else 0
    check(by_name, "serve (profiled): the trace holds no device event")
    busy = sum(by_name.values())
    gqa = sum(t for k, t in by_name.items()
              if "gqa_split_kernel" in k or "gqa_combine_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    per_step = wall_ms / PROFILE_STEPS
    emit({"phase": "serve", "profiled_decode_steps": PROFILE_STEPS,
          "profiled_ms_per_step": per_step,
          "device_busy_ms_per_step": busy,
          "device_idle_share": 1.0 - busy / per_step,
          "gqa_decode_device_ms_per_step": gqa,
          "gqa_decode_share_of_busy": gqa / busy if busy else None,
          "gqa_decode_share_of_step": gqa / res.decode_ms_per_step,
          "top_device_ms_per_step": [[k[:90], t] for k, t in top],
          "host_self_ms_per_step": sum(host.values()),
          "aten_calls_per_step": aten_calls / PROFILE_STEPS,
          "top_host_self_ms_per_step": [
              [k[:60], t] for k, t in sorted(host.items(),
                                             key=lambda kv: -kv[1])[:8]],
          "source": "torch.profiler (CPU + CUDA) over warm decode steps; "
          "shares of the unprofiled run's decode_ms_per_step and of the "
          "profiled device busy time"})
    state["serve"] = {"decode_ms_per_step": res.decode_ms_per_step,
                      "gqa_profiled_ms_per_step": gqa}
    del model, cache, logits, prompt
    del params, res
    _release(torch)


def serve_check(torch, dev, state) -> None:
    """Full width at CHECK_LAYERS layers, float32: the kernel decode path
    against a prefill over prompt + generated tokens."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import make_batch
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_config(SERVE_ARCH), n_layers=CHECK_LAYERS,
                              dtype="float32")
    params = transformer.init_params(cfg, seed=1, device=dev)
    B, S = SERVE["batch"], SERVE["prompt_len"]
    prompt = make_batch(cfg, B, S, SERVE["seed"])["tokens"]
    for window in (0, CHECK_WINDOW):
        ops.reset_launch_counts()
        res = serve(cfg, batch=B, prompt_len=S, gen_len=CHECK_GEN,
                    window=window, seed=SERVE["seed"], device=dev,
                    params=params, verbose=False)
        launches = dict(ops.LAUNCHES)
        add_launches(state, launches)
        want_launches = CHECK_LAYERS * (CHECK_GEN - 1)
        check(launches["gqa_decode"] == want_launches,
              f"serve_check: gqa_decode launched {launches['gqa_decode']} "
              f"times, expected {want_launches}")
        # the plain path: one prefill (no gqa_decode) over the same tokens
        tokens = torch.cat([prompt, res.tokens[:, :-1]], dim=1).to(dev)
        logits, _ = transformer.prefill(cfg, params, {"tokens": tokens},
                                        window=window)
        check(ops.LAUNCHES["gqa_decode"] == want_launches,
              "serve_check: the plain prefill launched gqa_decode")
        want = logits.float().cpu()
        err = float((res.logits - want).abs().max())
        excess = float(((res.logits - want).abs()
                        - (CHECK_ATOL + CHECK_RTOL * want.abs())).max())
        slots = S + CHECK_GEN if window == 0 else min(S, window)
        emit({"phase": "serve_check", "layers": CHECK_LAYERS,
              "dtype": "float32", "window": window, "cache_slots": slots,
              "batch": B, "prompt_len": S, "gen_len": CHECK_GEN,
              "launches": launches, "logits_max_abs_err": err,
              "max_abs_logit": float(want.abs().max()),
              "atol": CHECK_ATOL, "rtol": CHECK_RTOL,
              "tol_reason": "float32 sums in other orders through 4 layers "
              "of width 2560 and the 151936-wide head; the repository's own "
              "decode-vs-prefill tolerance (tests/test_models_smoke.py:87)",
              "argmax_identical": bool(torch.equal(res.logits.argmax(-1),
                                                   want.argmax(-1)))})
        check(math.isfinite(err) and excess <= 0.0,
              f"serve_check window {window}: decode logits differ from the "
              f"prefill's by {err}")
    del params
    _release(torch)


def serve_cpu(torch, dev, state) -> None:
    """The smoke variant served on the card and on the CPU."""
    import copy

    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer

    cfg = smoke_variant(get_config(SERVE_ARCH))
    params = transformer.init_params(cfg, seed=SMOKE_SERVE["seed"],
                                     device="cpu")
    for window in (0, 16):
        ops.reset_launch_counts()
        gpu = serve(cfg, window=window, device=dev,
                    params=copy.deepcopy(params), verbose=False,
                    **SMOKE_SERVE)
        launches = dict(ops.LAUNCHES)
        add_launches(state, launches)
        cpu = serve(cfg, window=window, device="cpu", params=params,
                    verbose=False, **SMOKE_SERVE)
        check(ops.LAUNCHES == launches, "serve_cpu: the CPU run launched")
        same = bool(torch.equal(gpu.tokens, cpu.tokens))
        err = float((gpu.logits - cpu.logits).abs().max())
        emit({"phase": "serve_cpu", "arch": cfg.name, "window": window,
              **SMOKE_SERVE, "launches": launches,
              "tokens_identical": same, "logits_max_abs_err": err,
              "tol": SMOKE_LOGIT_ATOL, "tol_reason": "float32 sums of <= 512 "
              "terms in another order through 2 layers"})
        want = cfg.n_layers * (SMOKE_SERVE["gen_len"] - 1)
        check(launches["gqa_decode"] == want, f"serve_cpu: gqa_decode "
              f"launched {launches['gqa_decode']} times, expected {want}")
        check(same, f"serve_cpu window {window}: card and CPU tokens differ")
        check(err <= SMOKE_LOGIT_ATOL, f"serve_cpu window {window}: logits "
              f"differ by {err}")


def gqa_checks(torch, dev, state) -> dict:
    """gqa_decode against its plain version at the serving shape (bf16 and
    float32) and at edge shapes; kernel, plain, SDPA and bound times."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev).manual_seed(11)
    bf16 = torch.bfloat16

    def rolling(T, last):
        pos = torch.empty(T, dtype=torch.int32)
        for p in range(last - T + 1, last + 1):
            pos[p % T] = p
        return pos.to(dev)

    def case(B, H, K, hd, hdv, T, q_pos, window=0, k_pos=None,
             dtype=torch.float32):
        q = torch.randn((B, H, hd), generator=gen, device=dev)
        k = torch.randn((B, T, K, hd), generator=gen, device=dev)
        v = torch.randn((B, T, K, hdv), generator=gen, device=dev)
        if k_pos is None:
            k_pos = torch.arange(T, dtype=torch.int32, device=dev)
        return (q.to(dtype), k.to(dtype), v.to(dtype), k_pos, q_pos, window)

    cfg = get_config(SERVE_ARCH)
    B, T = SERVE["batch"], SERVE["prompt_len"] + SERVE["gen_len"]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # the serving shape at the last decode step: every slot valid
    main = case(B, H, K, hd, hd, T, T - 1, dtype=bf16)
    main_f32 = tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                     else a for a in main)
    empty = torch.arange(300, dtype=torch.int32, device=dev)
    empty[torch.rand(300, generator=gen, device=dev) < 0.2] = -1
    # split edges at the serving batch and KV heads: T one below, at and
    # one above 2 tiles times the plan's splits on this card
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    split_t = 2 * ops.GQA_TILE * (ops.GQA_BLOCKS_PER_SM * n_sm // (B * K))
    tile = ops.GQA_TILE
    edges = []
    for dtype in (torch.float32, bf16):
        edges += [
            case(2, 32, 8, 128, 128, tile - 1, tile - 2, dtype=dtype),
            case(2, 32, 8, 128, 128, tile, tile - 1, dtype=dtype),
            case(2, 32, 8, 128, 128, tile + 1, tile, dtype=dtype),
            case(B, H, K, hd, hd, split_t - 1, split_t - 2, dtype=dtype),
            case(B, H, K, hd, hd, split_t, split_t - 1, dtype=dtype),
            case(B, H, K, hd, hd, split_t + 1, split_t, dtype=dtype),
            case(1, 16, 1, 128, 128, 129, 128, dtype=dtype),  # G = 16
            case(2, 12, 2, 24, 24, 65, 64, dtype=dtype),    # hd % 16 = 8
            case(1, 4, 2, 20, 15, 70, 69, dtype=dtype),     # no 16-byte rows
            case(2, 32, 8, 128, 128, 127, 126, dtype=dtype),
            case(2, 32, 8, 128, 128, 128, 127, dtype=dtype),
            case(2, 32, 8, 128, 128, 129, 128, dtype=dtype),
            case(2, 32, 8, 128, 128, 300, 299, window=100, dtype=dtype),
            case(2, 32, 8, 128, 128, 300, 299, k_pos=empty, dtype=dtype),
            case(2, 32, 8, 128, 128, 1024, 4159, window=1024,
                 k_pos=rolling(1024, 4159), dtype=dtype),
            case(2, 32, 8, 128, 128, 1000, 4159, window=1000,
                 k_pos=rolling(1000, 4159), dtype=dtype),   # 4160 % 1000
            case(2, 8, 8, 128, 128, 257, 256, dtype=dtype),   # G = 1
            case(2, 32, 4, 128, 128, 257, 256, dtype=dtype),  # G = 8, yi-6b
            case(2, 16, 16, 192, 128, 129, 128, dtype=dtype),  # hd_v != hd
        ]

    def kern(*a):
        return ops.gqa_decode(*a)

    def plain(*a):
        return ref.gqa_decode(*a)

    def lib_mask(q, k, v, k_pos, q_pos, window):
        """SDPA's boolean mask of the valid slots, made once outside the
        timed calls."""
        valid = (k_pos >= 0) & (k_pos <= q_pos)
        if window > 0:
            valid &= k_pos > q_pos - window
        return valid[None, None, None, :]

    def lib(q, k, v, mask):
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True)[:, :, 0]

    def tol_of(dtype):
        return REL_TOL if dtype == torch.float32 else BF16_REL_TOL

    checks = []
    for args in [main, main_f32] + edges:
        got = kern(*args)
        again = kern(*args)
        torch.cuda.synchronize()
        check(torch.equal(got, again), "gqa_decode: two launches on the same "
              "inputs gave other bits")
        err, tol = max_err(torch, got.float(), plain(*args).float(),
                           tol_of(args[0].dtype))
        checks.append({"shape": [list(a.shape) for a in args[:4]],
                       "q_pos": args[4], "window": args[5],
                       "dtype": str(args[0].dtype).replace("torch.", ""),
                       "max_abs_err": err, "tol": tol})
    # a NaN in a masked slot's V row poisons its column of the KV head's
    # outputs (0 * NaN, as in the plain version); one in a masked slot's K
    # row does not (its score is -1e30 whatever it holds)
    nq, nk, nv, npos, _, _ = case(2, 32, 8, 128, 128, 300, 299, dtype=bf16)
    npos[[40, 200]] = -1
    nv[0, 40, 1, 3] = float("nan")
    nk[1, 200, 0, 5] = float("nan")
    got = kern(nq, nk, nv, npos, 299, 0)
    want = plain(nq, nk, nv, npos, 299, 0)
    nan_v = bool(torch.equal(torch.isnan(got), torch.isnan(want))
                 and torch.isnan(got[0, 4:8, 3]).all()
                 and not torch.isnan(got[1]).any())
    check(nan_v, "gqa_decode: NaN in masked slots did not propagate as in "
          "the plain version")
    max_err(torch, got[1].float(), want[1].float(), BF16_REL_TOL)
    main_mask, f32_mask = lib_mask(*main), lib_mask(*main_f32)
    lib_err, _ = max_err(torch, lib(*main[:3], main_mask).float(),
                         plain(*main).float(), BF16_REL_TOL)
    reps = 50
    kernel_ms = time_ms(torch, lambda: kern(*main), reps)
    plain_ms = time_ms(torch, lambda: plain(*main), reps)
    library_ms = time_ms(torch, lambda: lib(*main[:3], main_mask), reps)
    f32_ms = time_ms(torch, lambda: kern(*main_f32), reps)
    f32_lib_ms = time_ms(torch, lambda: lib(*main_f32[:3], f32_mask), reps)
    kernel_device_ms = device_ms(torch, lambda: kern(*main), 20)
    library_device_ms = device_ms(
        torch, lambda: lib(*main[:3], main_mask), 20)
    kernel_host_ms = host_ms(torch, lambda: kern(*main), 20)
    library_host_ms = host_ms(torch, lambda: lib(*main[:3], main_mask), 20)
    q, k, v, k_pos, q_pos, _ = main
    # K rows of valid slots and every V row, q, k_pos and out, once each
    n_valid = int(((k_pos >= 0) & (k_pos <= q_pos)).sum())
    elem = q.element_size()
    nbytes = (q.numel() * elem + B * n_valid * K * hd * elem
              + v.numel() * elem + k_pos.numel() * 4 + q.numel() * elem)
    flops = 4 * B * H * n_valid * hd
    bound_ms, bound_by = bound(nbytes, flops)
    name, replaces, source = TPU_KERNELS[-1]
    row = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": state["launches"][name],
           "max_abs_err": checks[0]["max_abs_err"], "ms": kernel_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "shape": checks[0]["shape"],
           "status": "ported, checked"}
    n_layers = cfg.n_layers
    decode_ms = state["serve"]["decode_ms_per_step"]
    emit({"phase": "kernel", **row, "kernel_ms": kernel_ms,
          "device_ms": kernel_device_ms,
          "library_device_ms": library_device_ms,
          "device_bound_share": bound_ms / kernel_device_ms,
          "host_ms": kernel_host_ms, "library_host_ms": library_host_ms,
          "plan": list(ops.gqa_plan(B, K, T, n_sm)),
          "nan_masked_v_row": nan_v,
          "f32_ms": f32_ms, "f32_library_ms": f32_lib_ms,
          "serve_share_from_events": n_layers * kernel_ms / decode_ms,
          "serve_share_from_profiler":
              state["serve"]["gqa_profiled_ms_per_step"] / decode_ms,
          "achieved_bytes_per_s": nbytes / (kernel_ms * 1e-3),
          "bound_share": bound_ms / kernel_ms, "checks": checks,
          "library": "torch.nn.functional.scaled_dot_product_attention("
          "enable_gqa=True) with the same mask, made once outside the timed "
          "calls", "library_max_abs_err":
          lib_err, "tol_reason": f"|kernel - plain| <= {REL_TOL} * max(1, "
          "max|plain|) in float32 (sums in another order); "
          f"{BF16_REL_TOL} in bfloat16 (both round the same float32 value "
          "to bf16, one ulp apart at most)", "bytes": nbytes,
          "flops": flops, "reps": reps, "rerun_identical": True})
    return row


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
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g_stack = state["g_stack"]     # the main path's generators, redrawn
    q_true = state["omega"].shape[1]

    # (name, main-path inputs, edge inputs, library call, bytes, flops)
    rff_main = (state["x_tr"], state["omega"], state["delta"])
    m, d = rff_main[0].shape
    # one below, at and one above the 128 x 128 tile and its 16-step K
    # stage (d = 15 and 17: 4-byte copies); x off a 16-byte boundary
    tm, tn, tk = ops.TC_TILE_M, ops.TC_TILE_N, ops.TC_TILE_K
    rff_edges = [(unif(mm, dd), randn(dd, qq, scale=0.2),
                  unif(qq, hi=2 * math.pi))
                 for mm, dd, qq in ((63, 15, 63), (64, 16, 64), (65, 17, 65),
                                    (tm - 1, tk - 1, tn - 1), (tm, tk, tn),
                                    (tm + 1, tk + 1, tn + 1),
                                    (2 * tm + 1, d, 2 * tn - 1))]
    x_off = torch.empty(130 * 16 + 1, device=dev)[1:].view(130, 16)
    x_off.copy_(unif(130, 16))
    rff_edges.append((x_off, randn(16, 129, scale=0.2),
                      unif(129, hi=2 * math.pi)))

    def rff_lib(x, om, de):
        return torch.addmm(de, x, om).cos_().mul_(math.sqrt(2.0 / om.shape[1]))

    def rff_extra():
        """Reruns give the same bits; a NaN feature poisons its row as in
        the plain version; device times of kernel and library."""
        a, b = ops.rff_embed(*rff_main, q_true=q_true), \
            ops.rff_embed(*rff_main, q_true=q_true)
        torch.cuda.synchronize()
        check(torch.equal(a, b), "rff_embed: two launches on the same inputs "
              "gave other bits")
        x = rff_main[0][:300].clone()
        x[7, d // 2] = float("nan")
        got = ops.rff_embed(x, *rff_main[1:], q_true=q_true)
        want = ref.rff_embed(x, *rff_main[1:], q_true=q_true)
        nan_row = bool(torch.equal(torch.isnan(got), torch.isnan(want))
                       and torch.isnan(got[7]).all())
        check(nan_row, "rff_embed: a NaN feature did not poison its row as "
              "in the plain version")
        max_err(torch, got[:7], want[:7])
        return {"rerun_identical": True, "nan_row": nan_row,
                "device_ms": device_ms(torch, lambda: ops.rff_embed(
                    *rff_main, q_true=q_true), 20),
                "library_device_ms": device_ms(
                    torch, lambda: rff_lib(*rff_main), 20)}

    par_main = (g_stack, exp.w_stack, exp.x)
    par_y = (g_stack, exp.w_stack, exp.y)
    n, u, l = g_stack.shape
    par_edges = [(randn(nn, uu, ll), unif(nn, ll, lo=0.2), randn(nn, ll, qq))
                 for nn, uu, ll, qq in ((2, 63, 15, 63), (2, 64, 16, 64),
                                        (3, 65, 17, 65))] + [par_y]

    def par_lib(g, w, x):
        return torch.bmm(g, x * w[:, :, None])

    def par_cost(g, w, x):
        """(bytes, FFMA flops, bf16 flops, 3xTF32 flops): G, w, X read
        once, the parity set written once; the product on the tensor cores
        in 3xTF32 where q > 16, in FFMA on the narrow path."""
        nn, uu, ll = g.shape
        qq = x.shape[-1]
        nbytes = 4 * (nn * uu * ll + nn * ll + nn * ll * qq + nn * uu * qq)
        flops = 2 * nn * uu * ll * qq
        return (nbytes, flops, 0, 0) if qq <= 16 else (nbytes, 0, 0, flops)

    def par_extra():
        """The label encode (q = c), a launch of its own with its own
        library call and bound; reruns give the same bits."""
        a, b = ops.parity_encode_batched(*par_main), \
            ops.parity_encode_batched(*par_main)
        torch.cuda.synchronize()
        check(torch.equal(a, b), "parity_encode_batched: two launches on "
              "the same inputs gave other bits")
        b_ms, b_by = bound(*par_cost(*par_y))
        return {"rerun_identical": True, "labels": {
            "shape": [list(t.shape) for t in par_y],
            "ms": time_ms(torch, lambda: ops.parity_encode_batched(*par_y),
                          50),
            "plain_ms": time_ms(torch, lambda: ref.parity_encode_batched(
                *par_y), 50),
            "library_ms": time_ms(torch, lambda: par_lib(*par_y), 50),
            "device_ms": device_ms(
                torch, lambda: ops.parity_encode_batched(*par_y), 20),
            "library_device_ms": device_ms(
                torch, lambda: par_lib(*par_y), 20),
            "bound_ms": b_ms, "bound_by": b_by,
            "bytes": par_cost(*par_y)[0]}}

    # kernel 3 as the coded round calls it: the fused (31, 2400, 2000)
    # tensor with live rows (l_max, u); held against its plain version over
    # every row (lin_check)
    lin_main = (consts["gx"], res.theta, consts["gy"], consts["gmask"],
                consts["live_rows"])
    check(tuple(consts["live_rows"]) == (max(1, int(exp.loads.max())),
                                         exp.u),
          f"the coded round's live rows {consts['live_rows']} are not "
          f"(l_max, u) = ({int(exp.loads.max())}, {exp.u})")
    rows, L, q = lin_main[0].shape
    c = lin_main[1].shape[1]
    lin_edges = [(randn(nn, LL, qq, scale=0.3), randn(qq, cc, scale=0.3),
                  randn(nn, LL, cc), unif(nn, LL), None)
                 for nn, LL, qq, cc in ((2, 63, 127, 15), (2, 64, 128, 16),
                                        (2, 65, 129, 17))]

    def lin_kern(x, th, y, mask, live):
        return ops.linreg_grad_masked(x, th, y, mask, live_rows=live)

    def lin_plain(x, th, y, mask, live):
        return ref.linreg_grad_masked(x, th, y, mask, live_rows=live)

    def lin_check(x, th, y, mask, live):
        """The plain version over EVERY row: the kernel's skip of the rows
        past the live counts is held against it."""
        return ref.linreg_grad_masked(x, th, y, mask)

    def lin_lib(x, th, y, mask, live):
        """The same function in library calls over the same rows: baddbmm
        and bmm over the (n - 1, live_c, q) client block, two matmuls over
        the last row's live_l rows."""
        nn, LL, _ = x.shape
        lc, ll = (LL, LL) if live is None else live
        xc = x[:nn - 1, :lc]
        r = torch.baddbmm(y[:nn - 1, :lc], xc,
                          th.expand(nn - 1, *th.shape), beta=-1)
        g = torch.bmm(xc.mT, r * mask[:nn - 1, :lc, None])
        xl = x[nn - 1, :ll]
        rl = (xl @ th - y[nn - 1, :ll]) * mask[nn - 1, :ll, None]
        return torch.cat([g, (xl.T @ rl)[None]])

    def lin_cost(x, th, y, mask, live):
        """(bytes, FFMA flops) of the live rows: x, y and mask of those rows
        and theta read once, g written once; two contractions."""
        nn, LL, qq = x.shape
        lc, ll = (LL, LL) if live is None else live
        cc = th.shape[1]
        live_n = (nn - 1) * lc + ll
        return (4 * (live_n * (qq + cc + 1) + qq * cc + nn * qq * cc),
                4 * live_n * qq * cc)

    def lin_variant(args, reps):
        b_ms, b_by = bound(*lin_cost(*args))
        return {"kernel_ms": time_ms(torch, lambda: lin_kern(*args), reps),
                "library_ms": time_ms(torch, lambda: lin_lib(*args), reps),
                "device_ms": device_ms(torch, lambda: lin_kern(*args), 10),
                "library_device_ms": device_ms(
                    torch, lambda: lin_lib(*args), 10),
                "bound_ms": b_ms, "bound_by": b_by,
                "bytes": lin_cost(*args)[0],
                "shape": list(args[0].shape),
                "live_rows": None if args[4] is None else list(args[4])}

    naive_consts = state["results"]["naive"][0].build_consts()
    lin_naive = (naive_consts["gx"], res.theta, naive_consts["gy"],
                 naive_consts["gmask"], None)

    def lin_extra():
        """Reruns give the same bits; the kernel over every row of the
        fused tensor and at the naive round's (30, l, q) tensor, each with
        its library calls and bound over the same rows."""
        a, b = lin_kern(*lin_main), lin_kern(*lin_main)
        torch.cuda.synchronize()
        check(torch.equal(a, b), "linreg_grad_masked: two launches on the "
              "same inputs gave other bits")
        every = (*lin_main[:4], None)
        err, _ = max_err(torch, lin_kern(*every), lin_check(*every))
        err_n, _ = max_err(torch, lin_kern(*lin_naive), lin_check(*lin_naive))
        return {"rerun_identical": True,
                "plan": list(ops.masked_plan(rows, q, c, lin_main[4],
                                             n_sm)),
                "device_ms": device_ms(torch, lambda: lin_kern(*lin_main),
                                       20),
                # the call's device ops: theta's transpose, the kernel, the
                # combine of its row segments
                "device_ops_ms": device_kernels_ms(
                    torch, lambda: lin_kern(*lin_main), 20),
                "library_device_ms": device_ms(
                    torch, lambda: lin_lib(*lin_main), 20),
                "variants": {"every_row": {**lin_variant(every, 20),
                                           "max_abs_err": err},
                             "naive": {**lin_variant(lin_naive, 20),
                                       "max_abs_err": err_n}}}

    # kernel 4, the fused round of path A: (x, omega, delta, theta, y,
    # mask, pphi, live_rows) of the fused coded deployment as the round
    # calls it (live rows (l_max, u)), float32 and bfloat16 (the mask stays
    # float32), with and without the parity row, and with every row live
    exp_f, res_f = state["fused"]
    fc = exp_f.build_consts()
    fus_main = (fc["gx"], fc["omega"], fc["delta"], res_f.theta, fc["gy"],
                fc["gmask"], fc["pphi"], fc["live_rows"])
    nf, Lf, df = fc["gx"].shape
    rows_f, qf = nf + 1, exp_f.q
    l_live, u_live = fc["live_rows"]

    def bf16(args):
        return tuple(a if a is None or i in (5, 7) else a.to(torch.bfloat16)
                     for i, a in enumerate(args))

    def no_parity(args):
        return (*args[:4], args[4][:-1], args[5][:-1], None, args[7])

    def every_row(args):
        return (*args[:7], None)

    def d16(args):
        """x and Omega cut to their first 16 features: the embedding is 2%
        of its work at d = 784, and what remains is the kernel's cost per
        slab outside it (residual, combine, gradient, cosine epilogue)."""
        return (args[0][:, :, :16].contiguous(), args[1][:16].contiguous(),
                *args[2:])

    def fus_edge(LL, dd, qq, cc, live=None):
        mask = (unif(2, LL) > 0.3).float()
        mask[1] = 1.0 / (3 * LL)
        args = [unif(1, LL, dd), randn(dd, qq, scale=0.3),
                unif(qq, hi=2 * math.pi), randn(qq, cc, scale=0.3),
                randn(2, LL, cc), mask, randn(LL, qq, scale=0.05), live]
        if live is not None:     # zero past the live counts, as the round
            lr, lp = live
            args[0][:, lr:] = 0.0
            args[4][0, lr:] = 0.0
            args[5][0, lr:] = 0.0
            args[4][1, lp:] = 0.0
            args[5][1, lp:] = 0.0
            args[6][lp:] = 0.0
        return tuple(args)
    fus_edges = ([no_parity(fus_main), bf16(fus_main),
                  bf16(no_parity(fus_main)), every_row(fus_main),
                  bf16(every_row(fus_main))]
                 + [fus_edge(*e) for e in (
                     (63, 15, 63, 15), (64, 16, 64, 16), (65, 17, 65, 17),
                     (130, 48, 513, 17, (1, 130)),
                     (130, 48, 513, 17, (65, 64)),
                     (200, 784, 2000, 10, (64, 63)))])
    fus_edges.append(bf16(fus_edges[-1]))

    def fus_kern(x, om, de, th, y, mk, pp, live):
        return ops.rff_linreg_grad_masked(x, om, de, th, y, mk, parity_phi=pp,
                                          live_rows=live)

    def fus_plain(x, om, de, th, y, mk, pp, live):
        return ref.rff_linreg_grad_masked(x, om, de, th, y, mk, pp,
                                          n_real=x.shape[0], live_rows=live)

    def fus_check(x, om, de, th, y, mk, pp, live):
        """The plain version over EVERY row: the kernel's skip of the rows
        past the live counts is held against it."""
        return fus_plain(x, om, de, th, y, mk, pp, None)

    def fus_lib(x, om, de, th, y, mk, pp, live):
        """The same function in library calls over the same rows: addmm,
        cos, baddbmm and bmm over the live client rows, two matmuls over
        the parity row's live rows."""
        nn, LL, dd = x.shape
        lr, lp = (LL, LL) if live is None else live
        f32 = torch.float32
        s = math.sqrt(2.0 / om.shape[1])
        phi = torch.addmm(de.to(f32), x[:, :lr].reshape(nn * lr, dd).to(f32),
                          om.to(f32)).cos_().mul_(s).view(nn, lr, -1)
        th = th.to(f32)
        r = torch.baddbmm(y[:nn, :lr].to(f32), phi,
                          th.expand(nn, *th.shape), beta=-1)
        g = torch.bmm(phi.mT, r * mk[:nn, :lr, None])
        if pp is None:
            return g
        pl = pp[:lp].to(f32)
        rp = (pl @ th - y[nn, :lp].to(f32)) * mk[nn, :lp, None]
        return torch.cat([g, (pl.T @ rp)[None]])

    def fus_cost(x, om, de, th, y, mk, pp, live):
        """(bytes, FFMA flops, bf16 tensor-core flops, 3xTF32 flops) of the
        work these inputs need: every input element of the live rows read
        once, g written once; the embedding on the tensor cores (bf16, or
        3xTF32 for float32), the two contractions in FFMA."""
        nn, LL, dd = x.shape
        lr, lp = (LL, LL) if live is None else live
        qq, cc = om.shape[1], th.shape[1]
        e = x.element_size()
        par = pp is not None
        nbytes = (e * (nn * lr * dd + dd * qq + qq + qq * cc + nn * lr * cc
                       + par * (lp * cc + lp * qq))
                  + 4 * (nn * lr + par * lp) + 4 * (nn + par) * qq * cc)
        embed = 2 * nn * lr * dd * qq
        contract = 4 * (nn * lr + par * lp) * qq * cc
        bf = x.dtype == torch.bfloat16
        return (nbytes, contract, embed if bf else 0, 0 if bf else embed)

    def fus_variant(args, reps):
        """kernel, plain and library ms of one variant, and its bound."""
        cost = fus_cost(*args)
        b_ms, b_by = bound(*cost)
        return {"kernel_ms": time_ms(torch, lambda: fus_kern(*args), reps),
                "library_ms": time_ms(torch, lambda: fus_lib(*args), reps),
                "bound_ms": b_ms, "bound_by": b_by, "bytes": cost[0],
                "ffma_flops": cost[1], "bf16_flops": cost[2],
                "tf32x3_flops": cost[3],
                "live_rows": None if args[7] is None else list(args[7])}

    def fus_extra():
        """Reruns give the same bits (no atomics); NaN propagates as in the
        plain version; each variant's time beside its own library chain and
        bound (live rows as the round calls it, and every row live)."""
        a, b = fus_kern(*fus_main), fus_kern(*fus_main)
        torch.cuda.synchronize()
        check(torch.equal(a, b), "rff_linreg_grad_masked: two launches on "
              "the same inputs gave other bits")
        # a NaN feature in a masked row inside the live range poisons its
        # client; a NaN theta entry poisons that label column of every row
        x, om, de, th, y, mk, pp, live = fus_main
        x, mk = x.clone(), mk.clone()
        mk[1, 5] = 0.0
        x[1, 5, x.shape[2] // 2] = float("nan")
        got = fus_kern(x, om, de, th, y, mk, pp, live)
        want = fus_plain(x, om, de, th, y, mk, pp, None)
        keep = [i for i in range(rows_f) if i != 1]
        nan_row = bool(torch.isnan(got[1]).all()
                       and torch.isnan(want[1]).all())
        check(nan_row, "a NaN feature in a masked live row did not poison "
              "its client's gradient")
        max_err(torch, got[keep], want[keep], FUSED_REL_TOL)
        th = th.clone()
        th[th.shape[0] // 2, 2] = float("nan")
        got = fus_kern(fus_main[0], om, de, th, y, fus_main[5], pp, live)
        want = fus_plain(fus_main[0], om, de, th, y, fus_main[5], pp, None)
        nan_theta = bool(torch.equal(torch.isnan(got), torch.isnan(want))
                         and torch.isnan(got[:, :, 2]).all())
        check(nan_theta, "a NaN in theta did not propagate as in the plain "
              "version")
        variants = {
            "f32_live": fus_variant(fus_main, 5),
            "bf16_live": fus_variant(bf16(fus_main), 10),
            "f32_every_row": fus_variant(every_row(fus_main), 3),
            "bf16_every_row": fus_variant(bf16(every_row(fus_main)), 5),
            "f32_live_no_parity": fus_variant(no_parity(fus_main), 5),
            "f32_live_d16": fus_variant(d16(fus_main), 5),
            "f32_every_row_d16": fus_variant(every_row(d16(fus_main)), 3)}
        return {"rerun_identical": True, "nan_masked_live_row": nan_row,
                "nan_theta": nan_theta, "variants": variants,
                "full_L_bound_ms": variants["f32_every_row"]["bound_ms"],
                "bf16_ms": variants["bf16_live"]["kernel_ms"],
                "tol_reason_bf16": f"{FUSED_REL_TOL} as in float32: both "
                "sides take the same bf16 values; the kernel's products are "
                "exact in float32 and its sums float32"}

    # kernel 5 on path B's coded gradient: the (2400, 2000) parity set; and
    # on the legacy oracle's per-client call: client 0's processed rows
    lg_main = (exp.parity.x, res.theta, exp.parity.y)
    mp_, qp_ = exp.parity.x.shape
    idx0 = torch.from_numpy(exp.processed_idx[0]).to(dev)
    lg_legacy = (exp.x[0][idx0], res.theta, exp.y[0][idx0])
    lg_edges = [(randn(mm, qq, scale=0.3), randn(qq, cc, scale=0.3),
                 randn(mm, cc))
                for mm, qq, cc in ((63, 127, 15), (64, 128, 16),
                                   (65, 129, 17), (33, 130, 10),
                                   (70, 1025, 33))] + [lg_legacy]

    def lg_lib(x, th, y):
        return x.T @ (x @ th - y)

    def lg_cost(x, th, y):
        (mm, qq), cc = x.shape, th.shape[1]
        return 4 * (mm * qq + 2 * qq * cc + mm * cc), 4 * mm * qq * cc

    def lg_extra():
        """Reruns give the same bits; device time of kernel and library
        (the event times of a call this small carry the host's cost); the
        legacy client's shape with its own library time and bound."""
        a, b = ops.linreg_grad(*lg_main), ops.linreg_grad(*lg_main)
        torch.cuda.synchronize()
        check(torch.equal(a, b), "linreg_grad: two launches on the same "
              "inputs gave other bits")
        lb, lf = lg_cost(*lg_legacy)
        b_ms, b_by = bound(lb, lf)
        return {"rerun_identical": True,
                "device_ms": device_ms(torch, lambda: ops.linreg_grad(
                    *lg_main), 20),
                "library_device_ms": device_ms(torch, lambda: lg_lib(
                    *lg_main), 20),
                "splits": ops.linreg_grad_splits(mp_, qp_, n_sm),
                "legacy": {"shape": list(lg_legacy[0].shape),
                           "ms": time_ms(torch, lambda: ops.linreg_grad(
                               *lg_legacy), 50),
                           "plain_ms": time_ms(torch, lambda: ref.linreg_grad(
                               *lg_legacy), 50),
                           "library_ms": time_ms(torch, lambda: lg_lib(
                               *lg_legacy), 50),
                           "device_ms": device_ms(
                               torch, lambda: ops.linreg_grad(*lg_legacy),
                               20),
                           "library_device_ms": device_ms(
                               torch, lambda: lg_lib(*lg_legacy), 20),
                           "bound_ms": b_ms, "bound_by": b_by,
                           "splits": ops.linreg_grad_splits(
                               *lg_legacy[0].shape, n_sm)}}

    # kernel 6 on encode_local: client 0 of the coded deployment
    pe_main = (g_stack[0], exp.w_stack[0], exp.x[0])
    pe_edges = [(randn(uu, ll), unif(ll, lo=0.2), randn(ll, qq))
                for uu, ll, qq in ((63, 15, 63), (64, 16, 64), (65, 17, 65))]

    def pe_lib(g, w, x):
        return (g * w) @ x

    def pe_cost(g, w, x):
        return par_cost(g[None], w[None], x[None])

    # kernels 2, 3 and 5 at the hierarchical tier's shapes: shard 0 of the
    # hier phase's MNIST-RFF deployment (its own tensors and generators),
    # then the shard shapes of launch.hier_scale (n_s = 1000, l = 8, q =
    # 16, c = 3, u_s = 1600) and of launch.scale.run_scale (n_s = 1000,
    # l = 4, q = 8, c = 2, u_s = 800): l = 4 and 8 against the 16-step K
    # stage and the 8-row slabs
    from repro_torch.core.encoding import generator_matrix
    from repro_torch.hier.topology import shard_generator

    hexp, htheta = state["hier"]
    hp = hexp.plans[0]
    hx, hy = hexp._shard_data(hp.lo, hp.hi)
    hw = torch.from_numpy(np.where(
        np.arange(hexp.l)[None, :] < hp.loads[:, None],
        np.sqrt(1.0 - hp.p_return)[:, None], 1.0).astype(np.float32)).to(dev)
    hgen = shard_generator(hexp.fl.seed, 0)
    hg = torch.stack([generator_matrix(hgen, hp.u, hexp.l)
                      for _ in range(hp.n_clients)]).to(dev)
    hier_shapes = {"hier_example": (1000, 1600, 8, 16, 3),
                   "hier_scale": (1000, 800, 4, 8, 2)}

    def prefix_mask(nn, ll):
        loads = torch.randint(0, ll + 1, (nn, 1), generator=gen, device=dev)
        return (torch.arange(ll, device=dev)[None, :] < loads).float()

    hier_args = {"parity_encode_batched": {
        "hier": (hg, hw, hx), "hier_labels": (hg, hw, hy)},
        "linreg_grad_masked": {
        "hier": (hx, htheta, hy, hp.gmask, None)},
        "linreg_grad": {"hier": (hp.parity_x, htheta, hp.parity_y)}}
    for key, (nn, uu, ll, qq, cc) in hier_shapes.items():
        g_, w_ = randn(nn, uu, ll), unif(nn, ll, lo=0.2)
        x_, y_ = randn(nn, ll, qq, scale=0.3), randn(nn, ll, cc)
        th_ = randn(qq, cc, scale=0.3)
        hier_args["parity_encode_batched"][key] = (g_, w_, x_)
        hier_args["parity_encode_batched"][key + "_labels"] = (g_, w_, y_)
        hier_args["linreg_grad_masked"][key] = (x_, th_, y_,
                                                prefix_mask(nn, ll), None)
        hier_args["linreg_grad"][key] = (randn(uu, qq, scale=0.3), th_,
                                         randn(uu, cc))

    def hier_variants(name, kern, plain, lib, cost):
        """The kernel at the tier's shapes against its plain version, a
        rerun, its times, the library's and its bound."""
        out = {}
        for key, args in hier_args[name].items():
            got, again = kern(*args), kern(*args)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"{name} ({key}): two launches "
                  "on the same inputs gave other bits")
            err, tol = max_err(torch, got, plain(*args))
            lib_err, _ = max_err(torch, lib(*args), plain(*args))
            b_ms, b_by = bound(*cost(*args))
            out[key] = {
                "shape": [None if a is None else list(a.shape)
                          for a in args],
                "max_abs_err": err, "tol": tol,
                "library_max_abs_err": lib_err, "rerun_identical": True,
                "ms": time_ms(torch, lambda: kern(*args), 20),
                "plain_ms": time_ms(torch, lambda: plain(*args), 20),
                "library_ms": time_ms(torch, lambda: lib(*args), 20),
                "device_ms": device_ms(torch, lambda: kern(*args), 10),
                "library_device_ms": device_ms(torch, lambda: lib(*args),
                                               10),
                "bound_ms": b_ms, "bound_by": b_by,
                "bytes": cost(*args)[0]}
        return out

    def with_hier(extra, name, kern, plain, lib, cost):
        return lambda: {**extra(), "hier": hier_variants(name, kern, plain,
                                                         lib, cost)}

    par_extra = with_hier(par_extra, "parity_encode_batched",
                          ops.parity_encode_batched,
                          ref.parity_encode_batched, par_lib, par_cost)
    lin_extra = with_hier(lin_extra, "linreg_grad_masked", lin_kern,
                          lin_plain, lin_lib, lin_cost)
    lg_extra = with_hier(lg_extra, "linreg_grad", ops.linreg_grad,
                         ref.linreg_grad, lg_lib, lg_cost)

    # (name, kernel, plain, the version it is held against, library, main
    #  inputs, edge inputs, cost (bytes, FFMA, bf16 and 3xTF32 flops; see
    #  bound), reps, relative tolerance, extra checks); kernels 3 and 4 are
    #  called at the round's live rows and held against their plain versions
    #  over every row (lin_check, fus_check)
    specs = [
        # the product in 3xTF32 on the tensor cores, as par_cost
        ("rff_embed", lambda *a: ops.rff_embed(*a, q_true=q_true),
         lambda *a: ref.rff_embed(*a, q_true=q_true), None, rff_lib,
         rff_main, rff_edges,
         (4 * (m * d + d * q_true + q_true + m * q_true), 0, 0,
          2 * m * d * q_true), 10, REL_TOL, rff_extra),
        ("parity_encode_batched", ops.parity_encode_batched,
         ref.parity_encode_batched, None, par_lib, par_main, par_edges,
         par_cost(*par_main), 5, REL_TOL, par_extra),
        ("linreg_grad_masked", lin_kern, lin_plain, lin_check, lin_lib,
         lin_main, lin_edges, lin_cost(*lin_main), 20, REL_TOL, lin_extra),
        # float32 at live rows (l_max, u), as the round calls it: the work
        # of those rows, the embedding in 3xTF32
        ("rff_linreg_grad_masked", fus_kern, fus_plain, fus_check, fus_lib,
         fus_main, fus_edges, fus_cost(*fus_main), 5, FUSED_REL_TOL,
         fus_extra),
        ("linreg_grad", ops.linreg_grad, ref.linreg_grad, None, lg_lib,
         lg_main, lg_edges, lg_cost(*lg_main), 50, REL_TOL, lg_extra),
        ("parity_encode", ops.parity_encode, ref.parity_encode, None, pe_lib,
         pe_main, pe_edges, pe_cost(*pe_main), 20, REL_TOL, None),
    ]
    table = []
    for (name, kern, plain, held, lib, main, edges, cost, reps, rel_tol,
         extra), (_, replaces, source) in zip(specs,
                                              TPU_KERNELS[:len(specs)]):
        held = held or plain
        nbytes, flops = cost[0], sum(cost[1:])
        checks = []
        for args in [main] + edges:
            got = kern(*args)
            torch.cuda.synchronize()
            err, tol = max_err(torch, got, held(*args), rel_tol)
            checks.append({"shape": [a if a is None or isinstance(a, tuple)
                                     else list(a.shape) for a in args],
                           "dtype": str(args[0].dtype).replace("torch.", ""),
                           "max_abs_err": err, "tol": tol})
        lib_err, _ = max_err(torch, lib(*main), plain(*main), rel_tol)
        more = extra() if extra is not None else {}
        kernel_ms = time_ms(torch, lambda: kern(*main), reps)
        plain_ms = time_ms(torch, lambda: plain(*main), reps)
        library_ms = time_ms(torch, lambda: lib(*main), reps)
        bound_ms, bound_by = bound(*cost)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": state["launches"][name],
               "max_abs_err": checks[0]["max_abs_err"], "ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms,
               "shape": checks[0]["shape"], "status": "ported, checked"}
        emit({"phase": "kernel", **row, "kernel_ms": kernel_ms, **more,
              "checks": checks, "library_max_abs_err": lib_err,
              "tol_reason": f"|kernel - plain| <= {rel_tol} * "
              "max(1, max|plain|): float32 sums in another order"
              + ("; the cosine's argument too (FUSED_REL_TOL)"
                 if rel_tol != REL_TOL else ""),
              "bytes": nbytes, "flops": flops, "reps": reps})
        table.append(row)
    table.append(gqa_checks(torch, dev, state))
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
    for phase in (cpu_twin, fused_embed_path, unfused_path, legacy_path,
                  encode_local_path, resume_path, multi_path, alloc_path,
                  quickstart_path, channel_path, adaptive_path, faults_path,
                  secure_agg_path, sweep_path, telemetry_path, service_path,
                  hier_path, hier_scale_path, serve_path, serve_check,
                  serve_cpu):
        t0 = time.perf_counter()
        phase(torch, dev, state)
        emit({"phase": phase.__name__, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    table = kernel_checks(torch, dev, state)
    emit({"phase": "kernel", "seconds": time.perf_counter() - t0})
    emit({"kernels": table, "not_yet_ported": [
        {"name": name, "replaces": where, "status": "not yet ported",
         "path": path} for name, where, path in NOT_YET_PORTED]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
