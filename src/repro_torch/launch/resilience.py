"""Resilience benchmark: coded degradation vs naive stall under faults.

The port of ``repro.launch.resilience``.  This runner benches what
`repro_torch.faults` and the self-healing runtime add: the same deployment
run under client-fault profiles (non-finite gradient returns, stale
replays) with three variants per profile —

  * ``coded``            — guard on: masked faulty returns are absorbed
    by the global parity gradient (the CodedFedL aggregation already
    compensates missing client mass), so training *degrades gracefully*:
    the trajectory stays finite, ``health.returns_masked`` counts what
    was absorbed, and time-to-target barely moves.
  * ``naive`` (guard on) — faults are *detected and reported*: masked
    returns simply vanish from the average, so the run survives but
    pays for every lost contribution.
  * ``naive_unguarded``  — the ablation: with ``nonfinite_guard=False``
    a single NaN return poisons the round's gradient, the divergence
    guard skips round after round with lr backoff, and the run *stalls*
    (``rounds_skipped`` piles up, ``lr_scale`` collapses).

A second section exercises the self-healing service
(`repro_torch.launch.service`) under infrastructure faults: an injected
crash-loop run must finish bit-identical to a fault-free-infrastructure
control (retries recompute the lost blocks), and a ``bad_disk`` run
restarted over its partially corrupted checkpoint directory must fall
back to the newest intact snapshot and still finish bit-identical.

`run_resilience` returns the reference's ``resilience`` section (its
``config`` dict, ``kernel_backend`` included, plus the device);
`validate_resilience` enforces the headline claims — coded degraded
gracefully, naive (unguarded) stalled, chaos recovery was bit-exact.
Everything runs on `device` (default the GPU).  The parity generators
are the port's own draw unless the reference's are handed over
(``parity_generators``, ``service_parity_generators``; see
``repro_torch.carry``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.api import build_experiment
from repro_torch.config import ExperimentSpec, FLConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.faults import get_fault_profile

#: default fault grid: the pure non-finite profile and the harsher
#: stale+mixed-non-finite one (see repro_torch.faults.profile)
DEFAULT_FAULT_PROFILES = ("flaky_clients", "byzantine_lite")


def _tt(history, target: float) -> Optional[float]:
    """First simulated wall-clock at which the loss reaches `target`."""
    for h in history:
        if h.loss <= target:
            return float(h.wall_clock)
    return None


def _variant(result) -> dict:
    health = result.health
    return {
        "final_loss": float(result.history[-1].loss),
        "final_wall_clock": float(result.history[-1].wall_clock),
        "final_theta_finite": bool(torch.isfinite(result.theta).all()),
        "health": None if health is None else dataclasses.asdict(health),
    }


def run_resilience(n_clients: int = 10, l: int = 24, q: int = 32, c: int = 3,
                   iters: int = 40, delta: float = 0.25, psi: float = 0.3,
                   seed: int = 0, fault_profiles=DEFAULT_FAULT_PROFILES,
                   kernel_backend: str = "xla",
                   service_iters: int = 20, service_block: int = 4,
                   service_fault_seed: int = 5, device=None,
                   parity_generators=None,
                   service_parity_generators=None) -> dict:
    """Coded-vs-naive time-to-target under fault profiles + service chaos.

    Returns the ``resilience`` section.  Data is the synthetic linear
    problem (known ground truth + noise), so the loss trajectory is a
    real convergence signal.  The time-to-target target is the worse of
    the two *guarded* finals (coded, naive), so both provably reach it;
    the unguarded naive run is excluded from the target — stalling out of
    reach is its result.  `parity_generators` (n, u, l) replaces the
    coded runs' generator draw, `service_parity_generators` that of the
    service section's job.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    theta_true = rng.normal(size=(q, c)).astype(np.float32)
    xs = rng.normal(size=(n_clients, l, q)).astype(np.float32) * 0.3
    ys = (np.einsum("nlq,qc->nlc", xs, theta_true)
          + 0.005 * rng.normal(size=(n_clients, l, c)).astype(np.float32))
    fl = FLConfig(n_clients=n_clients, delta=delta, psi=psi, seed=seed)
    tc = TrainConfig(learning_rate=1.0, l2_reg=0.0)

    def eval_fn(theta):
        pred = np.einsum("nlq,qc->nlc", xs, theta.cpu().numpy())
        return float(np.mean((pred - ys) ** 2)), 0.0

    def run_one(scheme, prof, guard=True):
        spec = ExperimentSpec(fl=fl, train=tc, scheme=scheme,
                              kernel_backend=kernel_backend,
                              fault_profile=prof, nonfinite_guard=guard)
        gens = parity_generators if scheme == "coded" else None
        return build_experiment(spec, xs, ys, device=dev,
                                parity_generators=gens).run(
            iters, eval_fn=eval_fn, eval_every=1)

    clean = run_one("coded", None)
    cases = {}
    for prof in fault_profiles:
        get_fault_profile(prof)     # fail loudly on an unknown name
        t0 = time.perf_counter()
        coded = run_one("coded", prof)
        naive = run_one("naive", prof)
        naive_raw = run_one("naive", prof, guard=False)
        host = time.perf_counter() - t0

        v_coded = _variant(coded)
        v_naive = _variant(naive)
        v_raw = _variant(naive_raw)
        # graceful degradation: faults were absorbed (masked > 0), not
        # skipped around, and the trajectory stayed finite
        v_coded["degraded_gracefully"] = bool(
            v_coded["final_theta_finite"]
            and v_coded["health"]["returns_masked"] > 0)
        v_naive["faults_detected"] = bool(
            v_naive["health"]["returns_masked"] > 0)
        # stall: the divergence guard kept skipping poisoned rounds and
        # backing the lr off — progress died while theta stayed finite
        v_raw["stalled"] = bool(
            v_raw["health"]["rounds_skipped"] > 0
            and v_raw["health"]["lr_scale"] < 1.0)

        target = max(v_coded["final_loss"], v_naive["final_loss"])
        v_coded["time_to_target"] = _tt(coded.history, target)
        v_naive["time_to_target"] = _tt(naive.history, target)
        v_raw["time_to_target"] = _tt(naive_raw.history, target)
        cases[prof] = {
            "fault_profile": prof,
            "target_loss": float(target),
            "clean_final_loss": float(clean.history[-1].loss),
            "coded": v_coded,
            "naive": v_naive,
            "naive_unguarded": v_raw,
            "coded_speedup_vs_naive": (
                None if not v_coded["time_to_target"]
                or not v_naive["time_to_target"]
                else float(v_naive["time_to_target"]
                           / v_coded["time_to_target"])),
            "host_seconds": float(host),
        }

    service = _run_service_chaos(kernel_backend=kernel_backend,
                                 iters=service_iters, block=service_block,
                                 fault_seed=service_fault_seed, device=dev,
                                 parity_generators=service_parity_generators)
    return {
        "config": {
            "n_clients": n_clients, "l": l, "q": q, "c": c, "iters": iters,
            "delta": delta, "psi": psi, "seed": seed,
            "kernel_backend": kernel_backend,
            "fault_profiles": list(fault_profiles),
            "device": str(dev),
        },
        "cases": cases,
        "service": service,
    }


def _run_service_chaos(kernel_backend: str = "xla", n_clients: int = 8,
                       l: int = 24, q: int = 6, c: int = 3,
                       iters: int = 20, block: int = 4, seed: int = 3,
                       fault_seed: int = 5, device=None,
                       parity_generators=None) -> dict:
    """Self-healing service under injected infrastructure faults.

    Three services over the same job: a fault-free control, a crash-loop
    chaos service (every crashed block is retried until it lands), and a
    bad-disk service whose checkpoint files are corrupted after writing
    — then *restarted*, forcing a fallback resume past the corrupt
    latest checkpoint.  Both fault paths must reproduce the control's
    final theta bit-exactly.
    """
    import tempfile

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.launch.service import ExperimentService

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n_clients, l, q)).astype(np.float32) * 0.3
    theta_true = rng.normal(size=(q, c)).astype(np.float32)
    ys = (np.einsum("nlq,qc->nlc", xs, theta_true)
          + 0.005 * rng.normal(size=(n_clients, l, c))).astype(np.float32)
    base = ExperimentSpec(
        fl=FLConfig(n_clients=n_clients, seed=seed),
        train=TrainConfig(learning_rate=0.05), scheme="coded",
        kernel_backend=kernel_backend, checkpoint_every=block)
    job = dict(run_id="a", parity_generators=parity_generators)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        ctrl = ExperimentService(f"{root}/control", device=dev)
        ctrl.submit(base, xs, ys, iters, **job)
        expect = ctrl.run_until_complete()["a"]

        crash_spec = dataclasses.replace(base, fault_profile="crash_loop")
        chaos = ExperimentService(f"{root}/crash", device=dev,
                                  fault_seed=fault_seed, max_retries=10)
        chaos.submit(crash_spec, xs, ys, iters, **job)
        crashed = chaos.run_until_complete()["a"]
        crash_health = chaos.last_health["a"]

        disk_spec = dataclasses.replace(base, fault_profile="bad_disk")
        disk = ExperimentService(f"{root}/disk", device=dev,
                                 fault_seed=fault_seed)
        disk.submit(disk_spec, xs, ys, iters, **job)
        disk.run_until_complete()
        latest_any = ckpt_io.latest_checkpoint(f"{root}/disk/a")
        latest_ok = ckpt_io.latest_checkpoint(f"{root}/disk/a",
                                              valid_only=True)
        disk2 = ExperimentService(f"{root}/disk", device=dev)   # restart
        rerun = disk2.submit(disk_spec, xs, ys, iters, **job)
        recovered = disk2.run_until_complete()["a"]
    host = time.perf_counter() - t0

    def same(res):
        return bool(res is not None
                    and torch.equal(expect.theta, res.theta))

    return {
        "iters": int(iters),
        "block_rounds": int(block),
        "crash_retries": int(crash_health["total_retries"]),
        "crash_quarantined": bool(crash_health["quarantined"]),
        "chaos_bit_identical": same(crashed),
        "ckpt_corruption_seen": bool(latest_any != latest_ok),
        "fallback_resume": bool(rerun.fallback_resume),
        "fallback_recovery_bit_identical": same(recovered),
        "host_seconds": float(host),
    }


def validate_resilience(section) -> list[str]:
    """Structural + headline check of a ``resilience`` section.

    Beyond shape, this enforces the claims the section exists to make:
    coded degraded gracefully (finite trajectory, faults absorbed),
    guarded naive detected the faults, unguarded naive stalled, and the
    chaos service recovered bit-identically from injected crashes and
    checkpoint corruption.
    """
    errs = []
    if not isinstance(section, dict):
        return [f"resilience section must be an object, "
                f"got {type(section).__name__}"]
    config = section.get("config")
    if not isinstance(config, dict) or not config.get("fault_profiles"):
        errs.append("resilience/config: missing or empty fault profiles")
    cases = section.get("cases")
    if not isinstance(cases, dict) or not cases:
        errs.append("resilience/cases: missing or empty")
        cases = {}
    for name, case in cases.items():
        if not isinstance(case, dict):
            errs.append(f"resilience/{name}: not an object")
            continue
        for variant in ("coded", "naive", "naive_unguarded"):
            entry = case.get(variant)
            if not isinstance(entry, dict):
                errs.append(f"resilience/{name}/{variant}: missing")
                continue
            val = entry.get("final_loss")
            if not isinstance(val, (int, float)) or not np.isfinite(val):
                errs.append(f"resilience/{name}/{variant}/final_loss: "
                            f"bad value {val!r}")
            if not isinstance(entry.get("health"), dict):
                errs.append(f"resilience/{name}/{variant}/health: missing")
        coded = case.get("coded") or {}
        raw = case.get("naive_unguarded") or {}
        if coded.get("degraded_gracefully") is not True:
            errs.append(f"resilience/{name}: coded did not degrade "
                        "gracefully (trajectory non-finite or no faults "
                        "absorbed)")
        if coded.get("time_to_target") is None:
            errs.append(f"resilience/{name}/coded/time_to_target: missing")
        if (case.get("naive") or {}).get("faults_detected") is not True:
            errs.append(f"resilience/{name}: guarded naive did not detect "
                        "the injected faults")
        if raw.get("stalled") is not True:
            errs.append(f"resilience/{name}: unguarded naive did not "
                        "stall (the ablation contrast is the point)")
    service = section.get("service")
    if not isinstance(service, dict):
        errs.append("resilience/service: missing")
        return errs
    if not (isinstance(service.get("crash_retries"), int)
            and service["crash_retries"] >= 1):
        errs.append(f"resilience/service/crash_retries: expected >= 1 "
                    f"injected crash, got {service.get('crash_retries')!r}")
    for flag in ("chaos_bit_identical", "ckpt_corruption_seen",
                 "fallback_resume", "fallback_recovery_bit_identical"):
        if service.get(flag) is not True:
            errs.append(f"resilience/service/{flag}: expected True, "
                        f"got {service.get(flag)!r}")
    return errs
