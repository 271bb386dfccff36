"""Scheme-comparison benchmark launcher (the Fig. 4/5 trajectory artifact;
the port of ``repro.launch.bench``).

Runs EVERY registered grid scheme (`repro_torch.core.schemes` — coded /
partial_coded / naive / greedy / ideal, plus anything registered since)
across a set of heterogeneity profiles and returns the scheme-comparison
artifact, schema 9, the reference's layout: the ``profiles`` grid, the
``sweep`` timings, and the ``scenarios``, ``service``, ``kernels``,
``resilience``, ``scale`` and ``telemetry`` sections of the port's
launchers.  Coded-family schemes also report their parity privacy leakage
(``privacy_eps_max_bits``, paper eq. 62).

The grid runs through `repro_torch.launch.sweep.run_sweep` (one step a
scheme over every (profile, realization) cell); with ``measure_loop`` the
looped per-profile `run_multi` path over the same deployments is timed
too, and the artifact records the measured ``sweep.speedup``.

The ideal baseline is the deterministic lower bound for the FULL-LOAD
(naive/greedy) schemes: a round costs ``max_j (l / mu_j + tau_j^down +
tau_j^up)`` simulated seconds.  The coded scheme assigns reduced loads, so
``coded_overhead_vs_ideal`` < 1 means coding beat the full-load floor.

Profiles sweep the paper's §V-A decay knobs (k1 = rate_decay, k2 =
mac_decay): ``uniform``, ``paper`` and ``extreme``.

Everything runs on `device` (default the GPU).  The port writes its
artifact to ``BENCH_fed_training_torch.json`` by default
(`ARTIFACT_NAME`), never to the reference's ``BENCH_fed_training.json``.

    PYTHONPATH=src python -m repro_torch.launch.bench --out PATH [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.bench --validate PATH
"""
from __future__ import annotations

import argparse
import datetime
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.core import schemes as schemes_registry
# re-exported names: the profile grid and the analytic round-time floor
from repro_torch.core.delay_model import HETEROGENEITY_PROFILES  # noqa: F401
from repro_torch.core.delay_model import ideal_round_time  # noqa: F401
from repro_torch.device import resolve_device, synchronize
from repro_torch.launch import kernel_bench as kernel_bench_mod
from repro_torch.launch import report as report_mod
from repro_torch.launch import resilience as resilience_mod
from repro_torch.launch import scale as scale_mod
from repro_torch.launch import scenarios as scenarios_mod
from repro_torch.launch import sweep as sweep_mod

SCHEMA_VERSION = 9
ARTIFACT_NAME = "BENCH_fed_training_torch.json"
# core grid every artifact must cover; the live registry may add more
CORE_SCHEMES = ("coded", "naive", "greedy", "ideal")
#: grid-eligible registry snapshot at import — prefer
#: `schemes_registry.grid_names()` (adaptive schemes are benched by the
#: drift-scenario section, not the profile grid)
SCHEMES = schemes_registry.grid_names()

# the reference CLI's default scale (benchmarks/bench_scheme_compare.py)
DEFAULT_SCALE = dict(n_clients=12, l=32, q=64, c=5, iters=40,
                     realizations=6, scenario_kwargs=None,
                     service_kwargs=None,
                     kernel_kwargs=dict(kernel_bench_mod.SCALES["default"],
                                        iters=20),
                     resilience_kwargs=None, scale_kwargs=None)


def _build_sims(xs, ys, profiles, fl_base, tc, kernel_backend, scheme_names,
                base_spec=None, device=None):
    """{scheme: {profile: Experiment}} — the per-deployment setup
    (load allocation, parity encode, delay network) both engines share."""
    return {scheme: sweep_mod._build_sims(xs, ys, profiles, tc, scheme,
                                          fl_base, kernel_backend, base_spec,
                                          device)
            for scheme in scheme_names}


def _run_loop(sims, iters, realizations):
    """The looped grid execution: one `run_multi` per (scheme, profile).
    Returns {profile: {scheme: (sim, multi, secs)}}."""
    out = {}
    for scheme, per_profile in sims.items():
        for pname, sim in per_profile.items():
            t0 = time.perf_counter()
            multi = sim.run_multi(iters, realizations)
            synchronize(sim.device)
            out.setdefault(pname, {})[scheme] = (
                sim, multi, time.perf_counter() - t0)
    return out


def run_schemes(n_clients: int = 12, l: int = 32, q: int = 64, c: int = 5,
                iters: int = 40, realizations: int = 6, delta: float = 0.2,
                psi: float = 0.2, seed: int = 0,
                profiles: Optional[dict] = None,
                kernel_backend: str = "xla",
                engine: str = "sweep",
                measure_loop: bool = True,
                scenario_kwargs: Optional[dict] = None,
                service_kwargs: Optional[dict] = None,
                kernel_kwargs: Optional[dict] = None,
                resilience_kwargs: Optional[dict] = None,
                scale_kwargs: Optional[dict] = None,
                telemetry_kwargs: Optional[dict] = None,
                base_spec=None, device=None) -> dict:
    """Run the scheme comparison over heterogeneity profiles on `device`.

    The scheme grid is the LIVE grid-eligible registry, so a newly
    registered scheme lands in the artifact without touching this module.
    Returns the artifact dict (see `write_artifact` / `validate_artifact`).
    Simulated wall-clocks are mean ± std over independent delay
    realizations; host timing depends on `engine`: "sweep" (default) runs
    each scheme's grid through one step and, with `measure_loop`, also
    times the looped per-profile path.

    Each optional section follows the reference's convention: its
    ``*_kwargs`` None runs the launcher at its defaults, ``{"skip": True}``
    omits the section (the artifact then fails validation; for partial
    reruns, or for a caller that attaches a section it computed already).
    ``scenarios`` (`launch.scenarios.run_scenarios`), ``service``
    (`run_service_bench`), ``kernels`` (`launch.kernel_bench`;
    ``kernel_backend`` there picks the kernels or the plain compositions),
    ``resilience`` (`launch.resilience.run_resilience`), ``scale``
    (`launch.scale.run_scale`) and ``telemetry``
    (`launch.report.run_telemetry`).  ``kernel_backend`` elsewhere is
    kept in the specs for the round trip with the reference only.

    `base_spec` replays a full `ExperimentSpec` across the profile grid
    (see `run_sweep`).  Hierarchical/sampled specs are refused: the
    scheme-comparison grid is a flat-engine benchmark.
    """
    if engine not in ("sweep", "loop"):
        raise ValueError(f"unknown engine {engine!r}")
    if base_spec is not None and base_spec.hier_active:
        raise ValueError(
            "the scheme-comparison benchmark runs the flat engine over a "
            "small dense grid and has no edge-aggregator path; drop "
            f"hier_shards (got {base_spec.hier_shards}) / sample_fraction "
            f"(got {base_spec.sample_fraction}) from base_spec — the "
            "hierarchical tier is benched by the schema-v8 'scale' "
            "section (repro.launch.scale.run_scale / "
            "benchmarks/bench_hier_scale.py)")
    dev = resolve_device(device)
    scheme_names = schemes_registry.grid_names()
    missing = set(CORE_SCHEMES) - set(scheme_names)
    if missing:
        raise RuntimeError(f"core scheme(s) unregistered: {sorted(missing)}")
    # coded-family columns of the grid (adaptive_coded is coded-family but
    # not grid-eligible — it reports under `scenarios` instead)
    coded_names = tuple(n for n in schemes_registry.coded_names()
                        if n in scheme_names)
    profiles = profiles if profiles is not None else HETEROGENEITY_PROFILES
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n_clients, l, q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(n_clients, l, c)).astype(np.float32)
    fl_base = dict(n_clients=n_clients, delta=delta, psi=psi, seed=seed)
    tc = TrainConfig(learning_rate=0.5, l2_reg=1e-5,
                     lr_decay_epochs=(max(1, iters // 2),))

    t0 = time.perf_counter()
    sims = _build_sims(xs, ys, profiles, fl_base, tc, kernel_backend,
                       scheme_names, base_spec, dev)
    synchronize(dev)
    setup_seconds = time.perf_counter() - t0

    sweep_info = None
    if engine == "sweep":
        t0 = time.perf_counter()
        sw = sweep_mod.run_sweep(
            xs, ys, profiles=profiles, train_cfg=tc, iterations=iters,
            realizations=realizations, schemes=scheme_names,
            fl_kwargs=fl_base, kernel_backend=kernel_backend, sims=sims,
            base_spec=base_spec, device=dev)
        sweep_total = time.perf_counter() - t0
        loop_total = None
        if measure_loop:
            # the looped grid execution over the SAME deployments: one
            # run_multi per (scheme, profile).  Results are discarded
            # (fresh delay draws); only the wall-clock matters.
            t0 = time.perf_counter()
            _run_loop(sims, iters, realizations)
            loop_total = time.perf_counter() - t0
        sweep_info = {
            "setup_host_seconds": float(setup_seconds),
            "host_seconds": float(sweep_total),
            "loop_host_seconds": (None if loop_total is None
                                  else float(loop_total)),
            "speedup": (None if loop_total is None
                        else float(loop_total / sweep_total)),
            "per_scheme_host_seconds": {
                s: float(t) for s, t in sw.host_seconds.items()},
        }
        # per-cell host cost: the scheme's grid time amortized over its
        # profiles, comparable with the looped engine's per-cell timings
        per_profile = {
            pname: {scheme: (sw.sims[scheme][pname],
                             sw.results[scheme][pname],
                             sw.host_seconds[scheme] / len(profiles))
                    for scheme in scheme_names}
            for pname in profiles}
    else:
        per_profile = _run_loop(sims, iters, realizations)

    out_profiles = {}
    for pname, knobs in profiles.items():
        schemes = {}
        for scheme in scheme_names:
            sim, multi, host = per_profile[pname][scheme]
            mean, std = multi.wall_clock_bands()
            schemes[scheme] = {
                "final_wall_clock_mean": float(mean[-1]),
                "final_wall_clock_std": float(std[-1]),
                "per_round_mean": float(np.diff(
                    mean, prepend=sim.setup_time).mean()),
                "setup_time": float(sim.setup_time),
                "t_star": None if sim.t_star is None else float(sim.t_star),
                "returned_mean": float(np.asarray(multi.returned).mean()),
                "host_seconds": float(host),
            }
            if scheme in coded_names:
                schemes[scheme]["total_load"] = float(np.sum(sim.loads))
                # parity privacy leakage (paper Appendix F): worst-client
                # eps-MI-DP budget of the shared parity rows
                schemes[scheme]["privacy_eps_max_bits"] = float(
                    sim.privacy_eps)
        ideal_final = schemes["ideal"]["final_wall_clock_mean"]
        naive_f = schemes["naive"]["final_wall_clock_mean"]
        coded_f = schemes["coded"]["final_wall_clock_mean"]
        out_profiles[pname] = {
            "knobs": dict(knobs),
            "schemes": schemes,
            "coded_speedup_vs_naive": float(naive_f / coded_f),
            "coded_overhead_vs_ideal": float(coded_f / ideal_final),
        }

    artifact = {
        "benchmark": "fed_training_scheme_compare",
        "schema_version": SCHEMA_VERSION,
        "generated": datetime.datetime.now(
            datetime.timezone.utc).isoformat(),
        "config": {
            "n_clients": n_clients, "l": l, "q": q, "c": c, "iters": iters,
            "realizations": realizations, "delta": delta, "psi": psi,
            "seed": seed, "kernel_backend": kernel_backend,
            "engine": engine, "schemes": list(scheme_names),
            "coded_schemes": list(coded_names), "device": str(dev),
        },
        "profiles": out_profiles,
    }
    if sweep_info is not None:
        artifact["sweep"] = sweep_info
    scenario_kwargs = dict(scenario_kwargs or {})
    if not scenario_kwargs.pop("skip", False):
        artifact["scenarios"] = scenarios_mod.run_scenarios(
            kernel_backend=kernel_backend, device=dev, **scenario_kwargs)
    service_kwargs = dict(service_kwargs or {})
    if not service_kwargs.pop("skip", False):
        artifact["service"] = run_service_bench(
            kernel_backend=kernel_backend, device=dev, **service_kwargs)
    kernel_kwargs = dict(kernel_kwargs or {})
    if not kernel_kwargs.pop("skip", False):
        kernel_kwargs.setdefault("kernel_backend", kernel_backend)
        artifact["kernels"] = kernel_bench_mod.run_kernel_bench(
            device=dev, **kernel_kwargs)
    resilience_kwargs = dict(resilience_kwargs or {})
    if not resilience_kwargs.pop("skip", False):
        artifact["resilience"] = resilience_mod.run_resilience(
            kernel_backend=kernel_backend, device=dev, **resilience_kwargs)
    scale_kwargs = dict(scale_kwargs or {})
    if not scale_kwargs.pop("skip", False):
        artifact["scale"] = scale_mod.run_scale(device=dev, **scale_kwargs)
    telemetry_kwargs = dict(telemetry_kwargs or {})
    if not telemetry_kwargs.pop("skip", False):
        telemetry_kwargs.setdefault("kernel_backend", kernel_backend)
        artifact["telemetry"] = report_mod.run_telemetry(
            device=dev, **telemetry_kwargs)
    return artifact


def run_service_bench(kernel_backend: str = "xla", n_clients: int = 10,
                      l: int = 256, q: int = 256, c: int = 8,
                      iters: int = 200, block: int = 50,
                      seed: int = 0, device=None) -> dict:
    """Measure the block-structured runtime against one whole-horizon block.

    Times a warm whole-horizon run with ``checkpoint_every=0`` (one block;
    the port has no compiled scan, so this is its "one-shot" run) against
    the same run cut into ``iters / block`` blocks: ``overhead_ratio`` is
    the price of block restructuring alone (no checkpoint I/O in either
    timing; each timed run ends with a device sync).  Then exercises the
    `repro_torch.launch.service.ExperimentService` contract: three
    multiplexed runs (coded, greedy, and adaptive_coded under
    drift_churn), killed mid-flight and resumed by a fresh service from
    their checkpoints, must reproduce the uninterrupted results
    bit-exactly (``resumed_bit_identical``).
    """
    import dataclasses
    import tempfile

    from repro_torch.api import build_experiment
    from repro_torch.config import ExperimentSpec, FLConfig
    from repro_torch.launch.service import ExperimentService

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n_clients, l, q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(n_clients, l, c)).astype(np.float32)
    fl = FLConfig(n_clients=n_clients, delta=0.2, psi=0.2, seed=seed)
    tc = TrainConfig(learning_rate=0.5, l2_reg=1e-5,
                     lr_decay_epochs=(max(1, iters // 2),))
    oneshot_spec = ExperimentSpec(fl=fl, train=tc, scheme="coded",
                                  kernel_backend=kernel_backend,
                                  checkpoint_every=0)
    blocked_spec = dataclasses.replace(oneshot_spec, checkpoint_every=block)

    def timed(spec):
        exp = build_experiment(spec, xs, ys, device=dev)
        exp.run(iters)                      # warm-up
        synchronize(dev)
        t0 = time.perf_counter()
        exp.run(iters)
        synchronize(dev)
        return time.perf_counter() - t0

    oneshot_seconds = timed(oneshot_spec)
    blocked_seconds = timed(blocked_spec)

    # multiplexed kill/resume round-trip over three heterogeneous jobs
    jobs = {
        "coded": blocked_spec,
        "greedy": dataclasses.replace(blocked_spec, scheme="greedy"),
        "adaptive": dataclasses.replace(
            blocked_spec, scheme="adaptive_coded",
            channel_profile="drift_churn", adapt_every=block),
    }
    with tempfile.TemporaryDirectory() as root:
        control = ExperimentService(f"{root}/control", device=dev)
        for rid, spec in jobs.items():
            control.submit(spec, xs, ys, iters, run_id=rid)
        expect = control.run_until_complete()

        svc = ExperimentService(f"{root}/killed", device=dev)
        for rid, spec in jobs.items():
            svc.submit(spec, xs, ys, iters, run_id=rid)
        for _ in range(len(jobs) + 1):
            svc.step()                      # partial progress, then "kill"
        del svc
        svc2 = ExperimentService(f"{root}/killed", device=dev)
        for rid, spec in jobs.items():
            svc2.submit(spec, xs, ys, iters, run_id=rid)
        results = svc2.run_until_complete()
    identical = all(torch.equal(expect[rid].theta, results[rid].theta)
                    for rid in jobs)

    return {
        "iters": int(iters),
        "block_rounds": int(block),
        "oneshot_seconds": float(oneshot_seconds),
        "blocked_seconds": float(blocked_seconds),
        "overhead_ratio": float(blocked_seconds / oneshot_seconds),
        "multiplexed_runs": len(jobs),
        "resumed_bit_identical": bool(identical),
    }


def write_artifact(result: dict, out_path: str = ARTIFACT_NAME) -> str:
    with open(out_path, "w") as fh:
        json.dump(result, fh, indent=2, sort_keys=True)
        fh.write("\n")
    return out_path


_SCHEME_FIELDS = ("final_wall_clock_mean", "final_wall_clock_std",
                  "per_round_mean", "setup_time", "returned_mean",
                  "host_seconds")


def validate_artifact(obj, *, scale_required_ns=None,
                      telemetry_max_ratio=None) -> list[str]:
    """Structural check of the scheme-comparison artifact (schema 9), the
    reference's checks: a list of problems (empty == valid).

    `obj` is a dict or a path.  ``config.schemes`` must cover the core
    grid and every profile carry an entry per recorded scheme (coded-family
    entries with ``t_star``, ``total_load`` and ``privacy_eps_max_bits``);
    the ``scenarios``, ``service``, ``kernels``, ``resilience``,
    ``scale`` and ``telemetry`` sections are required and checked by
    their launchers' validators (``service/resumed_bit_identical`` must be
    True).  ``scale_required_ns`` overrides the enforced population ladder
    (default `scale.REQUIRED_NS`) and ``telemetry_max_ratio`` the
    telemetry overhead ceiling (default `report.MAX_OVERHEAD_RATIO`), for
    reduced artifacts.
    """
    if isinstance(obj, str):
        try:
            with open(obj) as fh:
                obj = json.load(fh)
        except (OSError, json.JSONDecodeError) as exc:
            return [f"cannot load artifact: {exc}"]
    errs = []
    if not isinstance(obj, dict):
        return [f"artifact must be a JSON object, got {type(obj).__name__}"]
    if obj.get("benchmark") != "fed_training_scheme_compare":
        errs.append(f"bad benchmark id: {obj.get('benchmark')!r}")
    if obj.get("schema_version") != SCHEMA_VERSION:
        errs.append(f"bad schema_version: {obj.get('schema_version')!r}")
    for key in ("generated", "config"):
        if key not in obj:
            errs.append(f"missing top-level key {key!r}")
    config = obj.get("config") if isinstance(obj.get("config"), dict) else {}
    scheme_list = config.get("schemes")
    if not isinstance(scheme_list, list) or not scheme_list:
        errs.append("config.schemes: missing/empty scheme list")
        scheme_list = list(CORE_SCHEMES)
    missing_core = set(CORE_SCHEMES) - set(scheme_list)
    if missing_core:
        errs.append(f"config.schemes: core scheme(s) absent "
                    f"{sorted(missing_core)}")
    coded_list = config.get("coded_schemes")
    if not isinstance(coded_list, list) or "coded" not in (coded_list or []):
        errs.append("config.coded_schemes: missing or lacks 'coded'")
        coded_list = ["coded"]
    if config.get("engine") == "sweep":
        sweep = obj.get("sweep")
        if not isinstance(sweep, dict):
            errs.append("sweep engine artifact missing 'sweep' section")
        else:
            if not _is_pos(sweep.get("host_seconds")):
                errs.append(
                    f"sweep/host_seconds: bad value "
                    f"{sweep.get('host_seconds')!r}")
            for field in ("loop_host_seconds", "speedup"):
                val = sweep.get(field)
                if val is not None and not _is_pos(val):
                    errs.append(f"sweep/{field}: bad value {val!r}")
    if "scenarios" not in obj:
        errs.append("schema v4 artifact missing 'scenarios' section")
    else:
        errs.extend(scenarios_mod.validate_scenarios(obj["scenarios"]))
    service = obj.get("service")
    if not isinstance(service, dict):
        errs.append("schema v5 artifact missing 'service' section")
    else:
        for field in ("oneshot_seconds", "blocked_seconds",
                      "overhead_ratio"):
            if not _is_pos(service.get(field)):
                errs.append(f"service/{field}: bad value "
                            f"{service.get(field)!r}")
        for field in ("iters", "block_rounds"):
            val = service.get(field)
            if not isinstance(val, int) or val < 1:
                errs.append(f"service/{field}: bad value {val!r}")
        runs = service.get("multiplexed_runs")
        if not isinstance(runs, int) or runs < 3:
            errs.append(f"service/multiplexed_runs: need an int >= 3, "
                        f"got {runs!r}")
        if service.get("resumed_bit_identical") is not True:
            errs.append("service/resumed_bit_identical: kill/resume was "
                        "not bit-identical "
                        f"({service.get('resumed_bit_identical')!r})")
    if "kernels" not in obj:
        errs.append("schema v6 artifact missing 'kernels' section")
    else:
        errs.extend(kernel_bench_mod.validate_kernels(obj["kernels"]))
    if "resilience" not in obj:
        errs.append("schema v7 artifact missing 'resilience' section")
    else:
        errs.extend(resilience_mod.validate_resilience(obj["resilience"]))
    if "scale" not in obj:
        errs.append("schema v8 artifact missing 'scale' section")
    else:
        errs.extend(scale_mod.validate_scale(
            obj["scale"],
            required_ns=(scale_mod.REQUIRED_NS if scale_required_ns is None
                         else scale_required_ns)))
    if "telemetry" not in obj:
        errs.append("schema v9 artifact missing 'telemetry' section")
    else:
        errs.extend(report_mod.validate_telemetry(
            obj["telemetry"],
            max_overhead_ratio=(report_mod.MAX_OVERHEAD_RATIO
                                if telemetry_max_ratio is None
                                else telemetry_max_ratio)))
    profiles = obj.get("profiles")
    if not isinstance(profiles, dict) or not profiles:
        return errs + ["missing/empty 'profiles'"]
    for pname, prof in profiles.items():
        schemes = prof.get("schemes", {})
        for scheme in scheme_list:
            entry = schemes.get(scheme)
            if not isinstance(entry, dict):
                errs.append(f"{pname}: missing scheme {scheme!r}")
                continue
            for field in _SCHEME_FIELDS:
                val = entry.get(field)
                if not isinstance(val, (int, float)) or not np.isfinite(val) \
                        or val < 0:
                    errs.append(f"{pname}/{scheme}/{field}: bad value {val!r}")
            if scheme in coded_list:
                if not _is_pos(entry.get("t_star")):
                    errs.append(f"{pname}/{scheme}: t_star missing")
                for field in ("total_load", "privacy_eps_max_bits"):
                    if not _is_pos(entry.get(field)):
                        errs.append(f"{pname}/{scheme}/{field}: bad value "
                                    f"{entry.get(field)!r}")
        for field in ("coded_speedup_vs_naive", "coded_overhead_vs_ideal"):
            val = prof.get(field)
            if not isinstance(val, (int, float)) or not np.isfinite(val) \
                    or val <= 0:
                errs.append(f"{pname}/{field}: bad value {val!r}")
    return errs


def _is_pos(val) -> bool:
    return isinstance(val, (int, float)) and np.isfinite(val) and val > 0


def main(argv=None) -> int:
    """The CLI: run the reference CLI's ``default`` scale on `--device`,
    write the artifact to `--out` and validate it; or validate an existing
    artifact (exit 1 with its problems on stderr)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=ARTIFACT_NAME)
    ap.add_argument("--validate", metavar="PATH",
                    help="validate an existing artifact and exit")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    if args.validate:
        problems = validate_artifact(args.validate)
        if problems:
            for pr in problems:
                print(f"INVALID: {pr}", file=sys.stderr)
            return 1
        print(f"{args.validate}: OK")
        return 0
    result = run_schemes(device=args.device, **DEFAULT_SCALE)
    write_artifact(result, args.out)
    problems = validate_artifact(args.out)
    for pr in problems:
        print(f"INVALID: {pr}", file=sys.stderr)
    for pname, prof in result["profiles"].items():
        print(f"{pname}: coded_speedup_vs_naive="
              f"{prof['coded_speedup_vs_naive']:.2f}x "
              f"coded_overhead_vs_ideal={prof['coded_overhead_vs_ideal']:.2f}x")
    print(f"sweep speedup={result['sweep']['speedup']:.2f}x; "
          f"fused_vs_two_pass_ratio="
          f"{result['kernels']['fused_vs_two_pass_ratio']:.3f}")
    print(f"wrote {args.out}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
