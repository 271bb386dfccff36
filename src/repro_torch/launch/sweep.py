"""Multi-deployment sweep (the paper's Fig. 4/5 profile grid; the port of
``repro.launch.sweep``).

The scheme-comparison benchmark sweeps deployments over heterogeneity
profiles (paper §V-A's k1/k2 decay knobs).  For each scheme, every
profile's deployment pads its step constants to the grid-wide point-axis
length (`Experiment.build_consts(l_target=...)`), and the SAME round step
(`fed_runtime.build_step`) replays every (profile, realization) of the
grid.  The reference vmaps one compiled scan over the grid; the port runs
the cells one after another through that one step: one gradient launch a
cell a round, as `Experiment.run_multi` runs its realizations.

Deployments must share shapes: the same (n, l, q, c), iterations,
realizations, psi and training config.  Coded deployments may have other
per-client load allocations: their dense tensors are padded to `l_target`
with zero rows past the live ones, which the round does not read, so a
padded cell gives the bits of its unpadded run.

    sweep = run_sweep(xs, ys, profiles=PROFILES, train_cfg=tc,
                      iterations=40, realizations=6)     # on the GPU
    sweep.results["coded"]["paper"].wall_clock_bands()

With equal seeds every cell reproduces the deployment's `run_multi`.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.config import ExperimentSpec, FLConfig, TrainConfig
from repro_torch.core import fed_runtime
from repro_torch.core import schemes as schemes_registry
from repro_torch.core.fed_runtime import Experiment, MultiFedResult
from repro_torch.device import resolve_device

#: import-time snapshot of the grid schemes, in registration order; the
#: run_sweep default re-reads the live registry at call time.  Adaptive
#: schemes (``Scheme.grid = False``) need a channel trace and a per-run
#: control schedule, and are not swept.
SCHEMES = schemes_registry.grid_names()


@dataclasses.dataclass
class SweepResult:
    """One sweep: results[scheme][profile] is a `MultiFedResult`.

    host_seconds[scheme] is the host time of that scheme's whole
    (profile x realization) grid, from a synchronized card to a
    synchronized card; sims holds the per-(scheme, profile) deployments
    for their metadata (t_star, loads, setup_time).
    """
    results: dict
    sims: dict
    host_seconds: dict


def _build_sims(x_stack, y_stack, profiles: dict, train_cfg: TrainConfig,
                scheme: str, fl_kwargs: dict, kernel_backend: str,
                base_spec: Optional[ExperimentSpec] = None,
                device=None) -> dict:
    """One spec-built Experiment per profile (the per-deployment setup)."""
    sims = {}
    for pname, knobs in profiles.items():
        if base_spec is not None:
            spec = dataclasses.replace(
                base_spec, scheme=scheme, delay_profile=None,
                fl=dataclasses.replace(base_spec.resolved_fl(), **knobs))
        else:
            spec = ExperimentSpec(fl=FLConfig(**{**fl_kwargs, **knobs}),
                                  train=train_cfg, scheme=scheme,
                                  kernel_backend=kernel_backend)
        sims[pname] = Experiment(spec, x_stack, y_stack, device=device)
    return sims


def _refuse(schemes, base_spec: Optional[ExperimentSpec]) -> None:
    """The reference's refusals, before any deployment is built."""
    for scheme in schemes:
        if not schemes_registry.get_scheme(scheme).grid:
            raise ValueError(
                f"scheme {scheme!r} is not grid-sweepable (adaptive "
                "schemes need a channel trace; run them through "
                "Experiment.run/run_multi under a channel profile)")
    if base_spec is None:
        return
    if base_spec.channel_profile is not None or base_spec.channel_params:
        raise ValueError(
            "run_sweep replays one step across the grid and has no "
            "traced-channel path; drop channel_profile/channel_params "
            "from base_spec")
    if base_spec.fused_embed:
        raise ValueError(
            "run_sweep derives q from the embedded x_stack and has no "
            "raw-feature path; drop fused_embed from base_spec (run "
            "fused-embed deployments through Experiment.run/run_multi)")
    if base_spec.hier_active:
        raise ValueError(
            "run_sweep replays one flat step across the grid and has no "
            "edge-aggregator path; drop hier_shards/sample_fraction from "
            "base_spec")
    faults = base_spec.resolved_faults()
    if faults is not None and faults.has_return_faults:
        raise ValueError(
            "run_sweep has no fault-injection path; drop "
            "fault_profile/fault_params from base_spec (fault runs go "
            "through Experiment.run/run_multi)")


def _check_grid(scheme_sims: dict, iterations: int):
    """The shared step's static fields and the shared lr schedule; raises
    where a profile differs in either."""
    names = list(scheme_sims)
    statics = {p: scheme_sims[p].step_static() for p in names}
    ref_static = statics[names[0]]
    if ref_static["channel"] or ref_static["faults"]:
        raise ValueError(
            "run_sweep feeds its step delays and learning rates only; "
            "deployments under a channel profile or with return faults "
            "run through Experiment.run/run_multi")
    for p, st in statics.items():
        bad = [k for k in st if st[k] != ref_static[k]]
        if bad:
            raise ValueError(
                f"profile {p!r} differs from {names[0]!r} in step-static "
                f"field(s) {bad}; sweep profiles may only vary tensor-level "
                "deployment constants (delay knobs, loads, parity), not "
                "scheme statics like psi/l2")
    lr_schedules = {p: scheme_sims[p]._lr_schedule(iterations) for p in names}
    for p, sched in lr_schedules.items():
        if not np.array_equal(sched, lr_schedules[names[0]]):
            raise ValueError(
                f"profile {p!r} has a different learning-rate schedule "
                f"than {names[0]!r}; all sweep deployments must share one "
                "TrainConfig")
    return ref_static, lr_schedules[names[0]]


def run_sweep(x_stack, y_stack, *, profiles: dict,
              train_cfg: TrainConfig, iterations: int, realizations: int,
              schemes: Optional[Sequence[str]] = None,
              fl_kwargs: Optional[dict] = None,
              kernel_backend: str = "xla",
              sims: Optional[dict] = None,
              base_spec: Optional[ExperimentSpec] = None,
              device=None) -> SweepResult:
    """Run every (scheme, profile) deployment through one step a scheme.

    profiles: {name: FLConfig-override dict} (e.g. rate_decay/mac_decay
    heterogeneity knobs); fl_kwargs: shared FLConfig fields (n_clients,
    delta, psi, seed, ...).  `base_spec` replaces fl_kwargs/kernel_backend
    with a full `ExperimentSpec` replayed across the grid (its `fl` is the
    base each profile's knobs override).  `schemes` defaults to the live
    scheme registry's grid schemes.  Setup (load allocation, parity
    encoding) runs per deployment as a looped run would, and each profile
    draws its R * T delay rows from its deployment's generator as
    `run_multi` draws them, so equal seeds reproduce looped `run_multi`
    results.  Callers that built the deployments already pass them as
    `sims` ({scheme: {profile: Experiment}}).  `device` (built
    deployments: theirs) defaults to the GPU.
    """
    if schemes is None:
        schemes = schemes_registry.grid_names()
    _refuse(schemes, base_spec)
    fl_kwargs = dict(fl_kwargs or {})
    fl_kwargs.setdefault("n_clients", int(x_stack.shape[0]))
    R, T = int(realizations), int(iterations)
    n = int(x_stack.shape[0])

    results: dict = {}
    all_sims: dict = dict(sims or {})
    host_seconds: dict = {}
    for scheme in schemes:
        scheme_sims = all_sims.get(scheme)
        if scheme_sims is None:
            scheme_sims = _build_sims(
                x_stack, y_stack, profiles, train_cfg, scheme, fl_kwargs,
                kernel_backend, base_spec, resolve_device(device))
        elif set(scheme_sims) != set(profiles):
            raise ValueError(
                f"prebuilt sims for scheme {scheme!r} cover profiles "
                f"{sorted(scheme_sims)} but the sweep grid expects "
                f"{sorted(profiles)}")
        all_sims[scheme] = scheme_sims
        names = list(scheme_sims)
        static, lrs_host = _check_grid(scheme_sims, T)
        # one common point-axis length, so every profile's tensors share
        # the shape the one step sees
        l_target = max(scheme_sims[p].consts_point_len() for p in names)
        consts = {p: scheme_sims[p].build_consts(l_target=l_target)
                  for p in names}
        times = {p: scheme_sims[p]._delays(scheme_sims[p].rng, R * T)
                 .reshape(R, T, n) for p in names}
        first = scheme_sims[names[0]]
        lrs = first._device(lrs_host)
        step = fed_runtime.build_step(static)
        cols = {}
        thetas = {}
        _sync(first.device)
        t0 = time.perf_counter()
        for p in names:
            sim = scheme_sims[p]
            runs = [fed_runtime.run_rounds(
                step, consts[p], sim._carry0(
                    torch.zeros((sim.q, sim.c), dtype=torch.float32,
                                device=sim.device), 1.0),
                (times[p][r], lrs)) for r in range(R)]
            thetas[p] = torch.stack([carry[0] for carry, _ in runs])
            cols[p] = [torch.stack(col) for col in
                       zip(*(c for _, c in runs))]
        _sync(first.device)
        host_seconds[scheme] = time.perf_counter() - t0

        per_profile = {}
        for p in names:
            sim = scheme_sims[p]
            t_rounds = cols[p][0].cpu().numpy().astype(np.float64)
            per_profile[p] = MultiFedResult(
                theta=thetas[p],
                wall_clock=sim.setup_time + np.cumsum(t_rounds, axis=1),
                returned=cols[p][1].cpu().numpy(), t_star=sim.t_star,
                loads=sim.loads, setup_time=sim.setup_time,
                privacy_eps=sim.privacy_eps)
        results[scheme] = per_profile
    return SweepResult(results=results, sims=all_sims,
                       host_seconds=host_seconds)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
