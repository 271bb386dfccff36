"""Drift-scenario benchmark: static vs adaptive allocation under dynamics
(the port of ``repro.launch.scenarios``).

The profile-grid benchmark (`repro_torch.launch.bench`) compares schemes
on a *stationary* network.  This runner benches what the network layer
(`repro_torch.net`) adds: the same CodedFedL deployment run under a
drifting channel profile twice — once with the paper's static round-0
allocation, once with the adaptive controller re-solving the allocation
every ``adapt_every`` rounds — and records the **wall-clock time to a
common target loss**.  The target is the worse of the two final losses,
so both runs reach it; ``adaptive_speedup`` is static's time-to-target
over adaptive's.

Both runs share the data, seed, spec knobs and channel profile; the trace
generator is seeded per run index, so the static and adaptive runs face
the *same* realized network.  `run_scenarios` returns the reference's
``scenarios`` section (its ``config`` plus the device).  Everything runs
on `device` (default the GPU).  The parity generators are the port's own
draw unless the reference's are handed over (``parity_generators``, one
(n, u, l) stack for the static coded and the adaptive run, which draw the
same chain; see ``repro_torch.carry``).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.api import build_experiment
from repro_torch.config import ExperimentSpec, FLConfig, TrainConfig
from repro_torch.device import resolve_device
from repro_torch.net.channel import CHANNEL_PROFILES

#: default scenario grid: the two directional-drift profiles where a
#: round-0 allocation predictably goes stale (links+compute speeding up
#: -> wasted deadline slack; degrading -> bleeding return mass)
DEFAULT_SCENARIOS = ("speedup_drift", "degrade_drift")


def _tt(history, target: float) -> Optional[float]:
    """First simulated wall-clock at which the loss reaches `target`."""
    for h in history:
        if h.loss <= target:
            return float(h.wall_clock)
    return None


def run_scenarios(n_clients: int = 10, l: int = 24, q: int = 32, c: int = 3,
                  iters: int = 60, adapt_every: int = 5, delta: float = 0.25,
                  psi: float = 0.2, seed: int = 0,
                  scenarios=DEFAULT_SCENARIOS,
                  kernel_backend: str = "xla", device=None,
                  parity_generators=None) -> dict:
    """Static-vs-adaptive comparison over the drift scenarios.

    Returns the ``scenarios`` artifact section: config + one case per
    scenario with per-variant (final_loss, time_to_target, wall-clock)
    and the headline ``adaptive_speedup``.  Data is a synthetic linear
    problem (known ground truth + noise) so the loss trajectory is a
    meaningful convergence signal, not a random-label plateau.
    ``kernel_backend`` is kept in the specs for the round trip with the
    reference only.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    theta_true = rng.normal(size=(q, c)).astype(np.float32)
    xs = rng.normal(size=(n_clients, l, q)).astype(np.float32) * 0.3
    # low noise floor so the loss keeps falling across the whole run —
    # the time-to-target window then spans the drift, not just the first
    # few rounds
    ys = (np.einsum("nlq,qc->nlc", xs, theta_true)
          + 0.005 * rng.normal(size=(n_clients, l, c)).astype(np.float32))
    fl = FLConfig(n_clients=n_clients, delta=delta, psi=psi, seed=seed)
    tc = TrainConfig(learning_rate=1.0, l2_reg=0.0)

    def eval_fn(theta):
        pred = np.einsum("nlq,qc->nlc", xs, theta.cpu().numpy())
        return float(np.mean((pred - ys) ** 2)), 0.0

    def build(spec):
        return build_experiment(spec, xs, ys, device=dev,
                                parity_generators=parity_generators)

    cases = {}
    for prof in scenarios:
        if prof not in CHANNEL_PROFILES:
            raise ValueError(f"unknown channel profile {prof!r} (known: "
                             f"{tuple(CHANNEL_PROFILES)})")
        base = dict(fl=fl, train=tc, channel_profile=prof,
                    kernel_backend=kernel_backend)
        t0 = time.perf_counter()
        static = build(ExperimentSpec(**base, scheme="coded")).run(
            iters, eval_fn=eval_fn, eval_every=1)
        adaptive_exp = build(ExperimentSpec(**base, scheme="adaptive_coded",
                                            adapt_every=adapt_every))
        adaptive = adaptive_exp.run(iters, eval_fn=eval_fn, eval_every=1)
        host = time.perf_counter() - t0

        f_s = static.history[-1].loss
        f_a = adaptive.history[-1].loss
        target = max(f_s, f_a)
        tt_s = _tt(static.history, target)
        tt_a = _tt(adaptive.history, target)
        sched = adaptive_exp.last_schedule
        cases[prof] = {
            "channel_profile": prof,
            "adapt_every": adapt_every,
            "target_loss": float(target),
            "static": {
                "final_loss": float(f_s),
                "time_to_target": tt_s,
                "final_wall_clock": float(static.history[-1].wall_clock),
                "t_star": float(static.t_star),
            },
            "adaptive": {
                "final_loss": float(f_a),
                "time_to_target": tt_a,
                "final_wall_clock": float(adaptive.history[-1].wall_clock),
                "t_star_first": float(sched.t_star[0]),
                "t_star_last": float(sched.t_star[-1]),
                "n_blocks": int(sched.n_blocks),
            },
            "adaptive_speedup": (None if not tt_s or not tt_a
                                 else float(tt_s / tt_a)),
            "host_seconds": float(host),
        }
    return {
        "config": {
            "n_clients": n_clients, "l": l, "q": q, "c": c, "iters": iters,
            "adapt_every": adapt_every, "delta": delta, "psi": psi,
            "seed": seed, "kernel_backend": kernel_backend,
            "scenarios": list(scenarios), "device": str(dev),
        },
        "cases": cases,
    }


def validate_scenarios(section) -> list[str]:
    """Structural check of a ``scenarios`` section (list of problems)."""
    errs = []
    if not isinstance(section, dict):
        return [f"scenarios section must be an object, "
                f"got {type(section).__name__}"]
    config = section.get("config")
    if not isinstance(config, dict) or not config.get("scenarios"):
        errs.append("scenarios/config: missing or empty scenario list")
    cases = section.get("cases")
    if not isinstance(cases, dict) or not cases:
        return errs + ["scenarios/cases: missing or empty"]
    for name, case in cases.items():
        if not isinstance(case, dict):
            errs.append(f"scenarios/{name}: not an object")
            continue
        for field in ("channel_profile", "target_loss", "adaptive_speedup"):
            if case.get(field) is None:
                errs.append(f"scenarios/{name}/{field}: missing")
        for variant in ("static", "adaptive"):
            entry = case.get(variant)
            if not isinstance(entry, dict):
                errs.append(f"scenarios/{name}/{variant}: missing")
                continue
            for field in ("final_loss", "time_to_target",
                          "final_wall_clock"):
                val = entry.get(field)
                if not isinstance(val, (int, float)) \
                        or not np.isfinite(val) or val < 0:
                    errs.append(f"scenarios/{name}/{variant}/{field}: "
                                f"bad value {val!r}")
        spd = case.get("adaptive_speedup")
        if spd is not None and (not isinstance(spd, (int, float))
                                or not np.isfinite(spd) or spd <= 0):
            errs.append(f"scenarios/{name}/adaptive_speedup: "
                        f"bad value {spd!r}")
    return errs
