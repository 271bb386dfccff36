"""Population scaling of the hierarchical tier (the port of
``repro.launch.scale``).

Runs `repro_torch.hier.HierExperiment` at a ladder of population sizes —
n = 1e3, 1e4, 1e5 by default — and records the wall-clock/memory scaling
curve: per-n setup and round timings, the chunked-trace cost, and the two
memory numbers that certify the O(active cohort) contract (peak transient
client-tensor bytes against the dense (n, l, q) tensor a flat run would
materialize).  Client data is streamed per block through a deterministic
synthetic `data_fn`, so no rung holds a dense population tensor.

The section also pins the routing identity at the smallest size:
``build_experiment`` with the identity configuration (``hier_shards=1,
sample_fraction=1.0``) must return the flat engine and reproduce a
directly built flat `Experiment`'s trajectory bit-exactly.

`run_scale` returns the section as a dict and writes nothing; the
experiments run on ``device`` (the GPU unless the caller asks for the
CPU).  `validate_scale` is the reference's structural check.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

#: population rungs every section must cover
REQUIRED_NS = (1_000, 10_000, 100_000)

#: target clients per edge-aggregator shard — hier_shards ~= n / cohort,
#: so the peak client tensor stays O(cohort) as n grows
DEFAULT_COHORT = 1_000


def synthetic_block(lo: int, hi: int, l: int, q: int, c: int):
    """Deterministic synthetic client block for clients [lo, hi).

    Pointwise function of (client, point, feature) indices — no RNG
    state — so any block pattern (setup's encode blocks, each round's
    shard blocks) sees consistent per-client data, and nothing O(n) is
    ever materialized.  The reference's arithmetic, the same bits.
    """
    j = np.arange(lo, hi, dtype=np.float64)[:, None, None]
    i = np.arange(l, dtype=np.float64)[None, :, None]
    kq = np.arange(q, dtype=np.float64)[None, None, :]
    kc = np.arange(c, dtype=np.float64)[None, None, :]
    x = (0.2 * np.sin(0.7 * j + 1.3 * i + 2.1 * kq)).astype(np.float32)
    y = np.cos(0.3 * j + 0.9 * i + 1.7 * kc).astype(np.float32)
    return x, y


def _identity_check(l: int, q: int, c: int, rounds: int, seed: int,
                    device=None) -> dict:
    """Pin the routing identity: the identity configuration takes the
    flat engine and reproduces a directly built flat run bit-exactly."""
    from repro_torch.api import build_experiment
    from repro_torch.config import ExperimentSpec, FLConfig, TrainConfig
    from repro_torch.core.fed_runtime import Experiment

    n = 16
    x, y = synthetic_block(0, n, l, q, c)
    spec = ExperimentSpec(
        fl=FLConfig(n_clients=n, delta=0.2, seed=seed),
        train=TrainConfig(learning_rate=0.5, l2_reg=1e-5),
        scheme="coded", hier_shards=1, sample_fraction=1.0)
    routed = build_experiment(spec, x, y, device=device)
    flat = Experiment(spec, x, y, device=device)
    th_r = routed.run(rounds).theta
    th_f = flat.run(rounds).theta
    return {
        "routes_flat_engine": type(routed).__name__ == "Experiment",
        "bit_identical": bool(torch.equal(th_r, th_f)),
    }


def run_scale(ns: Sequence[int] = REQUIRED_NS, l: int = 4, q: int = 8,
              c: int = 2, rounds: int = 3, cohort: int = DEFAULT_COHORT,
              sample_fraction: float = 0.25, seed: int = 0,
              solver_block: Optional[int] = None,
              solver_kwargs: Optional[dict] = None,
              trace_rounds: int = 2,
              trace_block: int = 4_096, device=None) -> dict:
    """The ``scale`` section: hierarchical sampled runs across the n
    ladder, on `device`.

    Every rung builds a `HierExperiment` with ``hier_shards = max(2,
    n // cohort)`` and a sampled cohort, streams its data through
    `synthetic_block`, runs ``rounds`` federated rounds, and times the
    chunked trace generator over the same population.  On a GPU each entry
    also records ``device_max_allocated_bytes``
    (`torch.cuda.max_memory_allocated` over the rung) and
    ``device_peak_bytes``, that peak above what was allocated before the
    rung.  `solver_kwargs` defaults to the reference's shallower bisection
    (``n_golden_search=16, n_bisect=28``); results stay deterministic per
    setting.  Timings are host seconds around work that ends in a device
    sync.
    """
    from repro_torch.config import ExperimentSpec, FLConfig, TrainConfig
    from repro_torch.device import resolve_device
    from repro_torch.hier import HierExperiment, generate_trace_chunked
    from repro_torch.hier.population import (DEFAULT_BLOCK,
                                             population_delay_arrays)
    from repro_torch.net.channel import CHANNEL_PROFILES

    if solver_kwargs is None:
        solver_kwargs = dict(n_golden_search=16, n_bisect=28)
    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    tc = TrainConfig(learning_rate=0.5, l2_reg=1e-5)
    # a dynamic profile so the trace timing exercises real per-round
    # dynamics; "static" would shortcut most of the generator
    trace_profile = CHANNEL_PROFILES.get(
        "drift_churn") or next(iter(CHANNEL_PROFILES.values()))
    entries = []
    for n in ns:
        n = int(n)
        shards = max(2, n // int(cohort))
        # the paper's k1/k2 decay knobs are per-client geometric,
        # calibrated for n ~ 12; re-exponentiated so the population spans
        # the SAME heterogeneity range [k^12, 1] at every n
        k1 = 0.95 ** (12.0 / n)
        k2 = 0.8 ** (12.0 / n)
        spec = ExperimentSpec(
            fl=FLConfig(n_clients=n, delta=0.2, seed=seed,
                        rate_decay=k1, mac_decay=k2), train=tc,
            scheme="coded", hier_shards=shards,
            sample_fraction=float(sample_fraction))
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
            resident = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        exp = HierExperiment(
            spec, data_fn=lambda lo, hi: synthetic_block(lo, hi, l, q, c),
            solver_block=solver_block or min(DEFAULT_BLOCK, n),
            solver_kwargs=dict(solver_kwargs), device=dev)
        sync()
        setup_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        result = exp.run(rounds)
        sync()
        round_seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        prm = population_delay_arrays(exp.fl, q * c)
        tr = generate_trace_chunked(prm, trace_profile, trace_rounds,
                                    seed=seed + 9973,
                                    block_size=min(trace_block, n))
        trace_seconds = time.perf_counter() - t0
        assert tr.mu_mult.shape == (trace_rounds, n)
        entry = {
            "n": n,
            "shards": shards,
            "sample_fraction": float(sample_fraction),
            "rounds": int(rounds),
            "setup_seconds": float(setup_seconds),
            "round_seconds": float(round_seconds),
            "wall_seconds": float(setup_seconds + round_seconds),
            "trace_seconds": float(trace_seconds),
            "trace_rounds": int(trace_rounds),
            "peak_client_tensor_bytes": int(exp.peak_client_tensor_bytes()),
            "dense_client_tensor_bytes": int(4 * n * l * (q + c)),
            "population_tensor_bytes": int(exp.population_tensor_bytes()),
            "t_round": float(result.t_round),
            "mean_returned": float(np.mean(result.n_ret)),
        }
        if on_card:
            # the rung's peak device memory (setup and rounds), and that
            # peak above what was allocated before the rung
            peak = int(torch.cuda.max_memory_allocated(dev))
            entry["device_max_allocated_bytes"] = peak
            entry["device_peak_bytes"] = peak - resident
        entries.append(entry)
    return {
        "shapes": {"l": int(l), "q": int(q), "c": int(c)},
        "ns": [int(n) for n in ns],
        "entries": entries,
        "identity": _identity_check(l, q, c, rounds=3, seed=seed,
                                    device=dev),
    }


def validate_scale(section, *,
                   required_ns: Sequence[int] = REQUIRED_NS) -> list[str]:
    """Structural check of the ``scale`` section (empty list == valid).

    Enforces: the n ladder covers ``required_ns``; every entry's timings
    are positive finite; the memory contract holds (peak transient
    client-tensor bytes no larger than the dense tensor, and strictly
    sub-dense from the 1e4 rung up); and the routing identity flags are
    True.
    """
    errs: list[str] = []
    if not isinstance(section, dict):
        return [f"scale: must be an object, got {type(section).__name__}"]
    entries = section.get("entries")
    if not isinstance(entries, list) or not entries:
        return ["scale: missing/empty 'entries'"]
    by_n = {}
    for i, entry in enumerate(entries):
        if not isinstance(entry, dict) or not isinstance(
                entry.get("n"), int):
            errs.append(f"scale/entries[{i}]: malformed entry")
            continue
        by_n[entry["n"]] = entry
    missing = [n for n in required_ns if n not in by_n]
    if missing:
        errs.append(f"scale: required population rung(s) absent {missing} "
                    f"(have {sorted(by_n)})")
    for n, entry in sorted(by_n.items()):
        for field in ("setup_seconds", "round_seconds", "wall_seconds",
                      "trace_seconds"):
            val = entry.get(field)
            if not isinstance(val, (int, float)) or not np.isfinite(val) \
                    or val <= 0:
                errs.append(f"scale/n={n}/{field}: bad value {val!r}")
        for field in ("shards", "rounds", "peak_client_tensor_bytes",
                      "dense_client_tensor_bytes",
                      "population_tensor_bytes"):
            val = entry.get(field)
            if not isinstance(val, int) or val < 1:
                errs.append(f"scale/n={n}/{field}: bad value {val!r}")
        peak = entry.get("peak_client_tensor_bytes")
        dense = entry.get("dense_client_tensor_bytes")
        if isinstance(peak, int) and isinstance(dense, int):
            if peak > dense:
                errs.append(f"scale/n={n}: peak client tensor {peak} "
                            f"exceeds the dense tensor {dense}")
            if n >= 10_000 and peak * 2 > dense:
                errs.append(
                    f"scale/n={n}: peak client tensor {peak} is not "
                    f"sub-dense (dense {dense}) — the O(active cohort) "
                    "memory contract is broken")
        frac = entry.get("sample_fraction")
        if not isinstance(frac, (int, float)) or not 0.0 < frac <= 1.0:
            errs.append(f"scale/n={n}/sample_fraction: bad value {frac!r}")
    identity = section.get("identity")
    if not isinstance(identity, dict):
        errs.append("scale: missing 'identity' routing check")
    else:
        for flag in ("routes_flat_engine", "bit_identical"):
            if identity.get(flag) is not True:
                errs.append(f"scale/identity/{flag}: expected True, got "
                            f"{identity.get(flag)!r}")
    return errs

