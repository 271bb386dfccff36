"""One run of one cell: set-up, the measured window, the check of what the
window produced against the plain reference, and the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json`` (its configuration and traffic), the configuration in
``configs/<config>.json``, the traffic mix in ``traffic/<traffic>.json``,
the limits of the check in ``limits/<cell>.json`` and each per-layer
metric's reader in ``metrics/<metric>.py``.  A new cell, configuration or
metric is new files and entries; this module stays as it is.

The window drives the program's own entry: ``build_experiment`` ->
``init_state(rounds, n_realizations=R)`` -> ``run_block(state, K)`` until
the run is done -> ``finish``, then the next run from theta = 0 on the
same deployment, its delay stream going on.  A block is timed from the
call of ``run_block`` until its state is on the host.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

from portbench import gen
from portbench import trace as tr
from portbench.reference import codedfedl as ref

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: blocks run before the window, to warm every shape it uses
WARMUP_BLOCKS = 2
#: runs of the window whose theta after every block is checked: run 0 and
#: a reservoir of the later runs drawn from the seed
CHECKED_RUNS = 3
#: blocks of the profiled stretch of a traced run, the longest first: a
#: stretch whose kernel records fall short of the launches is profiled
#: again, shorter
STRETCH_BLOCKS = (4, 1)


class NoChip(RuntimeError):
    """The run cannot be measured here: no card, or too few."""


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str) -> dict:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    return cells[name]


def cell_parts(bench: dict, name: str, base: Path = HERE) -> tuple:
    """(cell, configuration, traffic, limits) of the cell `name`, each from
    its own file."""
    cell = find_cell(bench, name)
    cfg = load_json(base / "configs" / f"{cell['config']}.json")
    traffic = load_json(base / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(base / "limits" / f"{name}.json")
    return cell, cfg, traffic, limits


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics the cell reports:
    those without a workloads list, and those that list it."""
    return [m for m in bench[kind]
            if name in m.get("workloads", [name])]


def load_reader(name: str, base: Path = HERE):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names=None) -> list:
    """Those of `names` (default: the loaded modules) whose top-level name
    is one of `FORBIDDEN`, compared whole (``repro_torch`` is not
    ``repro``)."""
    return sorted(k for k in list(sys.modules if names is None else names)
                  if k.split(".")[0] in FORBIDDEN)


def check_device(device: str, chips: int) -> None:
    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise NoChip("torch.cuda.is_available() is False")
    if torch.cuda.device_count() < chips:
        raise NoChip(f"the cell needs {chips} cards, "
                     f"torch.cuda.device_count() is "
                     f"{torch.cuda.device_count()}")


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------------------------ program
def build_program(cfg: dict, traffic: dict, inp, dev: torch.device):
    """The deployment through the program's entry, on the inputs made."""
    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.config import FLConfig, RFFConfig, TrainConfig
    from repro_torch.core import rff

    n, l, d = inp.x.shape
    fl = FLConfig(n_clients=n, delta=cfg["delta"], psi=cfg["psi"],
                  **cfg["network"])
    train = TrainConfig(learning_rate=inp.lr, l2_reg=cfg["l2_reg"],
                        lr_decay=cfg["lr_decay"],
                        lr_decay_epochs=tuple(cfg["lr_decay_rounds"]))
    spec = ExperimentSpec(fl=fl, train=train,
                          rff=RFFConfig(q=cfg["q"], sigma=cfg["sigma"]),
                          scheme=traffic["scheme"],
                          fused_embed=cfg["fused_embed"])
    kw = {}
    if cfg["fused_embed"]:
        xs = inp.x
        kw["rff_draw"] = (inp.omega, inp.delta)
    else:
        # the embedded deployment's clients hold phi(X): kernel 1
        xs = rff.rff_transform(inp.x.reshape(n * l, d), inp.omega,
                               inp.delta).reshape(n, l, cfg["q"])
    if inp.gens is not None:
        kw["parity_generators"] = inp.gens
    return build_experiment(spec, xs, inp.y,
                            rng=np.random.default_rng(inp.host_seed),
                            device=dev, **kw)


class Runs:
    """The runs the window drives on one deployment, and what each left:
    its blocks, its returned counts and wall clock, its skipped rounds,
    and theta after each block where the run is one of the checked."""

    def __init__(self, exp, rounds: int, R: int, K: int, seed: int,
                 checked: int):
        self.exp, self.rounds, self.R, self.K = exp, rounds, R, K
        self.pick = np.random.default_rng((int(seed), 7))
        self.checked = checked
        self.runs = []
        self.state = None
        self.blocks_done = 0
        self._start()

    def _start(self) -> None:
        i = len(self.runs)
        # run 0 always, then a reservoir of the later runs drawn from the
        # seed, so the runs checked are a sample of all the window's
        keep = i == 0
        if i > 0 and self.checked > 1:
            kept = [r for r in self.runs[1:] if r["thetas"] is not None]
            if len(kept) < self.checked - 1:
                keep = True
            elif self.pick.random() < (self.checked - 1) / i:
                kept[int(self.pick.integers(len(kept)))]["thetas"] = None
                keep = True
        self.runs.append({"blocks": 0, "thetas": [] if keep else None,
                          "n_ret": None, "wall": None, "skipped": None})
        self.state = self.exp.init_state(self.rounds, n_realizations=self.R)

    def turn(self) -> None:
        """Where the run is done, finish it and start the next one."""
        if self.state.done:
            res = self.exp.finish(self.state)
            self.runs[-1]["wall"] = np.asarray(res.wall_clock)
            self._start()

    def block(self) -> int:
        """Run one block of the current run; returns the realization-rounds
        it did."""
        before = self.state.rounds_done
        with torch.profiler.record_function("portbench/run_block"):
            self.state = self.exp.run_block(self.state, self.K)
        run = self.runs[-1]
        run["blocks"] += 1
        self.blocks_done += 1
        run["n_ret"] = np.asarray(self.state.n_ret)
        run["skipped"] = np.asarray(self.state.skipped)
        if run["thetas"] is not None:
            run["thetas"].append(self.state.theta)
        return (self.state.rounds_done - before) * self.R


def traced_stretch(runs: Runs, dev: torch.device, kernels: dict,
                   log) -> dict:
    """Profile a stretch of blocks after the window and read it
    (``trace.summarize``), with the source of its device times.

    The profiler on the card can drop device records, so each program
    kernel's records are counted against ``ops.LAUNCHES`` over the same
    stretch.  Where some fall short, a shorter stretch is profiled; where
    the shortest still falls short, the kernels short of records are timed
    by CUDA events behind a spin kernel over a stretch of their own
    (``trace.event_times``), and their event times stand in the profiled
    stretch's kernel and busy times for the records it kept."""
    from repro_torch.kernels import ops

    def step() -> None:
        runs.turn()
        runs.block()

    for n in STRETCH_BLOCKS:
        first, before = runs.blocks_done, dict(ops.LAUNCHES)
        sync(dev)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(tr.STRETCH):
                for _ in range(n):
                    step()
                sync(dev)
        launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
        st = tr.summarize(tr.read_events(prof, ROOT / "build" / "portbench"
                                         / "trace.json"), kernels, launches)
        st.update(first_block=first, blocks=n, source="torch.profiler")
        short = tr.short_records(st)
        log(f"stretch: {n} blocks, kernel records {st['records']} against "
            f"launches { {k: v for k, v in launches.items() if v} }")
        if not short:
            break
    if short:
        per_launch = tr.event_times(
            ops, sorted(short),
            lambda: [step() for _ in range(STRETCH_BLOCKS[0])])
        st = tr.with_event_times(st, per_launch)
        st["source"] = (f"torch.profiler; {sorted(per_launch)} by CUDA "
                        f"events behind a spin kernel")
    log(f"stretch: device time from {st['source']}; busy "
        f"{st['busy_s']:.6f} of {st['window_s']:.6f} s; kernel seconds "
        f"for {sorted(st['kernel_s'])}")
    return st


# ---------------------------------------------------------------- the check
def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    den = float(torch.linalg.vector_norm(b))
    gap = float(torch.linalg.vector_norm(a.float() - b))
    return gap / den if den > 0 else (0.0 if gap == 0 else math.inf)


def check(dep, program: dict, runs: list) -> tuple[dict, list]:
    """The numbers compared: the program's results against the reference
    deployment `dep`, which replays the same delay stream run by run.
    Returns ({name: value}, the (R, rounds) counted rows of each run)."""
    out = {"theta_gap": 0.0, "returned_diff": 0, "wall_gap": 0.0}
    rows = []
    if dep.scheme == "coded":
        out["t_star_gap"] = abs(program["t_star"] - dep.t_star) / dep.t_star
        out["loads_diff"] = int(np.max(np.abs(
            np.asarray(program["loads"]) - dep.loads)))
        out["parity_gap"] = max(_rel(program["parity_x"], dep.parity_x),
                                _rel(program["parity_y"], dep.parity_y))
    for run in runs:
        blocks = [dep.block_delays(min(dep.K, dep.rounds - k * dep.K))
                  for k in range(run["blocks"])]
        rows.append(dep.counted_rows(blocks))
        n_ret = dep.returned(blocks)
        out["returned_diff"] += int(np.sum(n_ret != run["n_ret"]))
        if run["wall"] is not None:
            wall = dep.wall_clock(blocks)
            out["wall_gap"] = max(out["wall_gap"], float(np.max(
                np.abs(run["wall"] - wall) / wall)))
        if run["thetas"]:
            for got, want in zip(run["thetas"], dep.trajectory(blocks)):
                for r in range(dep.R):
                    out["theta_gap"] = max(out["theta_gap"],
                                           _rel(got[r], want[r]))
    return out, rows


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


# ---------------------------------------------------------------- the run
def run(bench: dict, name: str, seed: int, seconds: float, traced: bool, *,
        device: str = "cuda", t_start: float | None = None,
        base: Path = HERE, log=None) -> dict:
    """One run of cell `name`; returns the result line's object."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    cell, cfg, traffic, limits = cell_parts(bench, name, base)
    check_device(device, int(cell["chips"]))
    dev = torch.device(device)
    ref.fp32_only()
    from repro_torch.obs import spans

    inp = gen.make_inputs(cfg, traffic, seed, dev)
    if traced:
        spans.enable()
        spans.reset()
    exp = build_program(cfg, traffic, inp, dev)
    span_totals = {k: v["total_s"] for k, v in spans.totals().items()}
    spans.disable()
    R, K = int(traffic["realizations"]), int(traffic["block_rounds"])
    runs = Runs(exp, int(cfg["rounds"]), R, K, seed, CHECKED_RUNS)
    for _ in range(WARMUP_BLOCKS):
        runs.turn()
        runs.block()
    sync(dev)
    setup_s = time.perf_counter() - t_start

    block_s, done = [], 0
    t0 = time.perf_counter()
    while True:
        runs.turn()
        tb = time.perf_counter()
        done += runs.block()
        sync(dev)
        te = time.perf_counter()
        block_s.append(te - tb)
        if te - t0 >= seconds:
            break
    window_s = te - t0
    window_blocks = len(block_s)
    log(f"window: {window_blocks} blocks, {done} realization-rounds in "
        f"{window_s:.3f} s; set-up {setup_s:.3f} s")

    stretch = None
    if traced:
        stretch = traced_stretch(runs, dev, load_json(base / "work"
                                                      / "kernels.json"), log)

    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    program = {"t_star": exp.t_star, "loads": np.array(exp.loads),
               "parity_x": None, "parity_y": None}
    if exp.parity is not None:
        program["parity_x"], program["parity_y"] = exp.parity.x, exp.parity.y
    skipped = sum(int(np.sum(r["skipped"])) for r in runs.runs)
    all_runs = runs.runs
    del exp, runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    dep = ref.Deployment(cfg, traffic, inp)
    numbers, rows = check(dep, program, all_runs)
    log(f"check: the reference took {time.perf_counter() - t_ref:.3f} s "
        f"over {len(all_runs)} runs, theta of "
        f"{sum(1 for r in all_runs if r['thetas'])}")
    correct, checks = verdict(numbers, limits)

    # the counted rows of each realization-round: the window's blocks, then
    # the stretch's, in run order
    flat = []
    for run_rows in rows:
        for b in range(0, run_rows.shape[1], K):
            flat.append(run_rows[:, b:b + K])
    stretch_rows = []
    if stretch is not None:
        first = stretch["first_block"]
        stretch_rows = flat[first:first + stretch["blocks"]]
    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, cell=cell, spans=span_totals,
        window_s=window_s, block_s=block_s, window_rounds=done,
        window_rows=flat[WARMUP_BLOCKS:WARMUP_BLOCKS + window_blocks],
        stretch_rows=stretch_rows, stretch=stretch, u=dep.u,
        setup_s=setup_s, peaks=load_json(base / "work" / "peaks.json"))
    metrics = {}
    for m in cell_metrics(bench, name,
                          "per_layer" if traced else "end_to_end"):
        value = load_reader(m["name"], base)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(done),
           "failed": int(skipped), "metrics": metrics, "device": device_info}
    if stretch is not None:
        device_info["busy_s"] = stretch["busy_s"]
        device_info["window_s"] = stretch["window_s"]
        out["breakdown"] = stretch["breakdown"]
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    out["checks"] = checks
    return out


# ---------------------------------------------------------------- control
def control(bench: dict, name: str, seed: int, *, device: str = "cuda",
            base: Path = HERE) -> tuple:
    """The cell's numbers with the reference in TF32 put in the program's
    place: its first ``CHECKED_RUNS`` runs of the same delay stream, held
    against the float32 reference as a run's are.  Returns (correct,
    checks): the control has to come out not correct."""
    cell, cfg, traffic, limits = cell_parts(bench, name, base)
    check_device(device, int(cell["chips"]))
    ref.fp32_only()
    inp = gen.make_inputs(cfg, traffic, seed, torch.device(device))
    ctl = ref.Deployment(cfg, traffic, inp, control=True)
    runs = []
    for _ in range(CHECKED_RUNS):
        blocks = ctl.run_blocks()
        runs.append({"blocks": len(blocks), "thetas": ctl.trajectory(blocks),
                     "n_ret": ctl.returned(blocks),
                     "wall": ctl.wall_clock(blocks)})
    program = {"t_star": ctl.t_star, "loads": ctl.loads,
               "parity_x": ctl.parity_x, "parity_y": ctl.parity_y}
    numbers, _ = check(ref.Deployment(cfg, traffic, inp), program, runs)
    return verdict(numbers, limits)
