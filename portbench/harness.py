"""One run of one cell: set-up, the measured window, the check of what the
window produced against the plain reference, and the result line.

Everything that belongs to one cell is found by name: the cell in
``BENCHMARK.json`` (its configuration and traffic), the configuration in
``configs/<config>.json``, the program it runs in
``programs/<program>.py`` (the configuration's ``"program"``), the traffic
mix in ``traffic/<traffic>.json``, the limits of the check in
``limits/<cell>.json`` and each per-layer metric's reader in
``metrics/<metric>.py``.  A new cell, configuration, program or metric is
new files and entries; this module stays as it is.

The run is the same for every program (``Program``): the program builds
itself from the seed, ``WARMUP_BLOCKS`` blocks warm it, and the window
times each block from its call until the device is synchronized, until
``--seconds`` have passed.  A block's units of work are what
``rounds_per_s`` counts.  Then the program checks what it produced.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
import types
from pathlib import Path
from typing import Protocol

import torch

from portbench import trace as tr

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


class NoProgram(ImportError):
    """The configuration names no program, or one with no module."""


class Program(Protocol):
    """What ``programs/<program>.py`` hands the run.  The module has
    ``build(cfg, traffic, seed, dev, *, traced, checked) -> Program``,
    which makes the inputs from the seed and builds the program through
    the port's own entry (its set-up spans collected where `traced`; the
    theta of `checked` runs kept for the check), and ``control(cfg,
    traffic, seed, dev, *, checked) -> {name: value}``, the check's numbers
    with the plain reference one precision below in the program's place."""

    #: {wrapper: {"records": [...], "launch_record": name}} of the
    #: program's hand-written kernels (``work/kernels.json``'s form), {}
    #: where it runs library kernels only
    kernels: dict
    #: the module whose wrappers launch those kernels, for
    #: ``trace.event_times`` (None where there are none)
    ops: object

    def turn(self) -> None:
        """The program's own work between blocks, outside a block's time
        but inside the window."""

    def block(self) -> int:
        """Run one block; returns the units of work it did."""

    def launches(self) -> dict:
        """{wrapper: launches so far} of ``kernels``."""

    def check(self, log) -> tuple[dict, int]:
        """Free the program's device state, then check what it produced:
        ({name: value} by the names in ``limits/<cell>.json``, the units of
        work that failed)."""

    def fields(self, window: tuple, stretch) -> dict:
        """The program's fields of the readers' context, after ``check``,
        such as its set-up spans (``spans``, {name: seconds}): `window` is
        (first block, blocks) of the window, `stretch` the traced stretch
        (its ``first_block`` and ``blocks``) or None."""


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str) -> dict:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    return cells[name]


def cell_parts(bench: dict, name: str, base: Path = HERE) -> tuple:
    """(cell, configuration, traffic, limits, program module) of the cell
    `name`, each from its own file."""
    cell = find_cell(bench, name)
    cfg_path = base / "configs" / f"{cell['config']}.json"
    cfg = load_json(cfg_path)
    module = load_program(cfg, base, cfg_path)
    traffic = load_json(base / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(base / "limits" / f"{name}.json")
    return cell, cfg, traffic, limits, module


def load_program(cfg: dict, base: Path = HERE,
                 cfg_path: Path | str = "the configuration"):
    """The module ``programs/<program>.py`` that the configuration `cfg`
    (read from `cfg_path`) names under ``"program"``."""
    name = cfg.get("program")
    if not name:
        raise NoProgram(f"{cfg_path} names no program: give it a "
                        f"\"program\" whose module is "
                        f"{base / 'programs'}/<program>.py")
    path = base / "programs" / f"{name}.py"
    if not path.is_file():
        raise NoProgram(f"{cfg_path} names the program {name!r}, and "
                        f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(
        f"portbench_program_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


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


def fp32_only() -> None:
    """Matrix products in float32 on the card, as the configurations state
    (PyTorch would otherwise be free to use TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def traced_stretch(program: Program, first: int, dev: torch.device,
                   log) -> dict:
    """Profile a stretch of blocks after the window, its first block the
    run's `first`, and read it (``trace.summarize``), with the source of
    its device times.

    The profiler on the card can drop device records, so each program
    kernel's records are counted against its launches over the same
    stretch.  Where some fall short, a shorter stretch is profiled; where
    the shortest still falls short, the kernels short of records are timed
    by CUDA events behind a spin kernel over a stretch of their own
    (``trace.event_times``), and their event times stand in the profiled
    stretch's kernel and busy times for the records it kept."""
    def step() -> None:
        program.turn()
        program.block()

    for n in STRETCH_BLOCKS:
        before = program.launches()
        sync(dev)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(tr.STRETCH):
                for _ in range(n):
                    step()
                sync(dev)
        launches = {k: v - before[k] for k, v in program.launches().items()}
        st = tr.summarize(tr.read_events(prof, ROOT / "build" / "portbench"
                                         / "trace.json"), program.kernels,
                          launches)
        st.update(first_block=first, blocks=n, source="torch.profiler")
        first += n
        short = tr.short_records(st)
        log(f"stretch: {n} blocks, kernel records {st['records']} against "
            f"launches { {k: v for k, v in launches.items() if v} }")
        if not short:
            break
    if short:
        per_launch = tr.event_times(
            program.ops, sorted(short),
            lambda: [step() for _ in range(STRETCH_BLOCKS[0])])
        st = tr.with_event_times(st, per_launch)
        st["source"] = (f"torch.profiler; {sorted(per_launch)} by CUDA "
                        f"events behind a spin kernel")
    log(f"stretch: device time from {st['source']}; busy "
        f"{st['busy_s']:.6f} of {st['window_s']:.6f} s; kernel seconds "
        f"for {sorted(st['kernel_s'])}")
    return st


# ---------------------------------------------------------------- the check
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
    cell, cfg, traffic, limits, module = cell_parts(bench, name, base)
    check_device(device, int(cell["chips"]))
    dev = torch.device(device)
    fp32_only()

    program = module.build(cfg, traffic, seed, dev, traced=traced,
                           checked=CHECKED_RUNS)
    for _ in range(WARMUP_BLOCKS):
        program.turn()
        program.block()
    sync(dev)
    setup_s = time.perf_counter() - t_start

    block_s, done = [], 0
    t0 = time.perf_counter()
    while True:
        program.turn()
        tb = time.perf_counter()
        done += program.block()
        sync(dev)
        te = time.perf_counter()
        block_s.append(te - tb)
        if te - t0 >= seconds:
            break
    window_s = te - t0
    window_blocks = len(block_s)
    log(f"window: {window_blocks} blocks, {done} units of work in "
        f"{window_s:.3f} s; set-up {setup_s:.3f} s")

    stretch = None
    if traced:
        stretch = traced_stretch(program, WARMUP_BLOCKS + window_blocks, dev,
                                 log)

    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    numbers, failed = program.check(log)
    correct, checks = verdict(numbers, limits)

    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, cell=cell, spans={}, window_s=window_s,
        block_s=block_s, window_rounds=done, stretch=stretch,
        setup_s=setup_s, peaks=load_json(base / "work" / "peaks.json"))
    vars(ctx).update(program.fields((WARMUP_BLOCKS, window_blocks), stretch))
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
           "failed": int(failed), "metrics": metrics, "device": device_info}
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
    """The cell's numbers with the plain reference one precision below in
    the program's place (the program module's ``control``), over its first
    ``CHECKED_RUNS`` runs.  Returns (correct, checks): the control has to
    come out not correct."""
    cell, cfg, traffic, limits, module = cell_parts(bench, name, base)
    check_device(device, int(cell["chips"]))
    fp32_only()
    numbers = module.control(cfg, traffic, seed, torch.device(device),
                             checked=CHECKED_RUNS)
    return verdict(numbers, limits)
