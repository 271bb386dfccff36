"""The span stretch of a traced run: the device's idle time charged to the
program's own spans of the round loop.

The program (``repro_torch.obs.spans``) opens a ``torch.profiler``
range for each span it measures, so inside a profiled stretch every span
is a ``user_annotation`` event on the clock of the device records.  Each
idle microsecond of the stretch (the gaps between device records, as
``trace.summarize`` finds them) is charged to the innermost program span
under way at that microsecond, and to ``(caller)`` where none is: a gap
that spans a readback, the caller's code, the next block's draw and its
uploads is split among them by overlap (``trace.idle_by_span``).

The harness's own stretch runs with spans off, so its device metrics read
the program as it runs untraced.  This stretch runs with them on, after
the run's check, on a deployment built anew from the run's ``--seed`` by
the configuration's program module (the harness keeps no deployment past
its check): ``WARMUP_BLOCKS`` blocks, then ``STRETCH_BLOCKS`` profiled
blocks under ``spans.collecting()``, the longest first, a stretch whose
kernel records fall short of the launches profiled again, shorter.  Where even the
shortest falls short, the idle split is left out (a stderr line says so);
the span counts and host times are read all the same.  The metric
readers ``metrics/idle_ms.*.py`` and ``metrics/round_loop.*_per_block.py``
and ``round_loop.step_host_us.py`` share one stretch a run (`read`).  A
run with no card, or a program without these spans, reads nothing.
"""
from __future__ import annotations

import argparse
import sys

import torch

from portbench import harness
from portbench import trace as tr
from portbench.trace import CALLER

#: the program's spans of the round loop, outermost first
PROGRAM_SPANS = ("run/init", "run/finish", "block/run", "scan/compile",
                 "scan/execute", "block/draw", "block/upload", "round/step",
                 "block/readback")
#: idle_ms.<part> -> what it sums; the outer spans' own idle time is the
#: part no inner span covered (their self time)
PARTS = {
    "draw": ("block/draw",),
    "upload": ("block/upload",),
    "dispatch": ("round/step", "scan/compile", "scan/execute"),
    "readback": ("block/readback",),
    "other_spans": ("block/run", "run/init", "run/finish"),
    "caller": (CALLER,),
}
#: the seed where the process was not started with ``--seed``
DEFAULT_SEED = 0


def run_seed() -> int:
    """The ``--seed`` this process was started with (``run.py``)."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def measure(cfg: dict, traffic: dict, seed: int, dev: torch.device,
            kernels, log) -> dict:
    """Build the configuration's program from `seed` (its module under
    ``programs/``), warm it, and profile a stretch of its blocks with the
    program's spans on.  `kernels`: the kernel records to count
    (``work/kernels.json``'s form), None for the program's own.  Returns
    its blocks, ``window_s``, ``busy_s``, the span ``totals`` and
    ``idle_by_span`` (None where the kernel records fell short)."""
    from repro_torch.obs import spans

    prog = harness.load_program(cfg).build(cfg, traffic, seed, dev,
                                           traced=False, checked=1)
    kernels = prog.kernels if kernels is None else kernels
    for _ in range(harness.WARMUP_BLOCKS):
        prog.turn()
        prog.block()
    for n in harness.STRETCH_BLOCKS:
        before = prog.launches()
        harness.sync(dev)
        with spans.collecting():
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(tr.STRETCH):
                    for _ in range(n):
                        prog.turn()
                        prog.block()
                    harness.sync(dev)
            totals = spans.totals()
        launches = {k: v - before[k] for k, v in prog.launches().items()}
        events = tr.read_events(prof, harness.ROOT / "build" / "portbench"
                                / "span_trace.json")
        st = tr.summarize(events, kernels, launches)
        short = tr.short_records(st)
        log(f"span stretch: {n} blocks, kernel records {st['records']} "
            f"against launches { {k: v for k, v in launches.items() if v} }")
        if not short:
            break
    out = {"blocks": n, "window_s": st["window_s"], "busy_s": st["busy_s"],
           "totals": totals, "idle_by_span": None}
    if short:
        log(f"span stretch: kernel records short of launches {short} even "
            f"over {n} block: the idle_ms metrics are left out")
    else:
        out["idle_by_span"] = tr.idle_by_span(events, PROGRAM_SPANS)
        idle = st["window_s"] - st["busy_s"]
        parts = sum(out["idle_by_span"].values())
        log(f"span stretch: busy {st['busy_s']:.6f} of {st['window_s']:.6f}"
            f" s; the parts of the idle time add up to {parts:.6f} s "
            f"(relative gap {abs(parts - idle) / max(idle, 1e-12):.1e}): "
            f"{ {k: round(v, 6) for k, v in out['idle_by_span'].items()} }")
    return out


def read(ctx):
    """The run's span stretch (``ctx.span_stretch``), measured at the first
    call: None where the harness's stretch saw no device record (no card)
    or the program has no round-loop spans."""
    if not hasattr(ctx, "span_stretch"):
        ctx.span_stretch = None
        st = ctx.stretch
        if st is not None and st["breakdown"]["device_ops"]:
            def log(msg):
                print(msg, file=sys.stderr, flush=True)
            got = measure(ctx.cfg, ctx.traffic, run_seed(),
                          torch.device("cuda"), None, log)
            if "block/run" in got["totals"]:
                ctx.span_stretch = got
            else:
                log("span stretch: the program records no round-loop spans")
            torch.cuda.empty_cache()
    return ctx.span_stretch


def idle_ms(ctx, part: str):
    """Milliseconds a block of the span stretch's idle time charged to
    `part` (a key of `PARTS`)."""
    st = read(ctx)
    if st is None or st["idle_by_span"] is None:
        return None
    return 1e3 * sum(st["idle_by_span"][k] for k in PARTS[part]) \
        / st["blocks"]


def per_block(ctx, name: str):
    """Spans `name` a block of the span stretch."""
    st = read(ctx)
    if st is None:
        return None
    return st["totals"].get(name, {"count": 0})["count"] / st["blocks"]


def mean_us(ctx, name: str):
    """Mean host microseconds of one span `name` in the span stretch."""
    st = read(ctx)
    if st is None or name not in st["totals"]:
        return None
    rec = st["totals"][name]
    return 1e6 * rec["total_s"] / rec["count"]
