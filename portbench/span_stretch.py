"""The span stretch of a traced run: the device's idle time charged to the
program's own spans of the round loop.

The program (``repro_torch.obs.spans``) opens a ``torch.profiler``
range for each span it measures, so inside a profiled stretch every span
is a ``user_annotation`` event on the clock of the device records.  Each
idle microsecond of the stretch (the gaps between device records, as
``trace.summarize`` finds them) is charged to the innermost program span
under way at that microsecond, and to ``(caller)`` where none is: a gap
that spans a readback, the caller's code, the next block's draw and its
uploads is split among them by overlap.

The harness's own stretch runs with spans off, so its device metrics read
the program as it runs untraced.  This stretch runs with them on, after
the run's check, on a deployment built anew from the run's ``--seed``
(the harness keeps no deployment past its check): ``WARMUP_BLOCKS``
blocks, then ``STRETCH_BLOCKS`` profiled blocks under
``spans.collecting()``, the longest first, a stretch whose kernel records
fall short of the launches profiled again, shorter.  Where even the
shortest falls short, the idle split is left out (a stderr line says so);
the span counts and host times are read all the same.  The metric
readers ``metrics/idle_ms.*.py`` and ``metrics/round_loop.*_per_block.py``
and ``round_loop.step_host_us.py`` share one stretch a run (`read`).  A
run with no card, or a program without these spans, reads nothing.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import gen, harness
from portbench import trace as tr

#: the program's spans of the round loop, outermost first
PROGRAM_SPANS = ("run/init", "run/finish", "block/run", "scan/compile",
                 "scan/execute", "block/draw", "block/upload", "round/step",
                 "block/readback")
#: idle time under no program span
CALLER = "(caller)"
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


def idle_intervals(events: list) -> list:
    """The stretch's idle intervals [a, b) in microseconds: the stretch
    annotation less its device records, as ``trace.summarize`` finds
    them."""
    (win,) = [e for e in events
              if e["name"] == tr.STRETCH and e.get("cat") == "user_annotation"]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = [e for e in events if e.get("cat") in tr.DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = tr._merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                      for e in dev])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def idle_by_span(events: list, names) -> dict:
    """Seconds of the stretch's idle time charged to each span of `names`
    (host ``user_annotation`` events of those names) and to `CALLER`:
    each idle microsecond to the innermost such span under way then (the
    one that started last), split exactly by overlap.  The parts add up to
    the stretch's idle time."""
    idle = idle_intervals(events)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"] in names)
    out = dict.fromkeys(names, 0.0)
    out[CALLER] = 0.0
    edges = sorted({x for ab in idle for x in ab}
                   | {x for s in spans for x in s[:2]})
    active, i, j = [], 0, 0
    for x0, x1 in zip(edges, edges[1:]):
        while i < len(spans) and spans[i][0] <= x0:
            active.append(spans[i])
            i += 1
        active = [s for s in active if s[1] > x0]
        while j < len(idle) and idle[j][1] <= x0:
            j += 1
        # the edges hold every idle edge: a segment is idle whole or not
        if j < len(idle) and idle[j][0] <= x0:
            who = (max(active, key=lambda s: (s[0], -s[1]))[2] if active
                   else CALLER)
            out[who] += x1 - x0
    return {k: v * 1e-6 for k, v in out.items()}


def run_seed() -> int:
    """The ``--seed`` this process was started with (``run.py``)."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def measure(cfg: dict, traffic: dict, seed: int, dev: torch.device,
            kernels: dict, log) -> dict:
    """Build the deployment from `seed`, warm it, and profile a stretch of
    its blocks with the program's spans on.  Returns its blocks,
    ``window_s``, ``busy_s``, the span ``totals`` and ``idle_by_span``
    (None where the kernel records fell short)."""
    from repro_torch.kernels import ops
    from repro_torch.obs import spans

    inp = gen.make_inputs(cfg, traffic, seed, dev)
    exp = harness.build_program(cfg, traffic, inp, dev)
    runs = harness.Runs(exp, int(cfg["rounds"]), int(traffic["realizations"]),
                        int(traffic["block_rounds"]), seed, 1)
    for _ in range(harness.WARMUP_BLOCKS):
        runs.turn()
        runs.block()
    for n in harness.STRETCH_BLOCKS:
        before = dict(ops.LAUNCHES)
        harness.sync(dev)
        with spans.collecting():
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function(tr.STRETCH):
                    for _ in range(n):
                        runs.turn()
                        runs.block()
                    harness.sync(dev)
            totals = spans.totals()
        launches = {k: ops.LAUNCHES[k] - before[k] for k in before}
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
        out["idle_by_span"] = idle_by_span(events, PROGRAM_SPANS)
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
            kernels = json.loads((harness.HERE / "work"
                                  / "kernels.json").read_text())
            got = measure(ctx.cfg, ctx.traffic, run_seed(),
                          torch.device("cuda"), kernels, log)
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
