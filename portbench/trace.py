"""Reading a profiled stretch of the window: device busy time, kernel time
by the program's kernel names, and the breakdown of device operations and
of idle gaps by what the host was doing.

The stretch runs under ``torch.profiler`` (CPU and CUDA) inside one
``portbench/stretch`` annotation; its Chrome trace is read back and
deleted.  The profiler on the card can drop device records (more of them
the longer a process has profiled), so the records of each of the
program's kernels are counted against the program's own launch counter
(``ops.LAUNCHES``) over the same stretch (``short_records``).  A kernel
whose records fall short is timed instead by CUDA events behind a spin
kernel (``event_times``), and that time stands in for its records in the
stretch's kernel and busy seconds (``with_event_times``).  The stretch's
idle intervals, the gaps between its device records, can also be charged
to the host spans under way in them (``idle_by_span``).
"""
from __future__ import annotations

import heapq
import json
import os
import re
import time
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STRETCH = "portbench/stretch"
#: ``idle_by_span``'s name for idle time under none of the spans it charges
CALLER = "(caller)"
#: event_times' first spin (~1 ms at the H100's SM clock) and its tries,
#: the spin four times longer at each
SPIN_CYCLES = 1 << 21
SPIN_TRIES = 4
_IDENT = re.compile(r"(\w+)\s*[<(]")


def kernel_ident(name: str) -> str:
    """The function name of a device record ("void masked_kernel<1, 2>(A)"
    -> "masked_kernel")."""
    m = _IDENT.search(name.removeprefix("void "))
    return m.group(1) if m else name


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost_host(events: list, times: list) -> list:
    """For each of the increasing `times`, the name of the shortest host
    event running then (a sweep over the events by start time)."""
    host = sorted((e for e in events if e.get("cat") in HOST_CATS),
                  key=lambda e: e["ts"])
    active, out, i = [], [], 0
    for t in times:
        while i < len(host) and host[i]["ts"] <= t:
            e = host[i]
            heapq.heappush(active, (e["dur"], e["ts"] + e["dur"], i,
                                    e["name"]))
            i += 1
        while active and active[0][1] < t:
            heapq.heappop(active)
        out.append(active[0][3] if active else "(no host event)")
    return out


def _stretch(events: list) -> tuple:
    """(the stretch annotation, the device records that overlap it, their
    busy intervals [a, b) within it, merged)."""
    (win,) = [e for e in events
              if e["name"] == STRETCH and e.get("cat") == "user_annotation"]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                   for e in dev])
    return win, dev, busy


def _gaps(win: dict, busy: list) -> list:
    """The idle intervals [a, b) of the stretch `win`: it less `busy`."""
    edges = [win["ts"]] + [x for ab in busy for x in ab] \
        + [win["ts"] + win["dur"]]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def idle_intervals(events: list) -> list:
    """The stretch's idle intervals [a, b) in microseconds: the stretch
    annotation less its device records, as ``summarize`` finds them."""
    win, _, busy = _stretch(events)
    return _gaps(win, busy)


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


def read_events(prof, path: Path) -> list:
    """The profile's complete events, through its Chrome trace at `path`
    with this process's id in its name (deleted after), so processes that
    share a checkout write apart."""
    path = path.with_name(f"{path.stem}.{os.getpid()}{path.suffix}")
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        data = json.loads(path.read_text())
    finally:
        os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def summarize(events: list, kernels: dict, launches: dict,
              top: int = 10) -> dict:
    """Device busy and window seconds of the stretch, each program kernel's
    device seconds and record counts, and the breakdown.

    `kernels`: {wrapper: {"records": [function names], "launch_record":
    name}} (``work/kernels.json``); `launches`: {wrapper: launches in the
    stretch}.  A wrapper's seconds are given only where its launch records
    number its launches."""
    win, dev, busy = _stretch(events)
    busy_us = sum(b - a for a, b in busy)

    by_name = defaultdict(float)
    by_ident = defaultdict(float)
    count_ident = defaultdict(int)
    for e in dev:
        by_name[e["name"][:120]] += e["dur"]
        ident = kernel_ident(e["name"])
        by_ident[ident] += e["dur"]
        count_ident[ident] += 1
    kernel_s, records, recorded_s = {}, {}, {}
    for wrapper, spec in kernels.items():
        n_rec = count_ident.get(spec["launch_record"], 0)
        records[wrapper] = n_rec
        recorded_s[wrapper] = sum(by_ident.get(r, 0.0)
                                  for r in spec["records"]) * 1e-6
        n_launch = launches.get(wrapper, 0)
        if n_launch and n_rec == n_launch:
            kernel_s[wrapper] = recorded_s[wrapper]

    idle = _gaps(win, busy)
    gaps = defaultdict(float)
    for (a, b), what in zip(idle, _innermost_host(
            events, [0.5 * (a + b) for a, b in idle])):
        gaps[what[:120]] += (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": win["dur"] * 1e-6,
        "kernel_s": kernel_s,
        "records": records,
        "recorded_s": recorded_s,
        "launches": dict(launches),
        "breakdown": {
            "device_ops": [[k, v * 1e-6] for k, v in ops],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:top],
        },
    }


def short_records(stretch: dict) -> dict:
    """{kernel: (records, launches)} of the kernels launched in the
    stretch whose records the profiler did not keep in full."""
    return {k: (stretch["records"].get(k, 0), n)
            for k, n in stretch["launches"].items()
            if n and k in stretch["records"] and stretch["records"][k] != n}


def event_times(module, names: list, fn) -> dict:
    """Seconds of device time a launch of each of `module`'s kernel wrappers
    `names`, over what ``fn()`` launches: every call enqueued behind a spin
    kernel that holds the stream while the host enqueues it, between two
    CUDA events (a copy of ``chip_smoke.device_ms``, per call).  The spin's
    own events show that it outlasted the enqueue; where one did not, `fn`
    runs again with the spin four times longer."""
    import torch

    cycles = SPIN_CYCLES
    for _ in range(SPIN_TRIES):
        calls = {k: [] for k in names}
        originals = {k: getattr(module, k) for k in names}

        def timed(k, f):
            def call(*args, **kwargs):
                spin, start, end = (torch.cuda.Event(enable_timing=True)
                                    for _ in range(3))
                t0 = time.perf_counter()
                spin.record()
                torch.cuda._sleep(cycles)
                start.record()
                out = f(*args, **kwargs)
                end.record()
                calls[k].append((spin, start, end,
                                 (time.perf_counter() - t0) * 1e3))
                return out
            return call

        try:
            for k, f in originals.items():
                setattr(module, k, timed(k, f))
            fn()
        finally:
            for k, f in originals.items():
                setattr(module, k, f)
        torch.cuda.synchronize()
        if all(spin.elapsed_time(start) > enqueue_ms
               for c in calls.values() for spin, start, _, enqueue_ms in c):
            return {k: sum(s.elapsed_time(e) for _, s, e, _ in c) * 1e-3
                    / len(c) for k, c in calls.items() if c}
        cycles *= 4
    raise RuntimeError("event_times: the spin never outlasted the host's "
                       "enqueue of a call")


def with_event_times(stretch: dict, per_launch: dict) -> dict:
    """The stretch with the kernels of `per_launch` (seconds a launch) timed
    by their launches in it: their kernel seconds, and the busy seconds
    with their event time in place of the records kept."""
    out = dict(stretch, kernel_s=dict(stretch["kernel_s"]))
    for k, t in per_launch.items():
        total = t * stretch["launches"][k]
        out["kernel_s"][k] = total
        out["busy_s"] += total - stretch["recorded_s"][k]
    return out
