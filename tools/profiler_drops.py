"""How many of a short window's device records torch.profiler keeps over a
long-lived process on the card, before and after one window of 40,000
kernels.

Every ~20 s for 6 samples, then after the large window for 6 more, it
profiles (CPU + CUDA) 10 launches of a one-microsecond kernel, 1 launch,
and 10 launches padded by 50 ms of host sleep on both sides, and prints
one JSON line: the device time each window kept (us; 10 launches are
~11.3 us when every record is kept) and, for the padded window, the
launch-to-kernel offsets (min, max, count) from its Chrome trace.  About
4.5 minutes; needs one NVIDIA GPU:

    python tools/profiler_drops.py
"""
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

dev = torch.device("cuda", 0)
x = torch.ones(1 << 16, device=dev)
t_start = time.perf_counter()
os.makedirs("build", exist_ok=True)


def short_window(reps=10, pad=0.0):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(reps):
            x.mul_(1.0000001)
        torch.cuda.synchronize()
        time.sleep(pad)
    return sum(e.device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA), prof


def offsets(prof, tag):
    path = f"build/trace_{tag}.json"
    prof.export_chrome_trace(path)
    with open(path) as f:
        tr = json.load(f)
    evs = tr["traceEvents"] if isinstance(tr, dict) else tr
    launch, kern = {}, {}
    for e in evs:
        a = e.get("args", {})
        c = a.get("correlation")
        if c is None:
            continue
        if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", ""):
            launch[c] = e["ts"]
        elif e.get("cat") == "kernel":
            kern[c] = e["ts"]
    d = [kern[c] - launch[c] for c in kern if c in launch]
    os.remove(path)
    return (min(d), max(d), len(d)) if d else None


def sample(tag):
    t = time.perf_counter() - t_start
    s0, _ = short_window(10, 0.0)
    s1, _ = short_window(1, 0.0)
    s2, p2 = short_window(10, 0.05)
    print(json.dumps({"t": round(t, 1), "tag": tag, "short10_us": s0,
                      "short1_us": s1, "padded_us": s2,
                      "offset_us": offsets(p2, tag)}), flush=True)


for i in range(6):
    sample(f"a{i}")
    time.sleep(20)
# a heavy trace: 40k small kernels in one window, CPU + CUDA
with profile(activities=[ProfilerActivity.CPU,
                         ProfilerActivity.CUDA]) as prof:
    for _ in range(40000):
        x.mul_(1.0000001)
    torch.cuda.synchronize()
n = sum(e.count for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA)
print(json.dumps({"heavy_device_events": n,
                  "t": time.perf_counter() - t_start}), flush=True)
del prof
for i in range(6):
    sample(f"b{i}")
    time.sleep(20)
