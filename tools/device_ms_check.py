"""chip_smoke.py's device_ms (CUDA events behind a spin kernel) beside
time_ms (CUDA events, host gaps included) and the profiler's sum
(device_kernels_ms), on a one-microsecond kernel and a 4096^3 float32
matmul, before and after one profiled window of 40,000 kernels.  One JSON
line each; about 20 s; needs one NVIDIA GPU:

    python tools/device_ms_check.py
"""
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from torch.profiler import ProfilerActivity, profile

dev = torch.device("cuda", 0)
x = torch.ones(1 << 16, device=dev)
a = torch.randn(4096, 4096, device=dev)
fns = {"mul_": lambda: x.mul_(1.0000001), "mm4096": lambda: a @ a}
def row(tag):
    for k, f in fns.items():
        t0 = time.perf_counter()
        print(json.dumps({"tag": tag, "fn": k, "device_ms": cs.device_ms(torch, f, 10),
                          "events_ms": cs.time_ms(torch, f, 10),
                          "profiler": sum(cs.device_kernels_ms(torch, f, 10).values()),
                          "s": time.perf_counter() - t0}), flush=True)
row("before")
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    for _ in range(40000):
        x.mul_(1.0000001)
    torch.cuda.synchronize()
del prof
row("after_heavy")
