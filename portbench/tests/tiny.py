"""A tiny copy of the benchmark for the CPU tests: the real metric
readers, program modules, work counts and limits, with configurations cut
to a size a test run holds (d 16, q 64, l 20, 6 clients, runs of 20
rounds) and one cell of each kind, in which every metric is read.  The
program runs the plain versions of its kernels there."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench import harness

#: tiny cell -> (configuration, traffic, the real cell whose limits it takes)
CELLS = {
    "tiny-raw.coded": ("tiny-raw", "coded", "mnist-rff-raw.coded"),
    "tiny.coded": ("tiny", "coded", "mnist-rff.coded-n150"),
    "tiny-raw.mc3": ("tiny-raw", "mc3", "mnist-rff-raw.coded-mc8"),
    "tiny-raw.naive": ("tiny-raw", "naive", "mnist-rff-raw.naive"),
}
SIZES = dict(d=16, q=64, l=20, rounds=20, lr_decay_rounds=[11, 16])
TRAFFIC = {"coded": ("coded", 1), "mc3": ("coded", 3), "naive": ("naive", 1)}


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def make_base(tmp: Path) -> tuple[Path, dict]:
    """(base directory, benchmark dict) of the tiny copy under `tmp`."""
    real = harness.HERE
    base = tmp / "bench"
    for sub in ("metrics", "work", "programs"):
        shutil.copytree(real / sub, base / sub)
    for sub in ("configs", "traffic", "limits"):
        (base / sub).mkdir(parents=True)
    for name, fused in (("tiny-raw", True), ("tiny", False)):
        cfg = harness.load_json(real / "configs" / "mnist-rff-raw.json")
        cfg.update(SIZES, name=name, fused_embed=fused)
        write_json(base / "configs" / f"{name}.json", cfg)
    for name, (scheme, R) in TRAFFIC.items():
        write_json(base / "traffic" / f"{name}.json",
                   {"scheme": scheme, "n_clients": 6, "realizations": R,
                    "block_rounds": 5})
    bench = json.loads((real.parent / "BENCHMARK.json").read_text())
    bench["workloads"] = []
    for cell, (config, traffic, like) in CELLS.items():
        shutil.copy(real / "limits" / f"{like}.json",
                    base / "limits" / f"{cell}.json")
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "a CPU test"})
    for metric in bench["end_to_end"] + bench["per_layer"]:
        metric.pop("workloads", None)
    return base, bench
