"""A configuration names the program it runs: a second program
(``toy_program.py``, least squares over federated rounds with stragglers)
added to a copy of the benchmark as new files and entries alone, run by
the harness as it stands, on the CPU."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

SEED = 2**31 + 12289
TOY = harness.HERE / "tests" / "toy_program.py"
LAST_KEYS = ["correct", "attempted", "failed", "metrics", "device",
             "checks"]
#: modules a toy run must not load: CodedFedL's inputs, reference and
#: entry, and the port
CODEDFEDL = ("portbench.gen", "portbench.reference", "repro_torch")


def add_toy(base, bench: dict) -> dict:
    """The toy program, and one broken underneath (theta perturbed after
    every block), as new files and entries of the copy at `base`: a
    program module, a configuration, a traffic mix, limits, cells and a
    per-layer metric with its reader."""
    bench = json.loads(json.dumps(bench))
    source = TOY.read_text()
    (base / "programs" / "toy.py").write_text(source)
    (base / "programs" / "toy_broken.py").write_text(
        source + "\nPERTURB = 1e-3\n")
    for name, program in (("toy", "toy"), ("toy-broken", "toy_broken"),
                          ("toy-none", None), ("toy-nosuch", "nosuch")):
        cfg = {"name": name, "d": 8, "l": 16, "lr": 0.05, "noise": 0.1,
               "p_min": 0.5, "program": program}
        if program is None:
            del cfg["program"]
        tiny.write_json(base / "configs" / f"{name}.json", cfg)
        tiny.write_json(base / "limits" / f"{name}.toy.json",
                        {"theta_gap": 1e-4, "returned_diff": 0})
        bench["workloads"].append({"name": f"{name}.toy", "config": name,
                                   "traffic": "toy", "chips": 1,
                                   "why": "a CPU test"})
    tiny.write_json(base / "traffic" / "toy.json",
                    {"n_clients": 6, "block_rounds": 5})
    shutil.copy(base / "metrics" / "idle_share.py",
                base / "metrics" / "toy.idle_share.py")
    bench["per_layer"].append({
        "name": "toy.idle_share", "unit": "%", "better": "lower",
        "source": "device_trace", "layer": "device", "moves": "rounds_per_s",
        "workloads": ["toy.toy", "toy-broken.toy"]})
    return bench


@pytest.fixture(scope="module")
def toy_bench(tmp_path_factory):
    """(base, benchmark): the real ``BENCHMARK.json`` with the toy's cells
    added, over a copy of the benchmark's files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    base = tiny.make_base(tmp_path_factory.mktemp("portbench_toy"))[0]
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    yield base, add_toy(base, bench)
    torch.set_num_threads(threads)


def run(toy_bench, cell, traced=False):
    base, bench = toy_bench
    return harness.run(bench, cell, SEED, 0.2, traced, device="cpu",
                       base=base, log=lambda msg: None)


def test_the_toy_runs_through_the_harness(toy_bench):
    out = run(toy_bench, "toy.toy")
    assert list(out) == LAST_KEYS
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"theta_gap", "returned_diff"}
    # the cell lists no metric but those every cell reports
    assert set(out["metrics"]) == {"rounds_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["attempted"] > 0 and out["attempted"] % 5 == 0


def test_a_traced_toy_run_reads_the_device_without_kernels_of_its_own(
        toy_bench):
    """A program that runs library kernels only still gets the stretch's
    busy and window seconds, its idle share and its breakdown (no device
    records on the CPU: the stretch is idle throughout)."""
    out = run(toy_bench, "toy.toy", traced=True)
    assert out["correct"], out["checks"]
    assert out["metrics"] == {"toy.idle_share": {"value": 100.0,
                                                 "unit": "%"}}
    assert out["device"]["busy_s"] == 0 and out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["breakdown"]["idle_gaps"]


def test_a_broken_toy_comes_out_not_correct(toy_bench):
    out = run(toy_bench, "toy-broken.toy")
    assert not out["correct"]
    assert out["checks"]["theta_gap"]["value"] \
        > out["checks"]["theta_gap"]["limit"]


def test_the_toy_control_comes_out_not_correct(toy_bench):
    base, bench = toy_bench
    correct, checks = harness.control(bench, "toy.toy", SEED, device="cpu",
                                      base=base)
    assert not correct, checks


@pytest.mark.parametrize("cell,names", [
    ("toy-none.toy", "configs/toy-none.json"),
    ("toy-nosuch.toy", "programs/nosuch.py"),
])
def test_a_missing_program_fails_before_the_device_naming_its_file(
        toy_bench, cell, names):
    """No card here: a run that got as far as the device check would
    raise ``NoChip``."""
    base, bench = toy_bench
    with pytest.raises(harness.NoProgram, match=names):
        harness.run(bench, cell, SEED, 0.2, False, device="cuda", base=base)
    with pytest.raises(harness.NoProgram, match=names):
        harness.control(bench, cell, SEED, device="cuda", base=base)


def test_a_toy_run_loads_nothing_of_codedfedl(toy_bench):
    """Another program's cell pays none of CodedFedL's imports in its
    set-up: a fresh process runs the toy cell."""
    base, bench = toy_bench
    tiny.write_json(base / "bench.json", bench)
    code = (
        "import json, sys; from pathlib import Path\n"
        "sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "base = Path(%r)\n"
        "bench = json.loads((base / 'bench.json').read_text())\n"
        "out = harness.run(bench, 'toy.toy', %d, 0.2, False, device='cpu',"
        " base=base, log=lambda msg: None)\n"
        "print(json.dumps([out['correct'], sorted(m for m in sys.modules"
        " if m.startswith(%r))]))\n" % (
            str(harness.ROOT), str(harness.ROOT / "src"), str(base), SEED,
            CODEDFEDL))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, check=True,
                          env={"OMP_NUM_THREADS": "2", "PATH": "/usr/bin:/bin"})
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == [True, []]
