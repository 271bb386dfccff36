"""The harness on the CPU at a tiny size: cells, configurations and
metrics found by name, the result line, the import check, and the program
held against the plain reference."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

SEED = 2**31 + 977
LAST_KEYS = ["correct", "attempted", "failed", "metrics", "device",
             "checks"]


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield tiny.make_base(tmp_path_factory.mktemp("portbench"))
    torch.set_num_threads(threads)


def run(tiny_bench, cell, traced=False, seconds=0.3):
    base, bench = tiny_bench
    return harness.run(bench, cell, SEED, seconds, traced, device="cpu",
                       base=base, log=lambda msg: None)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_program_matches_reference(tiny_bench, cell):
    out = run(tiny_bench, cell)
    assert list(out) == LAST_KEYS
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"rounds_per_s", "block_ms_p95",
                                   "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["device"]["count"] == 1


def test_traced_run_reports_per_layer_metrics(tiny_bench):
    out = run(tiny_bench, "tiny-raw.coded", traced=True)
    assert out["correct"], out["checks"]
    # no card: no device records, so no kernel time and no roofline
    assert set(out["metrics"]) == {"solver_s", "encode_s", "mfu",
                                   "idle_share", "round_loop.block_ms_p95"}
    assert list(out)[-1] == "checks" and "breakdown" in out
    assert out["device"]["window_s"] > 0


def test_a_stretch_short_of_records_is_shortened_then_timed_by_events(
        tiny_bench, monkeypatch):
    """Where the profiled stretch keeps fewer kernel records than launches,
    a shorter stretch is profiled, and where that falls short too, the
    kernels short of records are timed by events over a stretch of their
    own (stubbed here: CUDA events need a card)."""
    from portbench import trace as tr
    profiled, timed = [], []
    summarize = tr.summarize

    def spy(events, kernels, launches):
        profiled.append(1)
        return summarize(events, kernels, launches)

    def events(module, names, fn):
        before = len(profiled)
        fn()
        timed.append((names, len(profiled) - before))
        return {k: 1e-3 for k in names}

    monkeypatch.setattr(tr, "summarize", spy)
    monkeypatch.setattr(tr, "short_records",
                        lambda st: {"rff_linreg_grad_masked": (0, 0)})
    monkeypatch.setattr(tr, "event_times", events)
    lines = []
    base, bench = tiny_bench
    out = harness.run(bench, "tiny-raw.coded", SEED, 0.3, True,
                      device="cpu", base=base, log=lines.append)
    assert out["correct"], out["checks"]
    assert len(profiled) == len(harness.STRETCH_BLOCKS)
    assert timed == [(["rff_linreg_grad_masked"], 0)]
    assert any("by CUDA events behind a spin kernel" in x for x in lines)
    assert out["device"]["window_s"] > 0


def test_new_cell_config_and_metric_are_found_by_name(tiny_bench):
    base, bench = tiny_bench
    bench = json.loads(json.dumps(bench))
    cfg = harness.load_json(base / "configs" / "tiny-raw.json")
    tiny.write_json(base / "configs" / "tiny-new.json",
                    dict(cfg, name="tiny-new", l=10))
    tiny.write_json(base / "traffic" / "new.json",
                    {"scheme": "coded", "n_clients": 5, "realizations": 2,
                     "block_rounds": 4})
    (base / "limits" / "tiny-new.new.json").write_text(
        (base / "limits" / "tiny-raw.coded.json").read_text())
    (base / "metrics" / "blocks_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.block_s))\n")
    bench["workloads"].append({"name": "tiny-new.new", "config": "tiny-new",
                               "traffic": "new", "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "blocks_seen", "unit": "blocks",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["tiny-new.new"]})
    out = harness.run(bench, "tiny-new.new", SEED, 0.2, False,
                      device="cpu", base=base, log=lambda msg: None)
    assert out["correct"], out["checks"]
    assert out["metrics"]["blocks_seen"]["value"] >= 1
    assert out["attempted"] % (2 * 4) == 0
    other = harness.cell_metrics(bench, "tiny-raw.coded", "end_to_end")
    assert "blocks_seen" not in [m["name"] for m in other]


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch", "repro_torch.api", "reproduce", "jaxtyping",
             "flax.linen", "repro.core", "jax", "jaxlib.xla_client"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jaxlib.xla_client", "repro.core"]


@pytest.mark.parametrize("foreign", ["", "repro"])
def test_a_loaded_jax_package_refuses_the_result(foreign):
    """The command prints its result only where no module of JAX or of the
    JAX package is loaded once the window has closed (the run itself is
    stubbed: it needs a card)."""
    code = (
        "import sys, types; sys.path[:0] = [%r]\n"
        "from portbench import harness, run\n"
        "harness.run = lambda *a, **k: {'correct': True}\n"
        "if %r: sys.modules[%r] = types.ModuleType(%r)\n"
        "print('RC', run.main(['--workload', 'w', '--seed', '1', "
        "'--seconds', '1']))\n" % (str(harness.ROOT), foreign, foreign,
                                      foreign))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, check=True)
    if foreign:
        assert proc.stdout.strip() == "RC 2"
        assert "repro" in proc.stderr
    else:
        assert proc.stdout.strip().splitlines() == ['{"correct": true}',
                                                    "RC 0"]


def test_no_card_no_result():
    """Without a card the command prints no result and exits non-zero."""
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "mnist-rff-raw.coded", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_reference_and_generator_import_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.codedfedl, portbench.gen; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'repro_torch', 'jax')])" % str(harness.ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, check=True)
    assert proc.stdout.strip() == "[]"
