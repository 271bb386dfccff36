"""The span stretch on the CPU: the idle split on synthetic events, the
stretch at a tiny size, and its nine readers."""
from __future__ import annotations

import types

import pytest
import torch

from portbench import harness
from portbench import span_stretch as ss
from portbench import trace as tr
from portbench.tests import tiny

SEED = 2**31 + 8191
READERS = ["idle_ms.draw", "idle_ms.upload", "idle_ms.dispatch",
           "idle_ms.readback", "idle_ms.other_spans", "idle_ms.caller",
           "round_loop.step_host_us", "round_loop.uploads_per_block",
           "round_loop.readbacks_per_block"]


def _ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def _events():
    """A stretch of 100 us: device records at [0, 10), [40, 50) and
    [90, 100), so idle [10, 40) and [50, 90); a block that reads back,
    draws, uploads and enqueues a round across the first gap, and whose
    span ends 20 us into the second; the harness's own annotations over
    all of it."""
    return [
        _ev(tr.STRETCH, 0.0, 100.0),
        _ev("portbench/run_block", 0.0, 100.0),
        _ev("k", 0.0, 10.0, "kernel"), _ev("c", 40.0, 10.0, "gpu_memcpy"),
        _ev("k", 90.0, 10.0, "kernel"),
        _ev("block/run", 5.0, 65.0),
        _ev("block/readback", 8.0, 7.0),       # 10..15 idle
        _ev("block/draw", 20.0, 5.0),          # 20..25
        _ev("block/upload", 25.0, 5.0),        # 25..30
        _ev("scan/execute", 33.0, 15.0),       # 33..35 its own
        _ev("round/step", 35.0, 10.0),         # 35..40
        # the device's copy of a range is no host span
        _ev("round/step", 10.0, 30.0, "gpu_user_annotation"),
        _ev("aten::copy_", 11.0, 2.0, "cpu_op"),
    ]


def test_idle_by_span_splits_a_gap_by_overlap():
    got = tr.idle_by_span(_events(), ss.PROGRAM_SPANS)
    want = {"block/readback": 5, "block/draw": 5, "block/upload": 5,
            "scan/execute": 2, "round/step": 5,
            # 15..20, 30..33 inside the block's span, and 50..70
            "block/run": 5 + 3 + 20,
            ss.CALLER: 20}
    for name in list(ss.PROGRAM_SPANS) + [ss.CALLER]:
        assert got[name] == pytest.approx(want.get(name, 0) * 1e-6,
                                          abs=1e-15), name
    assert "portbench/run_block" not in got
    st = tr.summarize(_events(), {}, {})
    idle = st["window_s"] - st["busy_s"]
    assert idle == pytest.approx(70e-6)
    assert sum(got.values()) == pytest.approx(idle, rel=1e-12)


def test_idle_by_span_without_program_spans_is_the_caller_s():
    events = [e for e in _events() if not e["name"].startswith(
        ("block/", "scan/", "round/"))]
    got = tr.idle_by_span(events, ss.PROGRAM_SPANS)
    assert got[ss.CALLER] == pytest.approx(70e-6)
    assert sum(v for k, v in got.items() if k != ss.CALLER) == 0


@pytest.fixture(scope="module")
def tiny_base(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield tiny.make_base(tmp_path_factory.mktemp("portbench_spans"))[0]
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", ["tiny-raw.coded", "tiny-raw.mc3",
                                  "tiny-raw.naive"])
def test_span_stretch_on_the_cpu(tiny_base, cell):
    """The tiny runs are 4 blocks long: the 4-block stretch after 2 warm-up
    blocks finishes one run and starts the next.  No device records on
    the CPU: the whole window is idle, and the six idle_ms parts times the
    blocks add up to it."""
    config, traffic, _ = tiny.CELLS[cell]
    cfg = harness.load_json(tiny_base / "configs" / f"{config}.json")
    traffic = harness.load_json(tiny_base / "traffic" / f"{traffic}.json")
    kernels = harness.load_json(tiny_base / "work" / "kernels.json")
    lines = []
    st = ss.measure(cfg, traffic, SEED, torch.device("cpu"), kernels,
                    lines.append)
    R, K = traffic["realizations"], traffic["block_rounds"]
    n = harness.STRETCH_BLOCKS[0]
    assert st["blocks"] == n and st["busy_s"] == 0
    counts = {k: v["count"] for k, v in st["totals"].items()}
    assert counts == {"block/run": n, "scan/execute": n, "block/draw": n,
                      "round/step": n * R * K, "block/readback": 5 * n,
                      "block/upload": (2 + R) * n, "run/finish": 1,
                      "run/init": 1}
    ctx = types.SimpleNamespace(span_stretch=st)
    got = {m: harness.load_reader(m, tiny_base)(ctx) for m in READERS}
    assert got["round_loop.uploads_per_block"] == 2 + R
    assert got["round_loop.readbacks_per_block"] == 5
    assert got["round_loop.step_host_us"] > 0
    idle = sum(v for k, v in got.items() if k.startswith("idle_ms."))
    assert idle * n * 1e-3 == pytest.approx(st["window_s"], rel=1e-6)
    assert got["idle_ms.dispatch"] > 0 and got["idle_ms.readback"] > 0
    assert any(x.startswith("span stretch: busy") and "relative gap" in x
               for x in lines)


def _ctx(device_ops):
    return types.SimpleNamespace(
        cfg={}, traffic={},
        stretch={"breakdown": {"device_ops": device_ops}})


@pytest.mark.parametrize("totals,blocks", [
    # the program without round-loop spans: nothing is read
    ({"scan/execute": {"count": 4, "total_s": 1.0}}, None),
    ({"block/run": {"count": 4, "total_s": 1.0},
      "block/upload": {"count": 12, "total_s": 1e-3},
      "block/readback": {"count": 20, "total_s": 1e-3},
      "round/step": {"count": 20, "total_s": 4e-3}}, 4),
])
def test_readers_on_a_card(monkeypatch, totals, blocks):
    """Where the harness's stretch saw device records the stretch is
    measured once for all nine readers (stubbed: it needs a card); a
    program that records no round-loop span reads nothing."""
    calls = []

    def fake(cfg, traffic, seed, dev, kernels, log):
        calls.append(seed)
        return {"blocks": 4, "window_s": 1.0, "busy_s": 0.5,
                "totals": totals,
                "idle_by_span": dict.fromkeys(ss.PROGRAM_SPANS + (ss.CALLER,),
                                              0.05)}

    monkeypatch.setattr(ss, "measure", fake)
    monkeypatch.setattr("sys.argv", ["pytest"])
    ctx = _ctx([["k", 1.0]])
    got = {m: harness.load_reader(m)(ctx) for m in READERS}
    assert calls == [ss.DEFAULT_SEED]
    if blocks is None:
        assert set(got.values()) == {None}
        return
    assert got["round_loop.uploads_per_block"] == 3
    assert got["round_loop.readbacks_per_block"] == 5
    assert got["round_loop.step_host_us"] == pytest.approx(200.0)
    assert got["idle_ms.dispatch"] == pytest.approx(1e3 * 3 * 0.05 / 4)
    assert sum(v for k, v in got.items() if k.startswith("idle_ms.")) \
        == pytest.approx(1e3 * 0.5 / 4)


def test_readers_without_device_records_read_nothing(monkeypatch):
    monkeypatch.setattr(ss, "measure", None)
    ctx = _ctx([])
    assert all(harness.load_reader(m)(ctx) is None for m in READERS)


def test_run_seed_reads_the_command_line(monkeypatch):
    monkeypatch.setattr("sys.argv", ["run.py", "--workload", "w", "--seed",
                                     str(SEED), "--seconds", "1"])
    assert ss.run_seed() == SEED
    monkeypatch.setattr("sys.argv", ["pytest", "-q"])
    assert ss.run_seed() == ss.DEFAULT_SEED
