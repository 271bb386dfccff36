"""The benchmark's cells on the card, briefly: each runs correct, and its
control comes out not correct, at the cells' own sizes.  They need an
NVIDIA card (``-m cuda``); ``portbench/control.py`` reads the controls of
several seeds in one process."""
from __future__ import annotations

import json

import pytest
import torch

from portbench import harness

SEED = 2**31 + 31337
CELLS = ("mnist-rff-raw.coded", "mnist-rff-raw.coded-mc8",
         "mnist-rff-raw.naive")


@pytest.fixture
def bench():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the benchmark measures only "
                    "there)")
    return json.loads((harness.ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(bench, cell):
    out = harness.run(bench, cell, SEED, 2.0, False, log=lambda msg: None)
    assert out["correct"], out["checks"]
    assert out["device"]["kind"] == torch.cuda.get_device_name()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(bench, cell):
    correct, checks = harness.control(bench, cell, SEED)
    assert not correct, checks


@pytest.mark.cuda
def test_event_times_stand_in_for_dropped_records(bench, monkeypatch):
    """Where the profiler's kernel records fall short, kernel 4 is timed by
    CUDA events behind a spin kernel: its roofline share reads as the
    profiler's does, within 5%."""
    from portbench import trace as tr
    name = "roofline.rff_linreg_grad_masked"
    kept = harness.run(bench, CELLS[0], SEED, 2.0, True, log=lambda m: None)
    monkeypatch.setattr(tr, "short_records", lambda st: {
        k: (0, n) for k, n in st["launches"].items() if n})
    lines = []
    timed = harness.run(bench, CELLS[0], SEED, 2.0, True, log=lines.append)
    assert timed["correct"], timed["checks"]
    assert any("by CUDA events behind a spin kernel" in x for x in lines)
    a, b = kept["metrics"][name]["value"], timed["metrics"][name]["value"]
    assert abs(a - b) < 0.05 * a, (a, b)
    assert 0 < timed["device"]["busy_s"] <= timed["device"]["window_s"]
