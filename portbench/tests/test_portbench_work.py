"""The work counts at each cell's shapes, against numbers worked out by
hand, and the roofline and mfu readers on them."""
from __future__ import annotations

import json
import types

import numpy as np

from portbench import harness
from portbench.work import counts

# MNIST-RFF widths: d 784, q 2000, c 10
D, Q, C = 784, 2000, 10


def test_linreg_grad_masked_n150_every_row():
    # mnist-rff.coded-n150 with every client back: 60,000 client rows and
    # 12,000 parity rows.  4 q c = 80,000 a row; a row reads 2011 floats
    flops, nbytes = counts.linreg_grad_masked(Q, C, 72_000)
    assert flops == 5_760_000_000
    assert nbytes == 4 * (72_000 * 2011 + 40_000) == 579_328_000
    t, bound = counts.least_seconds(flops, nbytes)
    assert bound == "bytes"
    assert abs(t - 579_328_000 / 3.35e12) < 1e-15


def test_rff_linreg_grad_masked_n30():
    # mnist-rff-raw.coded: 9,600 client rows back and 2,400 parity rows;
    # 2 d q + 4 q c = 3,216,000 a client row, 80,000 a parity row
    flops, nbytes = counts.rff_linreg_grad_masked(D, Q, C, 9_600, 2_400)
    assert flops == 9_600 * 3_216_000 + 2_400 * 80_000 == 31_065_600_000
    assert nbytes == 4 * (9_600 * 795 + 2_400 * 2011 + 1_568_000 + 2_000
                          + 40_000) == 56_273_600
    assert counts.least_seconds(flops, nbytes)[1] == "operations"


def test_rff_linreg_grad_masked_naive():
    # mnist-rff-raw.naive: all 12,000 rows, no parity row
    flops, nbytes = counts.rff_linreg_grad_masked(D, Q, C, 12_000, 0)
    assert flops == 38_592_000_000
    assert nbytes == 4 * (12_000 * 795 + 1_610_000) == 44_600_000


def test_step_flops():
    # 4 q c a row and 5 q c for the update
    assert counts.step_flops(Q, C, 12_000) == 960_000_000 + 100_000
    assert counts.step_flops(Q, C, 72_000) == 5_760_100_000


def _ctx(rows, kernel, seconds, launches=None, u=2_400, fused=True):
    cfg = json.loads((harness.HERE / "configs" / (
        "mnist-rff-raw.json" if fused else "mnist-rff.json")).read_text())
    n = sum(np.asarray(r).size for r in rows)
    return types.SimpleNamespace(
        cfg=cfg, u=u, stretch_rows=[np.asarray(r) for r in rows],
        window_rows=[np.asarray(r) for r in rows], window_s=1.0,
        peaks=counts.PEAKS,
        stretch={"kernel_s": {kernel: seconds},
                 "launches": {kernel: n if launches is None else launches},
                 "busy_s": 0.9, "window_s": 1.0})


def test_readers():
    rows = [[[12_000, 12_000]]]
    ctx = _ctx(rows, "rff_linreg_grad_masked", 2e-3)
    read = harness.load_reader("roofline.rff_linreg_grad_masked")
    want = 100 * 2 * (9_600 * 3_216_000 + 2_400 * 80_000) / 495e12 / 2e-3
    assert abs(read(ctx) - want) < 1e-9 * want
    assert read(_ctx(rows, "rff_linreg_grad_masked", 2e-3, launches=3)) \
        is None
    ctx = _ctx(rows, "linreg_grad_masked", 1e-3, u=12_000, fused=False)
    want = 100 * 2 * 4 * (12_000 * 2011 + 40_000) / 3.35e12 / 1e-3
    got = harness.load_reader("roofline.linreg_grad_masked")(ctx)
    assert abs(got - want) < 1e-9 * want
    mfu = harness.load_reader("mfu")(ctx)
    assert abs(mfu - 100 * 2 * 960_100_000 / 495e12) < 1e-12
    assert abs(harness.load_reader("idle_share")(ctx) - 10.0) < 1e-9


def test_short_records_and_event_times_in_their_place():
    """A kernel whose records the profiler kept in part is found, and its
    event time stands in for them in its kernel and busy seconds."""
    from portbench import trace as tr
    k4, k3 = "rff_linreg_grad_masked", "linreg_grad_masked"
    st = {"records": {k4: 3, k3: 0}, "launches": {k4: 5, k3: 0, "x": 2},
          "recorded_s": {k4: 3e-3, k3: 0.0}, "kernel_s": {},
          "busy_s": 5e-3, "window_s": 10e-3}
    assert tr.short_records(st) == {k4: (3, 5)}
    assert tr.short_records(dict(st, records={k4: 5, k3: 0})) == {}
    out = tr.with_event_times(st, {k4: 1.2e-3})
    assert abs(out["kernel_s"][k4] - 6e-3) < 1e-15
    assert abs(out["busy_s"] - 8e-3) < 1e-15
    assert st["kernel_s"] == {} and st["busy_s"] == 5e-3
