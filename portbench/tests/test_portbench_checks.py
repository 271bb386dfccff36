"""The check that decides `correct`, shown to fail: the control (the plain
reference in TF32 in the program's place) and the program broken
underneath the timed path, at a tiny size on the CPU, under the real
cells' limits.  The cells run on one card, so there is no exchange between
chips to leave out."""
from __future__ import annotations

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

SEED = 2**31 + 4099


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield tiny.make_base(tmp_path_factory.mktemp("portbench_checks"))
    torch.set_num_threads(threads)


def run(tiny_bench, cell):
    base, bench = tiny_bench
    return harness.run(bench, cell, SEED, 0.2, False, device="cpu",
                       base=base, log=lambda msg: None)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_comes_out_not_correct(tiny_bench, cell):
    base, bench = tiny_bench
    correct, checks = harness.control(bench, cell, SEED, device="cpu",
                                      base=base)
    assert not correct
    assert checks["theta_gap"]["value"] > checks["theta_gap"]["limit"]


def _unchanged_state(monkeypatch):
    from repro_torch.core import fed_runtime
    build = fed_runtime.build_step

    def broken(static):
        step = build(static)

        def same(consts, carry, inp):
            _, out = step(consts, carry, inp)
            return carry, out
        return same
    monkeypatch.setattr(fed_runtime, "build_step", broken)


def _half_batch(monkeypatch):
    """Every other client's rows left out, the rest weighed double: the
    mean over half of the batch."""
    from repro_torch.core import aggregation

    def halve(fn):
        def inner(*args, mask, **kw):
            mask = mask.clone()
            mask[1::2] = 0.0
            mask[0::2] *= 2.0
            return fn(*args, mask=mask, **kw)
        return inner
    for name in ("batched_client_gradients", "fused_embed_client_gradients"):
        monkeypatch.setattr(aggregation, name,
                            halve(getattr(aggregation, name)))


def _altered_answer(monkeypatch):
    """One round's returned count off by one where the step makes it."""
    from repro_torch.core import fed_runtime
    build = fed_runtime.build_step
    calls = [0]

    def broken(static):
        step = build(static)

        def altered(consts, carry, inp):
            carry, (t_round, n_ret, n_masked, skipped) = step(consts, carry,
                                                              inp)
            calls[0] += 1
            if calls[0] == 13:
                n_ret = n_ret + 1
            return carry, (t_round, n_ret, n_masked, skipped)
        return altered
    monkeypatch.setattr(fed_runtime, "build_step", broken)


@pytest.mark.parametrize("cell", ["tiny-raw.coded", "tiny.coded",
                                  "tiny-raw.naive"])
@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_answer])
def test_a_broken_program_comes_out_not_correct(tiny_bench, monkeypatch,
                                                cell, fault):
    fault(monkeypatch)
    out = run(tiny_bench, cell)
    assert not out["correct"], out["checks"]
