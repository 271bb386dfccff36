"""Run telemetry of the PyTorch port (``repro_torch.obs``, the runtime's
hooks and ``repro_torch.launch.report``) against the JAX reference, on the
CPU.

The same client data (NumPy, from a seed) goes through both packages at
the size of ``tests/test_obs.py`` (n = 6, l = 16, q = 24, c = 3); the
reference's parity generators are carried over with ``repro_torch.carry``.
Held to:

  * the port's spans behave as the reference's (disabled spans record
    nothing and read no clock, ``force``, ``collecting``, ``write_json``),
    and the two packages' collectors are independent;
  * telemetry on and off give the same bits (theta, history) in the port;
  * without an eval_fn the port's ``events.jsonl`` is byte-identical to the
    reference's (every field is a host quantity); with one, the losses
    agree within LOSS_ATOL and every other field is equal;
  * a journal either package wrote resumes and grows in the other through
    its checkpoint; kill/resume appends; a torn tail is repaired;
  * `Attribution` is equal field for field; `round_deadlines` matches for
    every step kind; `render_report` gives the same text.
"""
import dataclasses
import functools
import json
import os
import time
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import config as ref_config
from repro.core import encoding as ref_enc
from repro.launch import report as ref_report
from repro.obs import attribution as ref_attr
from repro.obs import events as ref_events
from repro.obs import spans as ref_spans

from repro_torch import api as t_api
from repro_torch import carry
from repro_torch import config as t_config
from repro_torch.launch import report as t_report
from repro_torch.launch import run_report as t_run_report
from repro_torch.obs import attribution as t_attr
from repro_torch.obs import events as t_events
from repro_torch.obs import spans as t_spans

N, L, Q, C = 6, 16, 24, 3
SEED = 3
ROUNDS = 12
# the eval is the mean |theta|: it moves no more than theta itself, which
# the port holds to atol 1e-5 (tests/test_torch_engine.py)
LOSS_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _spans_off():
    """Every test starts (and leaves) with both packages' collectors off."""
    for mod in (t_spans, ref_spans):
        mod.disable()
        mod.reset()
    yield
    for mod in (t_spans, ref_spans):
        mod.disable()
        mod.reset()


def _data(n=N, l=L, q=Q, c=C, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, l, q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(n, l, c)).astype(np.float32)
    return xs, ys


def _spec(mod, scheme="coded", **over):
    base = dict(
        fl=mod.FLConfig(n_clients=N, delta=0.25, psi=0.3, seed=SEED),
        train=mod.TrainConfig(learning_rate=0.5, l2_reg=1e-5,
                              lr_decay_epochs=(5,)),
        scheme=scheme, checkpoint_every=4)
    base.update(over)
    return mod.ExperimentSpec(**base)


@functools.lru_cache(maxsize=None)
def _reference_generators(u, n=N, l=L, seed=SEED):
    """The reference's per-client generators: the split chain of
    ``CodedScheme.setup`` from PRNGKey(seed + 99)."""
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(seed + 99), None,
                           length=n)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, l))(keys))


def _ref_exp(scheme="coded", **over):
    xs, ys = _data()
    return ref_api.build_experiment(_spec(ref_config, scheme, **over), xs, ys)


def _port_exp(scheme="coded", u=None, **over):
    xs, ys = _data()
    gens = None if u is None else carry.generators_from_reference(
        _reference_generators(u), device="cpu")
    return t_api.build_experiment(_spec(t_config, scheme, **over), xs, ys,
                                  device="cpu", parity_generators=gens)


def _pair(scheme="coded", **over):
    """(reference experiment, port experiment) of one deployment."""
    ref = _ref_exp(scheme, **over)
    u = ref.u if ref.scheme_obj.coded else None
    return ref, _port_exp(scheme, u, **over)


def _eval_ref(th):
    return float(np.abs(np.asarray(th)).mean()), 0.0


def _eval_port(th):
    return float(th.abs().mean()), 0.0


def _journal(path) -> bytes:
    return (path / t_events.EVENTS_NAME).read_bytes()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def test_span_records_nothing_when_disabled():
    with t_spans.span("solver/two_step"):
        pass
    assert t_spans.totals() == {}
    t_spans.enable()
    for _ in range(2):
        with t_spans.span("solver/two_step"):
            pass
    rec = t_spans.totals()["solver/two_step"]
    assert rec["count"] == 2
    assert rec["total_s"] >= rec["max_s"] >= rec["min_s"] >= 0.0
    assert set(rec) == {"count", "total_s", "min_s", "max_s"}
    # the reference's collector never saw it
    assert not ref_spans.enabled() and ref_spans.totals() == {}


def test_disabled_span_reads_no_clock_and_syncs_nothing():
    """A disabled span is one flag check: no `time.perf_counter`, no
    `torch.cuda.synchronize`, even when it is told to sync a GPU, and no
    profiler range, even when forced to measure inside a profiler session.
    A measuring span opens a range only inside a session."""
    cuda = torch.device("cuda", 0)
    cpu_only = [torch.profiler.ProfilerActivity.CPU]
    with mock.patch.object(t_spans.time, "perf_counter",
                           wraps=time.perf_counter) as clock, \
            mock.patch.object(t_spans.torch.cuda, "synchronize") as sync, \
            mock.patch.object(t_spans.torch.profiler, "record_function",
                              wraps=torch.profiler.record_function) as rng:
        with torch.profiler.profile(activities=cpu_only):
            with t_spans.span("scan/execute", sync=cuda):
                pass
            assert clock.call_count == 0 and sync.call_count == 0
            with t_spans.span("service/block", force=True):
                pass
            assert clock.call_count == 2 and rng.call_count == 0
        t_spans.enable()
        with t_spans.span("scan/execute", sync=cuda):
            pass
        assert clock.call_count == 4 and rng.call_count == 0
        sync.assert_called_once_with(cuda)
        # a CPU device has nothing to wait for
        with torch.profiler.profile(activities=cpu_only):
            with t_spans.span("scan/execute", sync=torch.device("cpu")):
                pass
        assert sync.call_count == 1
        rng.assert_called_once_with("scan/execute")
    assert t_spans.totals()["scan/execute"]["count"] == 2


def _annotations(prof, path) -> dict:
    """{name: (start, end)} of the profile's host user annotations of the
    round loop, read back from its Chrome trace as a harness reads it."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation"
            and e["name"].startswith(("block/", "round/"))}


def test_measuring_span_is_a_profiler_annotation_nested_in_its_parent(
        tmp_path):
    t_spans.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t_spans.span("block/run"):
            with t_spans.span("round/step"):
                torch.ones(4).sum()
    t_spans.disable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as off:
        with t_spans.span("block/run"):
            pass
    assert _annotations(off, tmp_path / "off.json") == {}
    got = _annotations(prof, tmp_path / "on.json")
    assert set(got) == {"block/run", "round/step"}
    (a, b), (c, d) = got["block/run"], got["round/step"]
    assert a <= c <= d <= b
    assert {k: v["count"] for k, v in t_spans.totals().items()} == {
        "block/run": 1, "round/step": 1}


@pytest.mark.parametrize("R", [None, 2])
def test_block_counts_its_transfers(R):
    """One coded block of K = 3 rounds: one ``block/run``, R * K
    ``round/step``, 5 ``block/readback`` (four columns and the lr scale)
    and 2 + R ``block/upload`` (the delays, the learning rates, one lr
    scale a realization).  Each is a synchronizing copy on a card, so a
    transfer added through `_device` or `_to_host` fails here."""
    exp = _port_exp()
    state = exp.init_state(ROUNDS, n_realizations=R)
    with t_spans.collecting() as mod:
        exp.run_block(state, 3)
        counts = {k: v["count"] for k, v in mod.totals().items()}
    r = 1 if R is None else R
    assert counts == {"block/run": 1, "block/draw": 1, "scan/compile": 1,
                      "round/step": r * 3, "block/readback": 5,
                      "block/upload": 2 + r}


def test_forced_span_measures_without_recording_globally():
    for mod in (t_spans, ref_spans):
        with mod.span("service/block", force=True) as sp:
            pass
        assert sp.elapsed_s is not None and sp.elapsed_s >= 0.0
        assert mod.totals() == {}   # the collector stays untouched


def test_collecting_restores_the_flag_and_collectors_are_separate():
    assert not t_spans.enabled()
    ref_spans.enable()
    with t_spans.collecting() as mod:
        assert mod is t_spans and t_spans.enabled()
        with t_spans.span("trace/generate"):
            pass
        assert "trace/generate" in mod.totals()
    assert not t_spans.enabled()
    assert ref_spans.enabled() and ref_spans.totals() == {}
    ref_spans.disable()
    with ref_spans.collecting():
        assert not t_spans.enabled()


def test_write_json_roundtrip(tmp_path):
    t_spans.enable()
    with t_spans.span("encode/parity"):
        pass
    path = tmp_path / t_spans.SPANS_NAME
    assert t_spans.SPANS_NAME == ref_spans.SPANS_NAME
    t_spans.write_json(str(path))
    loaded = json.loads(path.read_text())
    assert loaded == t_spans.totals()
    assert loaded["encode/parity"]["count"] == 1


# ---------------------------------------------------------------------------
# the hard invariant: telemetry never perturbs a trajectory
# ---------------------------------------------------------------------------

CASES = {
    "coded": dict(scheme="coded"),
    "greedy": dict(scheme="greedy"),
    "adaptive_coded": dict(scheme="adaptive_coded",
                           channel_profile="drift_churn", adapt_every=2),
    "coded_chaos": dict(scheme="coded", fault_profile="chaos"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_telemetry_on_off_bit_identical(case, tmp_path):
    over = CASES[case]
    off = _port_exp(**over).run(ROUNDS, eval_fn=_eval_port, eval_every=1)
    t_spans.enable()
    exp_on = _port_exp(**over)
    on = exp_on.run(ROUNDS, eval_fn=_eval_port, eval_every=1,
                    journal_dir=str(tmp_path / "j"))
    assert torch.equal(off.theta, on.theta)
    assert t_api.histories_equal(off.history, on.history)
    assert dataclasses.asdict(off.health) == dataclasses.asdict(on.health)
    # the journal replays the exact history the run returned
    assert t_api.histories_equal(
        t_api.history_from_journal(str(tmp_path / "j")), on.history)
    # one capture a block, covering every round
    assert sum(len(b["times"]) for b in exp_on._attr_blocks) == ROUNDS


# ---------------------------------------------------------------------------
# journal: bytes against the reference, resume, repair
# ---------------------------------------------------------------------------

JOURNAL_CASES = {
    "coded": dict(scheme="coded"),
    "naive": dict(scheme="naive"),
    "greedy": dict(scheme="greedy"),
    "coded_chaos": dict(scheme="coded", fault_profile="chaos"),
}


@pytest.mark.parametrize("case", sorted(JOURNAL_CASES))
def test_journal_bytes_match_reference(case, tmp_path):
    ref, port = _pair(**JOURNAL_CASES[case])
    ref.run(ROUNDS, journal_dir=str(tmp_path / "ref"))
    port.run(ROUNDS, journal_dir=str(tmp_path / "port"))
    got = _journal(tmp_path / "port")
    assert got == _journal(tmp_path / "ref")
    assert len(got.splitlines()) == ROUNDS


def test_journal_with_eval_matches_reference_within_tolerance(tmp_path):
    ref, port = _pair("coded", fault_profile="byzantine_lite")
    ref.run(ROUNDS, eval_fn=_eval_ref, eval_every=3,
            journal_dir=str(tmp_path / "ref"))
    port.run(ROUNDS, eval_fn=_eval_port, eval_every=3,
             journal_dir=str(tmp_path / "port"))
    want = t_events.load_events(str(tmp_path / "ref"))
    got = t_events.load_events(str(tmp_path / "port"))
    assert len(got) == len(want) == ROUNDS
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in set(g) - {"loss"}:
            assert g[key] == w[key], key
        if w["loss"] is None:
            assert g["loss"] is None
        else:
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=0,
                                       atol=LOSS_ATOL)
    assert sum(e["n_masked"] for e in got) > 0


def test_journal_byte_deterministic(tmp_path):
    t_spans.enable()
    for d in ("a", "b"):
        _port_exp().run(ROUNDS, eval_fn=_eval_port, eval_every=1,
                        journal_dir=str(tmp_path / d))
    a = _journal(tmp_path / "a")
    assert a == _journal(tmp_path / "b")
    assert len(a.splitlines()) == ROUNDS


def test_journal_event_shape(tmp_path):
    _port_exp().run(8, eval_fn=_eval_port, eval_every=1,
                    journal_dir=str(tmp_path))
    events = t_events.load_events(str(tmp_path))
    assert [e["round"] for e in events] == list(range(8))
    wall = 0.0
    for e in events:
        assert e["t_round_s"] > 0 and e["wall_clock_s"] > wall
        wall = e["wall_clock_s"]
        assert e["returned"] >= 1
        assert e["n_masked"] == 0 and e["skipped"] == 0
        assert e["lr_scale"] == 1.0
        assert e["loss"] is not None   # collect=True, eval_every=1


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_resumes_across_packages(writer, tmp_path):
    """One block, its checkpoint and its journal written by one package;
    the other resumes the run through that checkpoint and extends the
    journal, which ends byte-identical to an uninterrupted run's."""
    ref, port = _pair()
    ref.run(ROUNDS, journal_dir=str(tmp_path / "whole"))
    ref2, port2 = _pair()
    first, second = (ref2, port2) if writer == "reference" else (port2, ref2)
    state = first.run_block(first.init_state(ROUNDS))
    ckpt = tmp_path / "ckpt"
    first.save_state(str(ckpt / "ckpt_000004.npz"), state)
    events_mod = ref_events if writer == "reference" else t_events
    assert events_mod.RunJournal(str(tmp_path / "j")).sync(first,
                                                           state) == 4
    partial = _journal(tmp_path / "j")
    second.run(ROUNDS, checkpoint_dir=str(ckpt), resume=True,
               journal_dir=str(tmp_path / "j"))
    final = _journal(tmp_path / "j")
    assert final.startswith(partial)
    assert final == _journal(tmp_path / "whole")


def test_kill_resume_appends_to_existing_journal(tmp_path):
    """Interrupt at a block boundary, resume in a FRESH experiment with
    the same journal dir: the final journal is byte-identical to the
    uninterrupted run's (appended, never rewritten)."""
    ref_dir, jdir = str(tmp_path / "ref"), str(tmp_path / "resumed")
    ckpt = str(tmp_path / "ckpt")
    _port_exp().run(ROUNDS, eval_fn=_eval_port, eval_every=1,
                    journal_dir=ref_dir)

    interrupted = _port_exp()
    state = interrupted.init_state(ROUNDS, collect=True)
    state = interrupted.run_block(state, eval_fn=_eval_port, eval_every=1)
    interrupted.save_state(os.path.join(ckpt, "ckpt_000004.npz"), state)
    assert t_events.RunJournal(jdir).sync(interrupted, state) == 4
    partial = _journal(tmp_path / "resumed")

    _port_exp().run(ROUNDS, eval_fn=_eval_port, eval_every=1,
                    checkpoint_dir=ckpt, resume=True, journal_dir=jdir)
    final = _journal(tmp_path / "resumed")
    assert final.startswith(partial)
    assert final == _journal(tmp_path / "ref")


def test_journal_ahead_of_the_checkpoint_is_trimmed(tmp_path):
    """A journal that ran past the restored checkpoint (blocks journaled,
    then lost to a rollback) is cut back and regrown from the state."""
    whole = tmp_path / "whole"
    _port_exp().run(ROUNDS, journal_dir=str(whole))
    exp = _port_exp()
    ckpt = tmp_path / "ckpt"
    exp.run(ROUNDS, checkpoint_dir=str(ckpt), journal_dir=str(whole.parent
                                                              / "j"))
    for name in ("ckpt_000008.npz", "ckpt_000012.npz"):
        os.remove(ckpt / name)
    _port_exp().run(ROUNDS, checkpoint_dir=str(ckpt), resume=True,
                    journal_dir=str(tmp_path / "j"))
    assert _journal(tmp_path / "j") == _journal(whole)


def test_torn_tail_repaired_on_open(tmp_path):
    exp = _port_exp()
    state = exp.init_state(8, collect=True)
    state = exp.run_block(state, eval_fn=_eval_port, eval_every=1)
    journal = t_events.RunJournal(str(tmp_path))
    journal.sync(exp, state)
    clean = _journal(tmp_path)

    # a crash mid-append: a torn, newline-less partial record
    with open(tmp_path / t_events.EVENTS_NAME, "ab") as fh:
        fh.write(b'{"round": 99, "t_round_s"')
    # the read-only loader skips the torn tail and leaves the file alone
    assert len(t_events.load_events(str(tmp_path))) == 4
    assert _journal(tmp_path) != clean
    # the write-path journal truncates it and continues cleanly
    reopened = t_events.RunJournal(str(tmp_path))
    assert reopened.rounds_logged == 4
    assert _journal(tmp_path) == clean
    state = exp.run_block(state, eval_fn=_eval_port, eval_every=1)
    reopened.sync(exp, state)
    assert [e["round"] for e in t_events.load_events(str(tmp_path))] == \
        list(range(8))
    with pytest.raises(ValueError, match="non-contiguous"):
        reopened.append_events([{"round": 3}])


def test_journal_dir_rejected_on_legacy_engine(tmp_path):
    exp = _port_exp(engine="legacy", checkpoint_every=0)
    with pytest.raises(ValueError, match="batched engine"):
        exp.run(4, journal_dir=str(tmp_path))


def test_journal_refuses_multi_and_hier_states(tmp_path):
    """A stack of realizations is refused; a hierarchical run journals one
    event a round, with every shard's deadline (``t_star_s``), as the
    reference's does."""
    from repro_torch.hier import HierExperiment
    exp = _port_exp()
    state = exp.init_state(4, n_realizations=2)
    journal = t_events.RunJournal(str(tmp_path))
    state = exp.run_block(state)
    with pytest.raises(ValueError, match="single-trajectory"):
        journal.sync(exp, state)
    xs, ys = _data()
    # the chunked solver's many small float64 ops on one intra-op thread,
    # so parallel test workers do not oversubscribe the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        hier = HierExperiment(
            _spec(t_config, hier_shards=2, sample_fraction=0.5), xs, ys,
            device="cpu", solver_kwargs=dict(n_golden_search=8, n_bisect=12,
                                             n_golden=12))
    finally:
        torch.set_num_threads(threads)
    hier_state = hier.run_block(hier.init_state(4))
    hier_journal = t_events.RunJournal(str(tmp_path / "hier"))
    assert hier_journal.sync(hier, hier_state) == 4
    events = t_events.load_events(str(tmp_path / "hier"))
    assert [e["round"] for e in events] == [0, 1, 2, 3]
    assert all(e["t_star_s"] == [p.t_star for p in hier.plans]
               and e["n_masked"] == 0 and e["skipped"] == 0
               and e["loss"] is None for e in events)
    assert [e["returned"] for e in events] == hier_state.n_ret.tolist()
    with pytest.raises(FileNotFoundError, match="no run journal"):
        t_events.load_events(str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# spans through a real run
# ---------------------------------------------------------------------------

def test_required_spans_recorded_by_journaled_run(tmp_path):
    with t_spans.collecting() as mod:
        _port_exp().run(8, journal_dir=str(tmp_path))
        totals = mod.totals()
    assert set(t_report.REQUIRED_SPANS) <= set(totals)
    assert t_report.REQUIRED_SPANS == ref_report.REQUIRED_SPANS
    assert "checkpoint/save" not in totals   # no checkpoint_dir given
    # the first block of the cached step is scan/compile, the rest execute
    assert totals["scan/compile"]["count"] == 1
    assert totals["scan/execute"]["count"] == 1
    assert totals["journal/append"]["count"] == 2
    assert not ref_spans.totals()


def test_checkpoint_and_trace_spans(tmp_path):
    with t_spans.collecting() as mod:
        exp = _port_exp("naive", channel_profile="drift_churn")
        exp.run(ROUNDS, checkpoint_dir=str(tmp_path))
        _port_exp("naive", channel_profile="drift_churn").run(
            ROUNDS, checkpoint_dir=str(tmp_path), resume=True)
        multi = _port_exp("naive")
        multi.run_multi(8, 2)
        totals = mod.totals()
    assert totals["checkpoint/save"]["count"] == ROUNDS // 4
    assert totals["checkpoint/restore"]["count"] == 1
    assert totals["trace/generate"]["count"] == ROUNDS // 4
    assert "solver/two_step" not in totals and "encode/parity" not in totals
    # each experiment's first block is scan/compile, its later ones
    # scan/execute: the channel run's 3 blocks (the resumed run restored
    # its finished state and ran none), run_multi's 2 (one span a block,
    # over every realization)
    assert totals["scan/compile"]["count"] == 2
    assert totals["scan/execute"]["count"] == 2 + 1


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------

ATTR_CASES = {
    "coded": dict(scheme="coded"),
    "naive": dict(scheme="naive"),
    "greedy": dict(scheme="greedy"),
    "ideal": dict(scheme="ideal"),
    "coded_traced": dict(scheme="coded", channel_profile="drift_churn"),
    "greedy_traced": dict(scheme="greedy", channel_profile="drift_churn"),
    "adaptive_coded": dict(scheme="adaptive_coded",
                           channel_profile="drift_churn", adapt_every=2),
    "adaptive_greedy": dict(scheme="adaptive_greedy",
                            channel_profile="churn", adapt_every=2),
}


def _same_attribution(got, want):
    assert (got.rounds, got.k) == (want.rounds, want.k)
    for field in ("miss_rate", "miss_counts", "active_rounds",
                  "slowest_k_counts", "comp_share"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert got.to_dict() == want.to_dict()


@pytest.mark.parametrize("case", sorted(ATTR_CASES))
def test_attribution_matches_reference(case):
    ref, port = _pair(**ATTR_CASES[case])
    ref_spans.enable()
    ref.run(ROUNDS)
    t_spans.enable()
    port.run(ROUNDS)
    for k in (1, 3):
        _same_attribution(port.attribution(k=k), ref.attribution(k=k))


def test_attribution_requires_enabled_telemetry():
    exp = _port_exp()
    exp.run(4)
    with pytest.raises(RuntimeError, match="enable"):
        exp.attribution()


def test_attribution_covers_the_rounds_since_restore(tmp_path):
    t_spans.enable()
    exp = _port_exp()
    exp.run(ROUNDS, checkpoint_dir=str(tmp_path))
    assert exp.attribution().rounds == ROUNDS
    exp.restore_state(str(tmp_path / "ckpt_000004.npz"))
    with pytest.raises(RuntimeError, match="no telemetry"):
        exp.attribution()


def test_attribution_bounds():
    exp = _port_exp()
    t_spans.enable()
    exp.run(10)
    attr = exp.attribution(k=2)
    assert attr.rounds == 10 and attr.k == 2
    assert attr.miss_rate.shape == (N,)
    assert np.all((attr.miss_rate >= 0) & (attr.miss_rate <= 1))
    assert np.all(attr.miss_counts <= attr.active_rounds)
    assert attr.slowest_k_counts.sum() == 10 * 2
    assert np.all((attr.comp_share >= 0) & (attr.comp_share <= 1))
    top = attr.top_stragglers(3)
    assert [r for _, r in top] == sorted((r for _, r in top), reverse=True)


DEADLINE_KINDS = {
    "coded": dict(t_star=2.5),
    "coded_per_round": dict(t_star_r=[1.0, 2.0, 3.0, 4.0]),
    "adaptive_coded": dict(t_star_r=[1.5, 2.5, 3.5, 4.5]),
    "ideal": dict(t_ideal=1.25),
    "naive": {},
    "greedy": dict(n_wait=3),
    "adaptive_greedy": dict(n_wait_r=[1, 2, 5, 3]),
}


@pytest.mark.parametrize("kind", sorted(DEADLINE_KINDS))
def test_round_deadlines_match_reference(kind):
    rng = np.random.default_rng(0)
    times = rng.uniform(1.0, 5.0, size=(4, 5))
    active = np.ones((4, 5), dtype=bool)
    active[2, :3] = False
    active[3, :] = False
    step = kind.replace("_per_round", "")
    got = t_attr.round_deadlines(step, times, active, **DEADLINE_KINDS[kind])
    want = ref_attr.round_deadlines(step, times, active,
                                    **DEADLINE_KINDS[kind])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    with pytest.raises(ValueError, match="unknown step kind"):
        t_attr.round_deadlines("bogus", times, active)


def test_attribution_from_blocks_matches_reference():
    blocks = [{"times": np.full((3, 4), 1.0), "active": None},
              {"times": np.full((2, 4), 9.0),
               "active": np.array([[1, 1, 0, 1], [1, 1, 1, 1]])}]
    kw = dict(t_star=2.0, t_ideal=1.0, n_wait=2, loads=np.full(4, 0.5),
              m=2.0, k=1)
    for kind in ("coded", "naive", "greedy", "ideal"):
        _same_attribution(t_attr.attribution_from_blocks(blocks, kind, **kw),
                          ref_attr.attribution_from_blocks(blocks, kind,
                                                           **kw))
    with pytest.raises(ValueError, match="k=0"):
        t_attr.compute_attribution(np.ones((2, 2)), None, np.ones(2), k=0)


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def test_render_report_matches_reference(tmp_path):
    run_dir = tmp_path / "run"
    with t_spans.collecting():
        exp = _port_exp("coded", fault_profile="flaky_clients")
        exp.run(ROUNDS + 4, eval_fn=_eval_port, eval_every=2,
                journal_dir=str(run_dir))
        t_spans.write_json(str(run_dir / t_spans.SPANS_NAME))
    assert t_report.ATTR_NAME == ref_report.ATTR_NAME
    empty = tmp_path / "empty"
    empty.mkdir()
    assert t_report.render_report(str(empty)) == \
        ref_report.render_report(str(empty))
    with open(run_dir / t_report.ATTR_NAME, "w") as fh:
        json.dump(exp.attribution().to_dict(), fh)
    for kw in ({}, dict(top=2, max_rounds=6)):
        text = t_report.render_report(str(run_dir), **kw)
        assert text == ref_report.render_report(str(run_dir), **kw)
    for section in ("rounds journaled: 16", "span breakdown:",
                    "top stragglers (k=3, 16 rounds):",
                    "mean coded-compensation share"):
        assert section in text


def test_run_telemetry_invariants_on_the_cpu():
    section = t_report.run_telemetry(n_clients=4, l=16, q=16, c=2, iters=8,
                                     block=4, repeats=1, device="cpu")
    # at this toy size the ratio measures journal I/O against almost no
    # compute, so the ceiling is lifted, as the reference's tests do
    assert t_report.validate_telemetry(
        section, max_overhead_ratio=float("inf")) == []
    assert section["config"]["device"] == "cpu"
    assert set(t_report.REQUIRED_SPANS) <= set(section["span_totals"])
    assert not t_spans.enabled()
    bad = dict(section, journal_deterministic=False)
    assert t_report.validate_telemetry(bad, max_overhead_ratio=1e9) == \
        ref_report.validate_telemetry(bad, max_overhead_ratio=1e9)


def test_run_report_launcher(tmp_path):
    lines = []
    got = t_run_report.main(device="cpu", run_dir=str(tmp_path / "r"),
                            out=lines.append)
    assert got["report"] == t_report.render_report(str(tmp_path / "r"))
    assert lines[0] == got["report"]
    assert set(t_report.REQUIRED_SPANS) <= set(got["spans"])
    assert got["attribution"].rounds == t_run_report.ITERS
    assert len(t_events.load_events(str(tmp_path / "r"))) == \
        t_run_report.ITERS
