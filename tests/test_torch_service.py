"""The port's ExperimentService and resilience runner
(``repro_torch.launch.service``, ``repro_torch.launch.resilience``) against
the JAX reference, on the CPU.

The same client data (NumPy, from a seed) goes through both packages at
the size of ``tests/test_service.py`` (n = 6, l = 16, q = 24, c = 3); the
reference's parity generators are carried over with ``repro_torch.carry``
(`submit(..., parity_generators=...)`).  Held to:

  * the cases of ``tests/test_service.py`` in the port: multiplexed runs
    equal individual runs bit for bit, round-robin scheduling, kill/resume
    bit-identical, a finished run resubmitted, validation, the horizon
    mismatch, a multi-realization job;
  * against the reference service: wall clock, returned counts and guard
    counters equal, theta within atol 1e-5 (tests/test_torch_engine.py);
    the chaos stream crashes and retries the same blocks (`total_retries`
    equal), quarantine after the same failures, the same journal bytes;
  * `run_resilience(device="cpu")` at a reduced horizon: `validate_
    resilience == []`, health counters, wall clocks and times to target
    equal to the reference's, final losses within LOSS_ATOL.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro import config as ref_config
from repro.core import encoding as ref_enc
from repro.launch import resilience as ref_res
from repro.launch.service import ExperimentService as RefService
from repro.obs import spans as ref_spans

from repro_torch import api as t_api
from repro_torch import carry
from repro_torch import config as t_config
from repro_torch.checkpoint import io as t_ckpt
from repro_torch.launch import resilience as t_res
from repro_torch.launch import service_multiplex as t_multiplex
from repro_torch.launch.service import ExperimentService
from repro_torch.obs import events as t_events
from repro_torch.obs import spans as t_spans

N, L, Q, C = 6, 16, 24, 3
SEED = 3
THETA_ATOL = 1e-5
# final losses of the resilience runs: a mean squared error over the
# (n, l, c) predictions of thetas within THETA_ATOL (seen: 6e-8)
LOSS_ATOL = 1e-6


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


def _three_specs(mod):
    """Three heterogeneous jobs: static coded, greedy with a different
    block size, and an adaptive traced-channel run."""
    return {
        "a": _spec(mod, "coded"),
        "b": _spec(mod, "greedy", checkpoint_every=3),
        "c": _spec(mod, "adaptive_coded", channel_profile="drift_churn",
                   adapt_every=2),
    }


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


def _gens(spec, n=N, l=L, seed=SEED, device="cpu"):
    """The reference's generator stack for a coded-family spec, else
    None."""
    if spec.scheme not in ("coded", "adaptive_coded"):
        return None
    u = max(1, int(round(spec.fl.delta * n * l)))
    return carry.generators_from_reference(
        _reference_generators(u, n, l, seed), device=device)


def _submit(svc, spec, iters, run_id, xs=None, ys=None, **kw):
    if xs is None:
        xs, ys = _data()
    return svc.submit(spec, xs, ys, iters, run_id=run_id,
                      parity_generators=_gens(spec), **kw)


def _service(root, **kw):
    return ExperimentService(str(root), device="cpu", **kw)


def _port_solo(spec, iters):
    xs, ys = _data()
    return t_api.build_experiment(spec, xs, ys, device="cpu",
                                  parity_generators=_gens(spec)).run(iters)


def _same_rounds(got, want):
    """Host quantities equal; theta within THETA_ATOL."""
    for f in ("wall_clock", "returned", "n_masked", "skipped"):
        assert [getattr(h, f) for h in got.history] == \
            [getattr(h, f) for h in want.history], f
    np.testing.assert_allclose(got.theta.cpu().numpy(),
                               np.asarray(want.theta), atol=THETA_ATOL)


# ---------------------------------------------------------------------------
# the cases of tests/test_service.py
# ---------------------------------------------------------------------------

def test_multiplexed_runs_match_individual_and_reference(tmp_path):
    xs, ys = _data()
    svc = _service(tmp_path / "port")
    for rid, spec in _three_specs(t_config).items():
        _submit(svc, spec, 12, rid)
    assert len(svc.pending) == 3
    results = svc.run_until_complete()
    assert not svc.pending
    ref_svc = RefService(str(tmp_path / "ref"))
    for rid, spec in _three_specs(ref_config).items():
        ref_svc.submit(spec, xs, ys, 12, run_id=rid)
    want = ref_svc.run_until_complete()
    for rid, spec in _three_specs(t_config).items():
        solo = _port_solo(spec, 12)
        assert torch.equal(solo.theta, results[rid].theta)
        assert t_api.histories_equal(solo.history, results[rid].history)
        _same_rounds(results[rid], want[rid])
        assert results[rid].privacy_eps == pytest.approx(
            want[rid].privacy_eps, rel=1e-6)


def test_step_round_robins_across_runs(tmp_path):
    svc = _service(tmp_path)
    for rid, spec in _three_specs(t_config).items():
        _submit(svc, spec, 12, rid)
    first_cycle = [svc.step() for _ in range(3)]
    assert sorted(first_cycle) == ["a", "b", "c"]
    # every run advanced exactly one block and has one checkpoint on disk
    for rid in ("a", "b", "c"):
        run = svc.runs[rid]
        assert run.state.rounds_done == run.spec.checkpoint_every
        assert t_ckpt.latest_checkpoint(run.ckpt_dir) is not None


def test_service_kill_and_resume_bit_identical(tmp_path):
    """Partial progress -> new service, same root, same submissions ->
    identical final results (checkpoints carry ALL the state)."""
    control = _service(tmp_path / "control")
    for rid, spec in _three_specs(t_config).items():
        _submit(control, spec, 12, rid)
    expect = control.run_until_complete()

    svc1 = _service(tmp_path / "killed")
    for rid, spec in _three_specs(t_config).items():
        _submit(svc1, spec, 12, rid)
    for _ in range(5):
        svc1.step()
    del svc1                                   # the kill

    svc2 = _service(tmp_path / "killed")
    for rid, spec in _three_specs(t_config).items():
        run = _submit(svc2, spec, 12, rid)
        assert run.resumed
        assert 0 < run.state.rounds_done < 12
    results = svc2.run_until_complete()
    for rid in expect:
        assert torch.equal(expect[rid].theta, results[rid].theta)
        assert t_api.histories_equal(expect[rid].history,
                                     results[rid].history)
        assert expect[rid].privacy_eps == results[rid].privacy_eps


def test_resubmitting_finished_run_returns_result(tmp_path):
    spec = _spec(t_config, "coded")
    svc1 = _service(tmp_path)
    _submit(svc1, spec, 8, "done")
    expect = svc1.run_until_complete()["done"]

    svc2 = _service(tmp_path)
    run = _submit(svc2, spec, 8, "done")
    assert run.resumed and run.done
    assert torch.equal(expect.theta, run.result.theta)
    assert svc2.step() is None


def test_submit_validation(tmp_path):
    svc = _service(tmp_path)
    with pytest.raises(ValueError, match="checkpoint_every"):
        _submit(svc, _spec(t_config, checkpoint_every=0), 8, "x")
    _submit(svc, _spec(t_config), 8, "x")
    with pytest.raises(ValueError, match="already submitted"):
        _submit(svc, _spec(t_config), 8, "x")
    # run_id can ride in the spec itself (validated as a slug there)
    run = _submit(svc, _spec(t_config, run_id="from-spec"), 8, None)
    assert run.run_id == "from-spec"
    # or default to run<k>; a spec dict (the reference's to_dict) revives
    xs, ys = _data()
    run = svc.submit(_spec(ref_config, "naive").to_dict(), xs, ys, 8)
    assert run.run_id == "run2" and run.spec == _spec(t_config, "naive")
    with pytest.raises(ValueError, match="run_id"):
        _spec(t_config, run_id="bad/slash")
    for kw in (dict(max_retries=-1), dict(retry_backoff=-0.5)):
        with pytest.raises(ValueError):
            _service(tmp_path, **kw)


def test_resubmit_horizon_mismatch_rejected(tmp_path):
    spec = _spec(t_config, "coded")
    svc1 = _service(tmp_path)
    _submit(svc1, spec, 12, "x")
    svc1.step()
    svc2 = _service(tmp_path)
    with pytest.raises(ValueError, match="horizon"):
        _submit(svc2, spec, 16, "x")
    with pytest.raises(ValueError, match="horizon"):
        _submit(svc2, spec, 12, "x", n_realizations=2)


def test_service_multi_realization_job(tmp_path):
    """run_multi jobs multiplex alongside single runs."""
    xs, ys = _data()
    spec = _spec(t_config, "coded", checkpoint_every=3)
    svc = _service(tmp_path)
    _submit(svc, spec, 6, "multi", n_realizations=3)
    _submit(svc, _spec(t_config, "greedy"), 8, "single")
    results = svc.run_until_complete()
    solo = t_api.build_experiment(
        spec, xs, ys, device="cpu",
        parity_generators=_gens(spec)).run_multi(6, 3)
    assert torch.equal(solo.theta, results["multi"].theta)
    np.testing.assert_array_equal(solo.wall_clock,
                                  results["multi"].wall_clock)
    assert tuple(results["single"].theta.shape) == (Q, C)
    # a journal records single runs only
    assert svc.runs["multi"].journal is None


def test_service_refuses_a_mesh_and_defaults_to_the_gpu(tmp_path):
    with pytest.raises(NotImplementedError, match="client-mesh"):
        ExperimentService(str(tmp_path), device="cpu", mesh=2)
    svc = _service(tmp_path)
    with pytest.raises(NotImplementedError, match="mesh"):
        _submit(svc, _spec(t_config, mesh=2), 8, "m")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ExperimentService(str(tmp_path))


# ---------------------------------------------------------------------------
# chaos: crashes, quarantine, corrupt checkpoints
# ---------------------------------------------------------------------------

def test_service_survives_crash_loop_like_the_reference(tmp_path):
    xs, ys = _data()
    base = _spec(t_config, checkpoint_every=4)
    ctrl = _service(tmp_path / "ctrl")
    _submit(ctrl, base, 20, "a")
    expect = ctrl.run_until_complete()["a"]

    crash = dataclasses.replace(base, fault_profile="crash_loop")
    chaos = _service(tmp_path / "chaos", fault_seed=5, max_retries=10)
    _submit(chaos, crash, 20, "a")
    trail = []
    while (rid := chaos.step()) is not None:
        run = chaos.runs[rid]
        trail.append((run.state.rounds_done, run.total_retries))
    got = chaos.runs["a"].result
    health = chaos.health_report()["a"]
    assert health["total_retries"] >= 1          # crashes actually fired
    assert not health["quarantined"]
    assert torch.equal(expect.theta, got.theta)

    ref_chaos = RefService(str(tmp_path / "ref"), fault_seed=5,
                           max_retries=10)
    ref_chaos.submit(_spec(ref_config, checkpoint_every=4,
                           fault_profile="crash_loop"), xs, ys, 20,
                     run_id="a")
    ref_trail = []
    while (rid := ref_chaos.step()) is not None:
        run = ref_chaos.runs[rid]
        ref_trail.append((run.state.rounds_done, run.total_retries))
    assert trail == ref_trail
    assert health["total_retries"] == \
        ref_chaos.health_report()["a"]["total_retries"]
    _same_rounds(got, ref_chaos.runs["a"].result)


def test_service_quarantines_hopeless_run_and_isolates_it(tmp_path):
    xs, ys = _data()
    dead = dict(fault_params=(("crash_prob", 1.0),))
    svc = _service(tmp_path / "port", max_retries=2)
    _submit(svc, _spec(t_config, **dead), 20, "dead")
    _submit(svc, _spec(t_config), 20, "ok")
    results = svc.run_until_complete()
    health = svc.last_health
    assert results["dead"] is None
    assert health["dead"]["quarantined"]
    assert health["dead"]["total_retries"] == 3   # max_retries + 1
    assert "InjectedCrashError" in health["dead"]["last_error"]
    assert results["ok"] is not None
    assert torch.equal(_port_solo(_spec(t_config), 20).theta,
                       results["ok"].theta)
    ref_svc = RefService(str(tmp_path / "ref"), max_retries=2)
    ref_svc.submit(_spec(ref_config, **dead), xs, ys, 20, run_id="dead")
    ref_svc.run_until_complete()
    want = ref_svc.last_health["dead"]
    for key in ("quarantined", "total_retries", "rounds_done", "last_error"):
        assert health["dead"][key] == want[key], key


def test_service_restart_falls_back_past_corrupt_checkpoints(tmp_path):
    """bad_disk corrupts checkpoints after writing; a restarted service
    must resume from the newest intact one and finish bit-identically."""
    base = _spec(t_config, checkpoint_every=4)
    ctrl = _service(tmp_path / "ctrl")
    _submit(ctrl, base, 20, "a")
    expect = ctrl.run_until_complete()["a"]

    disk_spec = dataclasses.replace(base, fault_profile="bad_disk")
    svc = _service(tmp_path / "disk", fault_seed=5)
    _submit(svc, disk_spec, 20, "a")
    svc.run_until_complete()
    ckpt_dir = str(tmp_path / "disk" / "a")
    assert t_ckpt.latest_checkpoint(ckpt_dir) \
        != t_ckpt.latest_checkpoint(ckpt_dir, valid_only=True)

    svc2 = _service(tmp_path / "disk")   # the restart
    run = _submit(svc2, disk_spec, 20, "a")
    assert run.resumed and run.fallback_resume
    got = svc2.run_until_complete()["a"]
    assert torch.equal(expect.theta, got.theta)
    assert t_api.histories_equal(expect.history, got.history)


def test_service_health_matches_the_reference(tmp_path):
    xs, ys = _data()
    spec = dict(fault_profile="flaky_clients", checkpoint_every=4)
    svc = _service(tmp_path / "port")
    _submit(svc, _spec(t_config, **spec), 20, "f")
    svc.run_until_complete()
    ref_svc = RefService(str(tmp_path / "ref"))
    ref_svc.submit(_spec(ref_config, **spec), xs, ys, 20, run_id="f")
    ref_svc.run_until_complete()
    got, want = svc.last_health["f"], ref_svc.last_health["f"]
    assert got["health"] is not None and got["health"]["returns_masked"] > 0
    for key in set(want) - {"timing"}:
        assert got[key] == want[key], key
    assert got["timing"]["blocks_run"] == want["timing"]["blocks_run"] == 5


# ---------------------------------------------------------------------------
# telemetry through the service
# ---------------------------------------------------------------------------

def test_service_health_timing_and_journal(tmp_path):
    xs, ys = _data()
    spec = _spec(t_config)
    svc = _service(tmp_path / "port")
    t_spans.enable()
    _submit(svc, spec, 8, "r0")
    while svc.step() is not None:
        pass
    timing = svc.health_report()["r0"]["timing"]
    assert timing["blocks_run"] == 2
    assert timing["block_seconds"] > 0
    assert timing["ckpt_save_seconds"] > 0
    assert timing["backoff_seconds"] == 0.0
    totals = t_spans.totals()
    assert totals["service/block"]["count"] == 2
    assert totals["service/ckpt_save"]["count"] == 2
    events = t_events.load_events(str(tmp_path / "port" / "r0"))
    assert [e["round"] for e in events] == list(range(8))
    # the reference's service journals the same bytes
    ref_spans.enable()
    ref_svc = RefService(str(tmp_path / "ref"))
    ref_svc.submit(_spec(ref_config), xs, ys, 8, run_id="r0")
    ref_svc.run_until_complete()
    name = t_events.EVENTS_NAME
    assert (tmp_path / "port" / "r0" / name).read_bytes() == \
        (tmp_path / "ref" / "r0" / name).read_bytes()


def test_service_forced_timings_without_spans_and_backoff(tmp_path):
    """The health timings are always measured; a retried block sleeps its
    backoff inside a forced span.  No journal without spans."""
    svc = _service(tmp_path, retry_backoff=1e-3, max_retries=10,
                   fault_seed=5)
    _submit(svc, _spec(t_config, fault_profile="crash_loop"), 20, "a")
    results = svc.run_until_complete()
    timing = svc.last_health["a"]["timing"]
    assert results["a"] is not None and svc.runs["a"].journal is None
    assert svc.last_health["a"]["total_retries"] >= 1
    assert timing["backoff_seconds"] >= 1e-3
    assert timing["block_seconds"] > 0 and timing["blocks_run"] == 5
    assert t_spans.totals() == {}


def test_service_journal_resumes_after_the_kill(tmp_path):
    t_spans.enable()
    control = _service(tmp_path / "control")
    _submit(control, _spec(t_config), 12, "j")
    control.run_until_complete()
    svc1 = _service(tmp_path / "killed")
    _submit(svc1, _spec(t_config), 12, "j")
    svc1.step()
    del svc1
    svc2 = _service(tmp_path / "killed")
    run = _submit(svc2, _spec(t_config), 12, "j")
    assert run.resumed and run.journal.rounds_logged == 4
    svc2.run_until_complete()
    name = t_events.EVENTS_NAME
    assert (tmp_path / "killed" / "j" / name).read_bytes() == \
        (tmp_path / "control" / "j" / name).read_bytes()


# ---------------------------------------------------------------------------
# resilience runner and the service example
# ---------------------------------------------------------------------------

RESILIENCE_ITERS = 12      # the reference's default is 40


def test_run_resilience_matches_reference():
    n, l = 10, 24                       # run_resilience's default clients
    u = max(1, int(round(0.25 * n * l)))
    srv_u = max(1, int(round(ref_config.FLConfig().delta * 8 * 24)))
    got = t_res.run_resilience(
        iters=RESILIENCE_ITERS, device="cpu",
        parity_generators=carry.generators_from_reference(
            _reference_generators(u, n, l, 0), device="cpu"),
        service_parity_generators=carry.generators_from_reference(
            _reference_generators(srv_u, 8, 24, 3), device="cpu"))
    want = ref_res.run_resilience(iters=RESILIENCE_ITERS)
    assert t_res.validate_resilience(got) == []
    assert ref_res.validate_resilience(want) == []
    assert t_res.DEFAULT_FAULT_PROFILES == ref_res.DEFAULT_FAULT_PROFILES
    assert got["config"] == dict(want["config"], device="cpu")
    for prof, case in want["cases"].items():
        mine = got["cases"][prof]
        for variant in ("coded", "naive", "naive_unguarded"):
            g, w = mine[variant], case[variant]
            for key in set(w) - {"final_loss"}:
                assert g[key] == w[key], (prof, variant, key)
            np.testing.assert_allclose(g["final_loss"], w["final_loss"],
                                       rtol=0, atol=LOSS_ATOL)
        assert mine["coded_speedup_vs_naive"] == \
            case["coded_speedup_vs_naive"]
    for key in set(want["service"]) - {"host_seconds"}:
        assert got["service"][key] == want["service"][key], key
    broken = dict(got, service=dict(got["service"], crash_retries=0))
    assert t_res.validate_resilience(broken) == \
        ref_res.validate_resilience(broken)


def test_service_multiplex_launcher(tmp_path):
    lines = []
    got = t_multiplex.main(device="cpu", root=str(tmp_path / "runs"),
                           out=lines.append)
    assert got["identical"] == {rid: True for rid in t_multiplex.jobs()}
    assert got["resumed_at"] == {"coded-static": 60, "greedy-static": 50,
                                 "adaptive-drift": 40}
    assert len(got["steps"]) == t_multiplex.KILL_AFTER
    assert sum("bit-identical to uninterrupted = True" in ln
               for ln in lines) == 3


@pytest.mark.cuda
def test_service_job_on_the_card_matches_the_cpu(tmp_path):
    """A coded and a naive job through a service on the card: the same
    rounds as the CPU service, theta within the card tolerance of
    chip_smoke.py (relative 1e-4), and a resume on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = {}
    for dev in ("cuda", "cpu"):
        svc = ExperimentService(str(tmp_path / dev), device=dev)
        for rid, scheme in (("c", "coded"), ("n", "naive")):
            _submit(svc, _spec(t_config, scheme), 12, rid)
        svc.step()
        out[dev] = ExperimentService(str(tmp_path / dev), device=dev)
        for rid, scheme in (("c", "coded"), ("n", "naive")):
            _submit(out[dev], _spec(t_config, scheme), 12, rid)
        out[dev] = out[dev].run_until_complete()
    for rid in ("c", "n"):
        gpu, cpu = out["cuda"][rid], out["cpu"][rid]
        assert gpu.theta.device.type == "cuda"
        for f in ("wall_clock", "returned", "n_masked", "skipped"):
            assert [getattr(h, f) for h in gpu.history] == \
                [getattr(h, f) for h in cpu.history], f
        tol = 1e-4 * max(1.0, float(cpu.theta.abs().max()))
        assert float((gpu.theta.cpu() - cpu.theta).abs().max()) <= tol
