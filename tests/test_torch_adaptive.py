"""Channel-traced runs and the adaptive schemes of the PyTorch port against
the JAX reference, on the CPU.

The same client data (NumPy, from a seed) goes through both packages at
the size of ``examples/adaptive_drift.py`` (n = 10, l = 24, q = 32, c = 3);
the reference's ``jax.random`` draws (the parity generator key chain, the
RFF frequencies) are carried over with ``repro_torch.carry``.  Held to:

  * bit-identical: the wall clock, the returned counts and every field of
    the adaptive schedule (delays, availability, sub-block indices, loads
    and t* of every re-plan, wait counts, estimates, masks): all host
    NumPy, the same code on the same generators;
  * theta within atol 1e-5 and eval losses within rtol 1e-4, atol 1e-5,
    the tolerances of ``tests/test_torch_engine.py``;
  * a channel or adaptive checkpoint either package writes resumes in the
    other; port kill/resume is bit-identical to the uninterrupted run;
  * the static profile is the stationary run, bit for bit.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import config as ref_config
from repro.checkpoint import io as ref_ckpt
from repro.core import encoding as ref_enc
from repro.core.run_state import pack_state as ref_pack

from repro_torch import api as t_api
from repro_torch import carry
from repro_torch import config as t_config
from repro_torch.checkpoint import io as t_ckpt
from repro_torch.core import run_state as t_rs
from repro_torch.launch import adaptive_drift

N, L, Q, C = 10, 24, 32, 3
D = 8                     # raw features of the fused_embed case
SEED = 0
ROUNDS = 16
EVERY = 4


def _data(seed=0, d=Q):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(N, L, d)).astype(np.float32) * 0.3
    ys = rng.normal(size=(N, L, C)).astype(np.float32)
    return xs, ys


def _spec(mod, scheme="coded", delta=0.25, **over):
    """A spec of `mod`'s package; ``rff`` may be given as a dict."""
    fl = mod.FLConfig(n_clients=N, delta=delta, psi=0.2, seed=SEED)
    tc = mod.TrainConfig(learning_rate=0.5, l2_reg=1e-4,
                         lr_decay_epochs=(9,))
    base = dict(fl=fl, train=tc, scheme=scheme)
    base.update(over)
    if isinstance(base.get("rff"), dict):
        base["rff"] = mod.RFFConfig(**base["rff"])
    return mod.ExperimentSpec(**base)


@functools.lru_cache(maxsize=None)
def _reference_generators(u):
    """The reference's per-client generators: the split chain of
    ``CodedScheme.setup`` from PRNGKey(seed + 99)."""
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(SEED + 99), None,
                           length=N)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, L))(keys))


def _port(spec, xs=None, ys=None, u=None, rff_draw=None):
    """The port's experiment; the coded family takes the reference's
    generators for u parity rows."""
    if xs is None:
        xs, ys = _data()
    gens = None if u is None else carry.generators_from_reference(
        _reference_generators(u), device="cpu")
    return t_api.build_experiment(spec, xs, ys, device="cpu",
                                  parity_generators=gens,
                                  rff_draw=rff_draw)


def _pair(scheme="coded", xs=None, ys=None, **over):
    """(reference experiment, port experiment) of one deployment."""
    if xs is None:
        xs, ys = _data()
    ref_exp = ref_api.build_experiment(_spec(ref_config, scheme, **over),
                                       xs, ys)
    u = ref_exp.u if ref_exp.scheme_obj.coded else None
    rff_draw = None
    if ref_exp.fused_embed:
        rff_draw = carry.rff_from_reference(
            np.asarray(ref_exp.omega), np.asarray(ref_exp.delta),
            device="cpu")
    return ref_exp, _port(_spec(t_config, scheme, **over), xs, ys, u,
                          rff_draw)


def _loss_fn(theta):
    th = (theta.cpu().numpy() if isinstance(theta, torch.Tensor)
          else np.asarray(theta))
    return float(np.abs(th.astype(np.float64)).sum()), 0.0


def _np(theta):
    return (theta.cpu().numpy() if isinstance(theta, torch.Tensor)
            else np.asarray(theta))


def _same_host(got, want):
    """Bit-identical host quantities of two FedResults."""
    assert [h.wall_clock for h in got.history] == \
        [h.wall_clock for h in want.history]
    assert [h.returned for h in got.history] == \
        [h.returned for h in want.history]
    assert got.t_star == want.t_star
    np.testing.assert_array_equal(got.loads, want.loads)


def _close(got, want):
    np.testing.assert_allclose(_np(got.theta), _np(want.theta), atol=1e-5)
    for hg, hw in zip(got.history, want.history):
        np.testing.assert_allclose(hg.loss, hw.loss, rtol=1e-4, atol=1e-5)


def _same_result(a, b):
    """Bit-identical port results (theta, history, health)."""
    assert torch.equal(a.theta, b.theta)
    for ha, hb in zip(a.history, b.history):
        assert ha.wall_clock == hb.wall_clock
        assert ha.returned == hb.returned
        assert (ha.loss == hb.loss
                or (np.isnan(ha.loss) and np.isnan(hb.loss)))
    assert a.health == b.health


def _same_schedule(got, want):
    """Field for field: the NumPy fields bit-identical, the masks too."""
    for f in ("times", "active", "block_idx", "loads_blocks", "t_star",
              "n_wait"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert np.asarray(g).dtype == np.asarray(w).dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.n_blocks == want.n_blocks
    assert len(got.estimates) == len(want.estimates)
    for eg, ew in zip(got.estimates, want.estimates):
        assert eg["rounds_seen"] == ew["rounds_seen"]
        for key in ("mu", "tau", "p", "avail"):
            np.testing.assert_array_equal(eg[key], ew[key])
    assert (got.gmask_blocks is None) == (want.gmask_blocks is None)
    if want.gmask_blocks is not None:
        np.testing.assert_array_equal(got.gmask_blocks.numpy(),
                                      np.asarray(want.gmask_blocks))


def _ckpt(tmp_path, rounds_done):
    return str(tmp_path / f"{t_ckpt.CKPT_PREFIX}{rounds_done:06d}.npz")


# ------------------------------------------------ static = stationary run
@pytest.mark.parametrize("scheme", ["coded", "naive", "greedy", "ideal"])
def test_static_channel_bit_identical_to_no_channel(scheme):
    plain = _port(_spec(t_config, scheme), u=None)
    traced = _port(_spec(t_config, scheme, channel_profile="static"))
    assert traced.channel.is_static and plain.channel is None
    res_p = plain.run(10, eval_fn=_loss_fn, eval_every=1)
    res_t = traced.run(10, eval_fn=_loss_fn, eval_every=1)
    _same_result(res_p, res_t)
    assert res_t.t_star == res_p.t_star


# ------------------------------------------- channel runs vs the reference
_CHANNEL_CASES = {
    f"{scheme}-{prof}": dict(scheme=scheme, channel_profile=prof)
    for prof in ("drift_churn", "churn")
    for scheme in ("coded", "naive", "greedy", "ideal")}
_CHANNEL_CASES.update({
    "unfused-drift_churn": dict(scheme="coded", fused_coded=False,
                                channel_profile="drift_churn"),
    "fused_embed-drift_churn": dict(
        scheme="coded", channel_profile="drift_churn", fused_embed=True,
        rff=dict(q=Q, sigma=2.0, seed=5)),
    "markov_loss-params": dict(scheme="greedy", channel_profile="markov_loss",
                               channel_params={"ge_bad_scale": 3.0}),
})


@pytest.mark.parametrize("case", list(_CHANNEL_CASES))
def test_channel_run_matches_reference(case):
    kw = dict(_CHANNEL_CASES[case])
    xs, ys = _data(d=D) if kw.get("fused_embed") else _data()
    ref_exp, t_exp = _pair(kw.pop("scheme"), xs, ys, **kw)
    want = ref_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1)
    got = t_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1)
    _same_host(got, want)
    _close(got, want)
    assert got.health == t_api.RunHealth(0, 0, 0, 1.0)


def test_channel_params_override_profile():
    exp = _port(_spec(t_config, "naive", channel_profile="churn",
                      channel_params={"dropout_prob": 0.0}))
    assert exp.channel.dropout_prob == 0.0
    assert exp.channel.rejoin_prob == 0.25


# --------------------------------------------- adaptive vs the reference
_ADAPTIVE_CASES = {
    "adaptive_coded-degrade_drift": dict(
        scheme="adaptive_coded", channel_profile="degrade_drift",
        adapt_every=EVERY),
    "adaptive_greedy-churn": dict(
        scheme="adaptive_greedy", channel_profile="churn",
        channel_params={"dropout_prob": 0.4, "rejoin_prob": 0.05},
        adapt_every=EVERY),
    "adaptive_coded-window": dict(
        scheme="adaptive_coded", channel_profile="drift_churn",
        adapt_every=EVERY, checkpoint_every=2 * EVERY,
        scheme_params={"est_window": 6, "avail_min": 0.7}),
    "adaptive_coded-no_channel": dict(scheme="adaptive_coded",
                                      adapt_every=5),
}


@pytest.mark.parametrize("case", list(_ADAPTIVE_CASES))
def test_adaptive_run_matches_reference(case):
    kw = dict(_ADAPTIVE_CASES[case])
    ref_exp, t_exp = _pair(kw.pop("scheme"), **kw)
    want = ref_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1)
    got = t_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1)
    _same_host(got, want)
    _close(got, want)
    _same_schedule(t_exp.last_schedule, ref_exp.last_schedule)
    assert t_exp.scheme_params_estimator_kwargs() == \
        ref_exp.scheme_params_estimator_kwargs()


_ALL_OUT = {"dropout_prob": 1.0, "rejoin_prob": 0.0}


@pytest.mark.parametrize("scheme", ["naive", "greedy", "coded", "ideal",
                                    "adaptive_greedy", "adaptive_coded"])
def test_every_client_churned_out(scheme):
    """From round 1 on no client is present: nothing returns, the greedy
    and naive deadlines are 0, and the adaptive_coded re-plan falls back
    to full caps (every client estimated unavailable)."""
    kw = dict(channel_profile="churn", channel_params=_ALL_OUT)
    if scheme.startswith("adaptive"):
        kw["adapt_every"] = 3
    ref_exp, t_exp = _pair(scheme, **kw)
    want = ref_exp.run(8)
    got = t_exp.run(8)
    _same_host(got, want)
    _close(got, want)
    returned = [h.returned for h in got.history]
    assert returned[0] > 0 and returned[1:] == [0] * 7
    if scheme in ("naive", "greedy", "adaptive_greedy"):
        wall = [h.wall_clock for h in got.history]
        assert wall[1:] == [wall[0]] * 7
    if scheme.startswith("adaptive"):
        _same_schedule(t_exp.last_schedule, ref_exp.last_schedule)


def test_replan_raises_a_load_past_the_setup_l_max():
    """adaptive_coded's client rows hold every point in priority order, not
    zero padding past the setup's largest load: a re-plan that raises a
    load above it must see those rows (live_rows = (l, u)).  Twice the
    redundancy on a uniform network keeps every setup load below l; churn
    then moves load onto the clients still present."""
    ref_exp, t_exp = _pair(
        "adaptive_coded", delta=0.5, delay_profile="uniform",
        channel_profile="churn", adapt_every=EVERY,
        channel_params={"dropout_prob": 0.3, "rejoin_prob": 0.1})
    l_max = int(t_exp.loads.max())
    consts = t_exp.build_consts()
    assert consts["live_rows"] == (L, t_exp.u)
    assert l_max < L and torch.count_nonzero(
        consts["gx"][:N, l_max:]).item() > 0
    want = ref_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1)
    got = t_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1)
    sched = t_exp.last_schedule
    assert sched.loads_blocks.max() > l_max
    _same_schedule(sched, ref_exp.last_schedule)
    _same_host(got, want)
    _close(got, want)


# ---------------------------------------------------------- kill / resume
_KILL_CASES = {
    "coded-drift_churn": dict(scheme="coded", channel_profile="drift_churn"),
    "greedy-markov_loss": dict(scheme="greedy",
                               channel_profile="markov_loss"),
    "adaptive_coded": dict(scheme="adaptive_coded",
                           channel_profile="degrade_drift",
                           adapt_every=EVERY),
    "adaptive_greedy": dict(scheme="adaptive_greedy",
                            channel_profile="churn", adapt_every=2),
}


@pytest.mark.parametrize("case", list(_KILL_CASES))
def test_port_kill_and_resume_bit_identical(case, tmp_path):
    kw = dict(_KILL_CASES[case])
    spec = _spec(t_config, kw.pop("scheme"), checkpoint_every=EVERY, **kw)
    control_exp = _port(spec)
    control = control_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1)
    interrupted = _port(spec)
    state = interrupted.run_block(interrupted.init_state(ROUNDS,
                                                         collect=True),
                                  eval_fn=_loss_fn, eval_every=1)
    path = interrupted.save_state(_ckpt(tmp_path, EVERY), state)
    assert os.path.exists(path)
    del interrupted, state       # the kill
    resumed_exp = _port(spec)
    resumed = resumed_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1,
                              checkpoint_dir=str(tmp_path), resume=True)
    _same_result(control, resumed)
    if control_exp.last_schedule is not None:
        _same_schedule(resumed_exp.last_schedule, control_exp.last_schedule)


def test_packed_adaptive_state_matches_reference_layout():
    """After one block of adaptive_coded: the same keys, dtypes and shapes,
    equal host arrays (trace, estimator, controls, schedule) and equal
    meta (RNG states included)."""
    ref_exp, t_exp = _pair("adaptive_coded", channel_profile="drift_churn",
                           adapt_every=EVERY, checkpoint_every=2 * EVERY)
    ref_state = ref_exp.run_block(ref_exp.init_state(ROUNDS))
    t_state = t_exp.run_block(t_exp.init_state(ROUNDS))
    ref_arrays, ref_meta = ref_pack(ref_state)
    t_arrays, t_meta = t_rs.pack_state(t_state)
    assert t_meta == ref_meta
    assert sorted(t_arrays) == sorted(ref_arrays)
    assert any(k.startswith("sched/") for k in t_arrays)
    for key, want in ref_arrays.items():
        got = t_arrays[key]
        assert (got.dtype, got.shape) == (want.dtype, want.shape), key
        if key == "theta":
            np.testing.assert_allclose(got, want, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    back = t_rs.unpack_state(t_arrays, t_meta, device="cpu")
    assert back.trace.rng_state == t_state.trace.rng_state
    assert back.controls["t_star"] == t_state.controls["t_star"]
    for key, val in t_state.sched.items():
        np.testing.assert_array_equal(back.sched[key], val, err_msg=key)


@pytest.mark.parametrize("scheme", ["adaptive_coded", "coded"])
def test_reference_checkpoint_resumes_in_the_port(scheme, tmp_path):
    kw = dict(channel_profile="drift_churn", checkpoint_every=EVERY)
    if scheme == "adaptive_coded":
        kw["adapt_every"] = EVERY
    ref_exp, _ = _pair(scheme, **kw)
    control = ref_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1)
    writer, t_exp = _pair(scheme, **kw)
    state = writer.run_block(writer.init_state(ROUNDS, collect=True),
                             eval_fn=_loss_fn, eval_every=1)
    writer.save_state(_ckpt(tmp_path, state.rounds_done), state)
    resumed = t_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1,
                        checkpoint_dir=str(tmp_path), resume=True)
    _same_host(resumed, control)
    _close(resumed, control)
    if scheme == "adaptive_coded":
        _same_schedule(t_exp.last_schedule, ref_exp.last_schedule)
    ref_ckpt.restore_state(_ckpt(tmp_path, ROUNDS))     # digest verified


@pytest.mark.parametrize("scheme", ["adaptive_greedy", "adaptive_coded",
                                    "naive"])
def test_port_checkpoint_resumes_in_the_reference(scheme, tmp_path):
    kw = dict(channel_profile="churn", checkpoint_every=EVERY)
    if scheme.startswith("adaptive"):
        kw["adapt_every"] = 2
    _, t_exp = _pair(scheme, **kw)
    control = t_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1)
    ref_exp, writer = _pair(scheme, **kw)
    state = writer.run_block(writer.init_state(ROUNDS, collect=True),
                             eval_fn=_loss_fn, eval_every=1)
    path = writer.save_state(_ckpt(tmp_path, state.rounds_done), state)
    ref_ckpt.restore_state(path, verify=True)
    resumed = ref_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1,
                          checkpoint_dir=str(tmp_path), resume=True)
    _same_host(resumed, control)
    _close(resumed, control)
    if scheme.startswith("adaptive"):
        _same_schedule(t_exp.last_schedule, ref_exp.last_schedule)


def test_trace_stream_cursor_lives_in_the_state(tmp_path):
    """Each run reserves a fresh trace stream; a restored state replays
    its own stream and bumps the cursor past it, as in the reference."""
    spec = _spec(t_config, "naive", channel_profile="slow_fade",
                 checkpoint_every=EVERY)
    exp = _port(spec)
    first = exp.init_state(ROUNDS)
    second = exp.init_state(ROUNDS)
    assert (first.trace_call, second.trace_call) == (0, 1)
    exp.save_state(_ckpt(tmp_path, 0), second)
    fresh = _port(spec)
    restored = fresh.restore_state(_ckpt(tmp_path, 0))
    assert restored.trace_call == 1 and fresh._trace_calls == 2
    assert fresh.init_state(ROUNDS).trace_call == 2
    multi = fresh.init_state(4, n_realizations=3)
    assert (multi.mode, multi.trace_call, fresh._trace_calls) == \
        ("multi_channel", 3, 6)


# --------------------------------------------------------------- run_multi
@pytest.mark.parametrize("scheme,profile", [("naive", "slow_fade"),
                                            ("coded", "drift_churn"),
                                            ("adaptive_greedy", "churn")])
def test_channel_run_multi_matches_reference(scheme, profile):
    kw = dict(channel_profile=profile)
    if scheme.startswith("adaptive"):
        kw["adapt_every"] = EVERY
    ref_exp, t_exp = _pair(scheme, **kw)
    acc = lambda th: (0.0, float(np.abs(_np(th)).sum()))  # noqa: E731
    want = ref_exp.run_multi(8, 3, eval_fn=acc)
    got = t_exp.run_multi(8, 3, eval_fn=acc)
    assert got.wall_clock.shape == (3, 8)
    np.testing.assert_array_equal(got.wall_clock, want.wall_clock)
    np.testing.assert_array_equal(got.returned, want.returned)
    np.testing.assert_allclose(_np(got.theta), np.asarray(want.theta),
                               atol=1e-5)
    np.testing.assert_allclose(got.accuracy, want.accuracy, rtol=1e-5)
    assert dataclasses.astuple(got.health) == \
        dataclasses.astuple(want.health)
    if scheme.startswith("adaptive"):
        _same_schedule(t_exp.last_schedule, ref_exp.last_schedule)
    if scheme != "coded":      # a coded round costs t*, whatever the trace
        assert np.std(got.wall_clock[:, -1]) > 0.0


def test_channel_run_multi_kill_and_resume(tmp_path):
    spec = _spec(t_config, "greedy", channel_profile="drift_churn")
    control = _port(spec).run_multi(6, 3)
    exp = _port(spec)
    state = exp.run_block(exp.init_state(6, n_realizations=3))
    assert state.mode == "multi_channel" and state.realizations_done == 1
    exp.save_state(_ckpt(tmp_path, state.rounds_done), state)
    resumed = _port(spec).run_multi(6, 3, checkpoint_dir=str(tmp_path),
                                    resume=True)
    assert torch.equal(control.theta, resumed.theta)
    np.testing.assert_array_equal(control.wall_clock, resumed.wall_clock)
    np.testing.assert_array_equal(control.returned, resumed.returned)


# ----------------------------------------------------- the spec refusals
_REFUSALS = [
    ("adaptive-without-adapt_every", "ValueError",
     lambda mod: dict(scheme="adaptive_coded")),
    ("adaptive-legacy", "ValueError",
     lambda mod: dict(scheme="adaptive_greedy", adapt_every=2,
                      engine="legacy")),
    ("adaptive-unfused", "ValueError",
     lambda mod: dict(scheme="adaptive_coded", adapt_every=2,
                      fused_coded=False)),
    ("adaptive-fused_embed", "NotImplementedError",
     lambda mod: dict(scheme="adaptive_coded", adapt_every=2,
                      fused_embed=True, rff=mod.RFFConfig(q=Q))),
    ("checkpoint-not-a-multiple", "ValueError",
     lambda mod: dict(scheme="adaptive_coded", adapt_every=3,
                      checkpoint_every=4)),
    ("unknown-profile", "ValueError",
     lambda mod: dict(channel_profile="hurricane")),
    ("bad-channel_params", "ValueError",
     lambda mod: dict(channel_profile="static",
                      channel_params={"not_a_knob": 1})),
    ("bad-channel-value", "ValueError",
     lambda mod: dict(channel_params={"dropout_prob": 2.0})),
    ("legacy-channel", "ValueError",
     lambda mod: dict(engine="legacy", channel_profile="churn")),
    ("hier-channel", "ValueError",
     lambda mod: dict(hier_shards=2, channel_profile="churn")),
    ("hier-adapt_every", "ValueError",
     lambda mod: dict(hier_shards=2, adapt_every=2)),
    ("hier-mesh", "ValueError",
     lambda mod: dict(hier_shards=2, mesh=2)),
    ("hier-shards-exceed-clients", "ValueError",
     lambda mod: dict(hier_shards=N + 1)),
    ("negative-adapt_every", "ValueError",
     lambda mod: dict(adapt_every=-1)),
    ("est_beta-out-of-range", "ValueError",
     lambda mod: dict(scheme="adaptive_coded", adapt_every=2,
                      scheme_params={"est_beta": 1.5})),
    ("est_window-zero", "ValueError",
     lambda mod: dict(scheme="adaptive_greedy", adapt_every=2,
                      scheme_params={"est_window": 0})),
]


def _refused(mod, api, kw, device):
    """The exception type name a spec raises, when made, built or run."""
    xs, ys = _data(d=Q)
    try:
        spec = _spec(mod, **{"scheme": "coded", **kw})
        exp = api.build_experiment(spec, xs, ys, **device)
        exp.run(2)
    except (ValueError, NotImplementedError) as exc:
        return type(exc).__name__
    return None


@pytest.mark.parametrize("kw,error", [(k, e) for _, e, k in _REFUSALS],
                         ids=[i for i, _, _ in _REFUSALS])
def test_refusals_mirror_the_reference(kw, error):
    assert _refused(ref_config, ref_api, kw(ref_config), {}) == error
    assert _refused(t_config, t_api, kw(t_config), {"device": "cpu"}) \
        == error


def test_spec_round_trip_and_registry_match_reference():
    specs = [_spec(mod, "adaptive_coded", adapt_every=7,
                   channel_profile="drift_churn",
                   channel_params={"dropout_prob": 0.01})
             for mod in (ref_config, t_config)]
    assert specs[1].to_dict() == specs[0].to_dict()
    revived = t_config.ExperimentSpec.from_dict(
        json.loads(json.dumps(specs[0].to_dict())))
    assert revived == specs[1] and hash(revived) == hash(specs[1])
    assert dataclasses.asdict(revived.resolved_channel()) == \
        dataclasses.asdict(specs[0].resolved_channel())
    assert _spec(t_config).resolved_channel() is None
    assert t_api.registered_names() == ref_api.registered_names()
    assert t_api.grid_names() == ref_api.grid_names()
    assert t_api.CHANNEL_PROFILES.keys() == ref_api.CHANNEL_PROFILES.keys()
    for name in ("adaptive_coded", "adaptive_greedy"):
        scheme = t_api.get_scheme(name)
        assert scheme.step_kind == name and not scheme.grid
    assert t_api.get_scheme("adaptive_coded").coded
    with pytest.raises(NotImplementedError, match="not adaptive"):
        t_api.get_scheme("coded").replan(None, None)
    # with a client mesh both packages refuse the adaptive spec alike
    xs, ys = _data()
    msgs = []
    for spec, api, extra in ((specs[0], ref_api, {}),
                             (specs[1], t_api, {"device": "cpu"})):
        with pytest.raises(NotImplementedError, match="client-mesh") as info:
            api.build_experiment(spec, xs, ys, mesh=1, **extra)
        msgs.append(str(info.value))
    assert msgs[1] == msgs[0]


# ------------------------------------------------------ the example's port
def test_adaptive_drift_matches_reference(capsys):
    """The port of ``examples/adaptive_drift.py`` prints the reference
    script's table, given the reference's generators."""
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "examples"))
    try:
        import adaptive_drift as ref_example
    finally:
        sys.path.remove(str(root / "examples"))
    ref_example.main()
    want = capsys.readouterr().out.splitlines()
    fl = t_config.FLConfig(n_clients=10, delta=0.25, psi=0.2, seed=0)
    u = max(1, int(round(fl.delta * 10 * 24)))
    gens = carry.generators_from_reference(_reference_generators(u),
                                           device="cpu")
    lines = []
    got = adaptive_drift.main(device="cpu", parity_generators=gens,
                              out=lines.append)
    assert "\n".join(lines).splitlines() == want
    sched = got["schedule"]
    assert sched.n_blocks == adaptive_drift.ITERS // adaptive_drift.ADAPT_EVERY
    assert got["t_target"]["adaptive"] < got["t_target"]["static"]


def test_net_modules_import_neither_jax_nor_repro():
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "import repro_torch.net, repro_torch.net.estimator\n"
        "import repro_torch.launch.adaptive_drift, repro_torch.api\n"
        "import repro_torch.core.fed_runtime, repro_torch.core.run_state\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root, timeout=120)
