"""The port's network layer (``repro_torch.net``) against the JAX package's
(``repro.net``), on the CPU.

Both are NumPy: the same code on the same ``np.random.Generator`` state,
so every output is held BIT-identical (``assert_array_equal``, dtypes
too): channel profiles and their validation, the MCS rate table, traces of
every registered profile (one-shot and chained block by block through
`TraceState`), the traced observations and delays, and the online
estimator in its EWMA and windowed modes with its ``state_dict`` round
trip between packages.  Under the static profile the traced sampler must
equal ``sample_round_times`` of the same generator state.
"""
import copy
import dataclasses

import numpy as np
import pytest

from repro.core import delay_model as ref_dm
from repro.net import channel as ref_channel
from repro.net import estimator as ref_est
from repro.net import trace as ref_trace

from repro_torch.core import delay_model as t_dm
from repro_torch.net import channel as t_channel
from repro_torch.net import estimator as t_est
from repro_torch.net import trace as t_trace

N = 7
PROFILES = list(ref_channel.CHANNEL_PROFILES)


def _nodes(mod, n=N, seed=4, asym=True):
    """A seeded heterogeneous population; every third node has its own
    uplink (tau_up, p_up) when `asym`."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(n):
        kw = dict(mu=float(rng.uniform(2, 20)),
                  alpha=float(rng.uniform(0.5, 4)),
                  tau=float(rng.uniform(0.01, 0.2)),
                  p=float(rng.uniform(0, 0.3)))
        if asym and j % 3 == 0:
            kw.update(tau_up=float(rng.uniform(0.02, 0.4)),
                      p_up=float(rng.uniform(0, 0.4)))
        out.append(mod.NodeDelayParams(**kw))
    return out


def _same(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _same_trace(got, want):
    for f in ("mu_mult", "tau_mult", "p_down", "p_up", "active"):
        _same(getattr(got, f), getattr(want, f), f)
    assert got.profile == t_channel.ChannelProfile(
        **dataclasses.asdict(want.profile))


def _same_state(got, want):
    assert got.rng_state == want.rng_state
    assert got.rounds_done == want.rounds_done
    for f in ("ge_bad", "shadow_x", "drift_g", "churn_active"):
        _same(getattr(got, f), getattr(want, f), f)


def _profiles(name):
    return (t_channel.CHANNEL_PROFILES[name],
            ref_channel.CHANNEL_PROFILES[name])


# ------------------------------------------------------------ channel.py
def test_profile_registry_matches_reference():
    assert list(t_channel.CHANNEL_PROFILES) == PROFILES
    for name in PROFILES:
        t_prof, ref_prof = _profiles(name)
        assert dataclasses.asdict(t_prof) == dataclasses.asdict(ref_prof)
        for pred in ("has_erasure_dynamics", "has_shadowing",
                     "has_compute_drift", "has_churn", "is_static"):
            assert getattr(t_prof, pred) == getattr(ref_prof, pred), \
                (name, pred)
    assert t_channel.CHANNEL_PROFILES["static"].is_static


def test_mcs_table_and_mapping_bit_identical():
    _same(t_channel.MCS_SNR_DB, ref_channel.MCS_SNR_DB)
    _same(t_channel.MCS_EFFICIENCY, ref_channel.MCS_EFFICIENCY)
    snr = np.linspace(-20.0, 40.0, 1201)
    _same(t_channel.mcs_efficiency(snr), ref_channel.mcs_efficiency(snr))
    assert t_channel.mcs_efficiency(3.1) == ref_channel.mcs_efficiency(3.1)


_BAD = [
    dict(ge_p_gb=1.5), dict(ge_p_bg=-0.1), dict(dropout_prob=2.0),
    dict(rejoin_prob=-1.0), dict(shadow_rho=1.01), dict(ge_bad_scale=-1.0),
    dict(shadow_sigma_db=-0.5), dict(mu_drift_sigma=-0.1),
    dict(mu_drift_rate=-1.0), dict(mu_min=0.0), dict(mu_min=1.5),
    dict(mu_max=0.5), dict(p_cap=1.0), dict(p_cap=0.0),
]


@pytest.mark.parametrize("kw", _BAD, ids=[next(iter(k)) + f"={v}"
                                          for k in _BAD
                                          for v in k.values()])
def test_profile_validation_errors_match_reference(kw):
    with pytest.raises(ValueError) as ref_err:
        ref_channel.ChannelProfile(**kw)
    with pytest.raises(ValueError) as t_err:
        t_channel.ChannelProfile(**kw)
    assert str(t_err.value) == str(ref_err.value)


# -------------------------------------------------------------- trace.py
@pytest.mark.parametrize("name", PROFILES)
def test_trace_and_chained_blocks_bit_identical(name):
    """One-shot traces, and a run cut into blocks of 7, 5 and 8 rounds
    chained through TraceState, equal the reference's array for array;
    the generator ends at the same position."""
    t_prof, ref_prof = _profiles(name)
    t_nodes, ref_nodes = _nodes(t_dm), _nodes(ref_dm)
    t_rng, ref_rng = (np.random.default_rng((11, 3)) for _ in range(2))
    got = t_trace.generate_trace(t_nodes, t_prof, 20, t_rng)
    want = ref_trace.generate_trace(ref_nodes, ref_prof, 20, ref_rng)
    _same_trace(got, want)
    assert got.rounds == 20 and got.n == N
    assert t_rng.bit_generator.state == ref_rng.bit_generator.state
    _same_trace(got.slice(4, 9), want.slice(4, 9))

    t_state = t_trace.TraceState.init(N, np.random.default_rng((11, 4)))
    ref_state = ref_trace.TraceState.init(N, np.random.default_rng((11, 4)))
    _same_state(t_state, ref_state)
    for rounds in (7, 5, 8):
        snapshot = copy.deepcopy(t_state)
        got, t_state = t_trace.generate_trace_block(t_nodes, t_prof, rounds,
                                                    t_state)
        want, ref_state = ref_trace.generate_trace_block(
            ref_nodes, ref_prof, rounds, ref_state)
        _same_trace(got, want)
        _same_state(t_state, ref_state)
        # the input state is not mutated: replaying it gives the block again
        again, _ = t_trace.generate_trace_block(t_nodes, t_prof, rounds,
                                                snapshot)
        _same_trace(again, got)
    assert t_state.rounds_done == 20


@pytest.mark.parametrize("name", PROFILES)
def test_observations_and_traced_delays_bit_identical(name):
    """Observations with fixed (n,) loads and with per-round (R, n) loads,
    and the traced delays, from equal generator states."""
    t_prof, ref_prof = _profiles(name)
    t_nodes, ref_nodes = _nodes(t_dm), _nodes(ref_dm)
    R = 12
    t_tr = t_trace.generate_trace(t_nodes, t_prof, R,
                                  np.random.default_rng(5))
    ref_tr = ref_trace.generate_trace(ref_nodes, ref_prof, R,
                                      np.random.default_rng(5))
    loads = np.arange(N, dtype=np.float64) * 3.0          # node 0 unloaded
    loads_rn = np.random.default_rng(6).integers(0, 30, (R, N)).astype(
        np.float64)
    for ld in (loads, loads_rn):
        t_rng, ref_rng = (np.random.default_rng(8) for _ in range(2))
        got = t_trace.sample_round_observations(t_nodes, ld, t_rng, t_tr)
        want = ref_trace.sample_round_observations(ref_nodes, ld, ref_rng,
                                                   ref_tr)
        for f in ("total", "t_down", "t_up", "t_comp", "n_down", "n_up",
                  "active", "loads"):
            _same(getattr(got, f), getattr(want, f), f)
        assert t_rng.bit_generator.state == ref_rng.bit_generator.state
        _same(t_trace.sample_round_times_traced(
                  t_nodes, ld, np.random.default_rng(9), t_tr),
              ref_trace.sample_round_times_traced(
                  ref_nodes, ld, np.random.default_rng(9), ref_tr))
    with pytest.raises(ValueError, match="loads shape"):
        t_trace.sample_round_observations(t_nodes, loads[:3],
                                          np.random.default_rng(0), t_tr)
    with pytest.raises(ValueError, match="rounds"):
        t_trace.generate_trace_block(t_nodes, t_prof, 0,
                                     t_trace.TraceState.init(
                                         N, np.random.default_rng(0)))


@pytest.mark.parametrize("asym", [False, True])
def test_static_traced_sampling_equals_sample_round_times(asym):
    nodes = _nodes(t_dm, asym=asym)
    loads = np.linspace(0.0, 40.0, N)
    trace = t_trace.generate_trace(nodes, t_channel.CHANNEL_PROFILES["static"],
                                   15, np.random.default_rng(1))
    assert (trace.mu_mult == 1.0).all() and (trace.tau_mult == 1.0).all()
    assert trace.active.all()
    got = t_trace.sample_round_times_traced(nodes, loads,
                                            np.random.default_rng(2), trace)
    want = t_dm.sample_round_times(nodes, loads, np.random.default_rng(2),
                                   15)
    _same(got, want)


# ---------------------------------------------------------- estimator.py
_PORT = (t_dm, t_channel, t_trace)
_REF = (ref_dm, ref_channel, ref_trace)


def _observations(mods, R=9, seed=0):
    """(nodes, observations) of R drift_churn rounds in one package."""
    dm, ch, tr_mod = mods
    nodes = _nodes(dm)
    prof = ch.CHANNEL_PROFILES["drift_churn"]
    tr = tr_mod.generate_trace(nodes, prof, R, np.random.default_rng(seed))
    loads = np.full(N, 12.0)
    loads[2] = 0.0                                  # a client with no load
    return nodes, tr_mod.sample_round_observations(
        nodes, loads, np.random.default_rng(seed + 1), tr)


def _same_estimator(got, want):
    for key, val in want.snapshot().items():
        _same(got.snapshot()[key], val, key)
    sd_t, sd_r = got.state_dict(), want.state_dict()
    for key in ("beta", "window", "rounds_seen"):
        assert sd_t[key] == sd_r[key], key
    for key in ("s_tau", "s_ntr", "s_comp", "avail_hat"):
        _same(sd_t[key], sd_r[key], key)
    for key in sd_r["win"]:
        _same(sd_t["win"][key], sd_r["win"][key], f"win/{key}")
    for a, b in zip(got.estimated_nodes(), want.estimated_nodes()):
        assert (a.mu, a.alpha, a.tau, a.p) == (b.mu, b.alpha, b.tau, b.p)


@pytest.mark.parametrize("mode", ["ewma", "window"])
def test_estimator_bit_identical(mode):
    """Three blocks of churned, drifting telemetry (a block longer than
    the window included), estimates compared after each."""
    kw = {"beta": 0.3} if mode == "ewma" else {"window": 4}
    t_nodes, _ = _observations(_PORT)
    ref_nodes, _ = _observations(_REF)
    got = t_est.OnlineChannelEstimator(t_nodes, **kw)
    want = ref_est.OnlineChannelEstimator(ref_nodes, **kw)
    _same_estimator(got, want)                       # the nominal warm start
    for seed, R in ((0, 3), (10, 6), (20, 2)):
        _, t_obs = _observations(_PORT, R=R, seed=seed)
        _, ref_obs = _observations(_REF, R=R, seed=seed)
        got.update(t_obs)
        want.update(ref_obs)
        _same_estimator(got, want)
    assert got.rounds_seen == 11


@pytest.mark.parametrize("mode", ["ewma", "window"])
def test_estimator_state_dict_round_trip_across_packages(mode):
    """A reference estimator's state_dict continues in the port (and the
    port's in the reference) bit-identically to an uninterrupted one."""
    kw = {"beta": 0.25} if mode == "ewma" else {"window": 3}
    t_nodes, t_obs1 = _observations(_PORT, R=5, seed=1)
    ref_nodes, ref_obs1 = _observations(_REF, R=5, seed=1)
    _, t_obs2 = _observations(_PORT, R=4, seed=2)
    _, ref_obs2 = _observations(_REF, R=4, seed=2)
    control = ref_est.OnlineChannelEstimator(ref_nodes, **kw)
    control.update(ref_obs1)
    control.update(ref_obs2)

    ref_first = ref_est.OnlineChannelEstimator(ref_nodes, **kw)
    ref_first.update(ref_obs1)
    port = t_est.OnlineChannelEstimator(t_nodes, **kw)
    port.load_state_dict(copy.deepcopy(ref_first.state_dict()))
    port.update(t_obs2)
    _same_estimator(port, control)

    t_first = t_est.OnlineChannelEstimator(t_nodes, **kw)
    t_first.update(t_obs1)
    back = ref_est.OnlineChannelEstimator(ref_nodes, **kw)
    back.load_state_dict(copy.deepcopy(t_first.state_dict()))
    back.update(ref_obs2)
    _same_estimator(port, back)


def test_estimator_validation_matches_reference():
    nodes = _nodes(t_dm)
    for kw in (dict(beta=0.0), dict(beta=1.5), dict(window=0)):
        with pytest.raises(ValueError):
            ref_est.OnlineChannelEstimator(_nodes(ref_dm), **kw)
        with pytest.raises(ValueError):
            t_est.OnlineChannelEstimator(nodes, **kw)
    est = t_est.OnlineChannelEstimator(nodes, beta=0.5)
    with pytest.raises(ValueError, match="beta"):
        t_est.OnlineChannelEstimator(nodes, window=2).load_state_dict(
            est.state_dict())
    bad = est.state_dict()
    bad["s_tau"] = bad["s_tau"][:3]
    with pytest.raises(ValueError, match="s_tau"):
        t_est.OnlineChannelEstimator(nodes, beta=0.5).load_state_dict(bad)
