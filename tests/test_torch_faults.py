"""Return-fault injection of the PyTorch port (``repro_torch.faults`` and
the fault branches of ``build_step``) against the JAX reference, on the
CPU.

The same client data (NumPy, from a seed) goes through both packages at
the size of ``tests/test_faults.py`` (n = 8, l = 24, q = 6, c = 3); the
reference's parity generators are carried over with ``repro_torch.carry``.
Held to:

  * bit-identical: the fault draws (`sample_fault_rows`, every profile, the
    fixed four-block layout), the profiles and their validation, the
    checkpoint corruption helpers, and of every run the wall clock, the
    returned counts and the per-round ``n_masked`` / ``skipped`` counters
    (host NumPy on the same generators; the guard counts the same rows);
  * theta within atol 1e-5, the tolerance of ``tests/test_torch_engine.py``;
  * faults never shift the delays, the guard is a bit-exact no-op on clean
    runs, and the benign profile is the fault-free run bit for bit;
  * a faulty run's kill/resume is bit-identical in the port, and a faulty
    checkpoint (``theta_prev`` and ``fault_rng_state`` in it) written by
    either package resumes in the other.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import config as ref_config
from repro import faults as ref_faults
from repro.checkpoint import io as ref_ckpt
from repro.core import encoding as ref_enc
from repro.core import fed_runtime as ref_runtime

from repro_torch import api as t_api
from repro_torch import carry
from repro_torch import config as t_config
from repro_torch import faults as t_faults
from repro_torch.checkpoint import io as t_ckpt
from repro_torch.core import fed_runtime as t_runtime
from repro_torch.core import run_state as t_rs

N, L, Q, C = 8, 24, 6, 3
SEED = 3
ROUNDS = 20
EVERY = 4
PROFILES = list(ref_faults.FAULT_PROFILES)


def _data(n=N, l=L, q=Q, c=C, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, l, q)).astype(np.float32) * 0.3
    theta_true = rng.normal(size=(q, c)).astype(np.float32)
    ys = (np.einsum("nlq,qc->nlc", xs, theta_true)
          + 0.005 * rng.normal(size=(n, l, c))).astype(np.float32)
    return xs, ys


def _spec(mod, scheme="coded", **over):
    base = dict(fl=mod.FLConfig(n_clients=N, seed=SEED),
                train=mod.TrainConfig(learning_rate=0.05), scheme=scheme)
    base.update(over)
    return mod.ExperimentSpec(**base)


@functools.lru_cache(maxsize=None)
def _reference_generators(u, n=N, l=L):
    """The reference's per-client generators: the split chain of
    ``CodedScheme.setup`` from PRNGKey(seed + 99)."""
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(SEED + 99), None,
                           length=n)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, l))(keys))


def _port(spec, u=None, xs=None, ys=None):
    if xs is None:
        xs, ys = _data()
    gens = None if u is None else carry.generators_from_reference(
        _reference_generators(u), device="cpu")
    return t_api.build_experiment(spec, xs, ys, device="cpu",
                                  parity_generators=gens)


def _pair(scheme="coded", **over):
    """(reference experiment, port experiment) of one deployment."""
    xs, ys = _data()
    ref_exp = ref_api.build_experiment(_spec(ref_config, scheme, **over),
                                       xs, ys)
    u = ref_exp.u if ref_exp.scheme_obj.coded else None
    return ref_exp, _port(_spec(t_config, scheme, **over), u)


def _np(theta):
    return (theta.cpu().numpy() if isinstance(theta, torch.Tensor)
            else np.asarray(theta))


def _same_rounds(got, want):
    """Bit-identical host quantities and guard counters; theta within
    1e-5."""
    for f in ("wall_clock", "returned", "n_masked", "skipped"):
        assert [getattr(h, f) for h in got.history] == \
            [getattr(h, f) for h in want.history], f
    assert dataclasses.asdict(got.health) == dataclasses.asdict(want.health)
    np.testing.assert_allclose(_np(got.theta), _np(want.theta), atol=1e-5)


def _same_result(a, b):
    """Bit-identical port results (theta, history, health)."""
    assert torch.equal(a.theta, b.theta)
    for ha, hb in zip(a.history, b.history):
        assert dataclasses.asdict(ha) == dataclasses.asdict(hb) or (
            np.isnan(ha.loss) and np.isnan(hb.loss)
            and ha.wall_clock == hb.wall_clock
            and ha.returned == hb.returned
            and ha.n_masked == hb.n_masked and ha.skipped == hb.skipped)
    assert a.health == b.health


def _ckpt(tmp_path, rounds_done):
    return str(tmp_path / f"{t_ckpt.CKPT_PREFIX}{rounds_done:06d}.npz")


# ------------------------------------------------------------- profiles
def test_profile_registry_matches_reference():
    assert list(t_faults.FAULT_PROFILES) == PROFILES
    for name in PROFILES:
        t_prof = t_faults.FAULT_PROFILES[name]
        ref_prof = ref_faults.FAULT_PROFILES[name]
        assert t_prof.to_dict() == ref_prof.to_dict()
        assert (t_prof.has_return_faults, t_prof.has_service_faults,
                t_prof.is_benign) == (ref_prof.has_return_faults,
                                      ref_prof.has_service_faults,
                                      ref_prof.is_benign)
        revived = t_faults.FaultProfile.from_dict(
            json.loads(json.dumps(ref_prof.to_dict())))
        assert revived == t_prof
    assert (t_faults.CODE_CLEAN, t_faults.CODE_NAN, t_faults.CODE_INF,
            t_faults.CODE_STALE) == (ref_faults.CODE_CLEAN,
                                     ref_faults.CODE_NAN,
                                     ref_faults.CODE_INF,
                                     ref_faults.CODE_STALE)


@pytest.mark.parametrize("bad", [
    dict(nan_prob=-0.1), dict(nan_prob=1.5), dict(nan_kind="bogus"),
    dict(stale_prob=2.0), dict(crash_prob=-1.0),
    dict(ckpt_corrupt_kind="shred"),
])
def test_profile_rejects_bad_values(bad):
    for mod in (t_faults, ref_faults):
        with pytest.raises(ValueError):
            mod.FaultProfile(**bad)


def test_profile_lookup_errors():
    with pytest.raises(ValueError, match="tornado_prob"):
        t_faults.FaultProfile.from_dict({"tornado_prob": 0.5})
    with pytest.raises(ValueError, match="no_such"):
        t_faults.get_fault_profile("no_such")
    assert t_faults.get_fault_profile("chaos") is \
        t_faults.FAULT_PROFILES["chaos"]
    assert issubclass(t_faults.InjectedCrashError, RuntimeError)


def test_spec_resolves_and_overrides_fault_profile():
    specs = [_spec(mod, fault_profile="flaky_clients",
                   fault_params=(("nan_prob", 0.5),))
             for mod in (t_config, ref_config)]
    assert specs[0].resolved_faults().nan_prob == 0.5
    assert specs[0].resolved_faults().to_dict() == \
        specs[1].resolved_faults().to_dict()
    assert specs[0].fault_params_dict == {"nan_prob": 0.5}
    assert specs[0].to_dict() == specs[1].to_dict()
    revived = t_config.ExperimentSpec.from_dict(
        json.loads(json.dumps(specs[1].to_dict())))
    assert revived == specs[0]
    assert _spec(t_config).resolved_faults() is None
    only = _spec(t_config, fault_params={"stale_prob": 0.3})
    assert only.resolved_faults() == t_faults.FaultProfile(stale_prob=0.3)


_REFUSED = [
    ("unknown-profile", dict(fault_profile="no_such")),
    ("bad-fault_params", dict(fault_profile="flaky_clients",
                              fault_params={"tornado_prob": 1.0})),
    ("bad-fault-value", dict(fault_params={"nan_prob": 2.0})),
    ("return-faults-mesh", dict(fault_profile="flaky_clients", mesh=2)),
    ("legacy-faults", dict(engine="legacy", fault_profile="chaos")),
    ("hier-faults", dict(hier_shards=2, fault_profile="flaky_clients")),
    ("hier-secure", dict(hier_shards=2, secure_aggregation=True)),
    ("hier-shards-exceed-clients", dict(hier_shards=N + 1)),
    ("hier-mesh", dict(hier_shards=2, mesh=2)),
]


@pytest.mark.parametrize("kw", [k for _, k in _REFUSED],
                         ids=[i for i, _ in _REFUSED])
def test_spec_refusals_match_reference(kw):
    for mod in (ref_config, t_config):
        with pytest.raises(ValueError):
            _spec(mod, **kw)


# two faults at once: the spec names the one the reference checks first
# (run_id before the channel, nonfinite_guard before the faults, the faults
# right after the channel in the hierarchical block); the messages are the
# reference's, with the port's module names
_FIRST_REFUSAL = [
    ("run_id-before-faults", dict(run_id=".bad", fault_profile="nope"),
     "run_id"),
    ("run_id-before-channel", dict(run_id=".bad", channel_profile="nope"),
     "run_id"),
    ("guard-before-faults", dict(nonfinite_guard="yes",
                                 fault_profile="nope"), "nonfinite_guard"),
    ("hier-faults-before-adapt", dict(hier_shards=2, adapt_every=2,
                                      fault_profile="flaky_clients"),
     "fault-injection"),
    ("hier-faults-before-fused_embed",
     dict(hier_shards=2, fault_profile="flaky_clients", fused_embed=True),
     "fault-injection"),
    ("hier-channel", dict(hier_shards=2, channel_profile="churn"),
     "generate_trace_chunked"),
    ("hier-shards-exceed-clients", dict(hier_shards=N + 1), "exceeds"),
    ("hier-mesh", dict(hier_shards=2, mesh=2), "drop mesh"),
]


@pytest.mark.parametrize("kw,names", [(k, m) for _, k, m in _FIRST_REFUSAL],
                         ids=[i for i, _, _ in _FIRST_REFUSAL])
def test_spec_refusal_messages_match_reference(kw, names):
    msgs = []
    for mod in (ref_config, t_config):
        over = dict(kw)
        if over.get("fused_embed"):
            over["rff"] = mod.RFFConfig(q=Q)
        with pytest.raises(ValueError, match=names) as info:
            _spec(mod, **over)
        msgs.append(str(info.value))
    assert msgs[1] == msgs[0].replace("repro.hier", "repro_torch.hier")


def test_api_exports_the_fault_profiles():
    for name in ("FAULT_PROFILES", "FaultProfile", "get_fault_profile"):
        assert name in t_api.__all__ and name in ref_api.__all__
    assert t_api.FAULT_PROFILES is t_faults.FAULT_PROFILES
    assert t_api.get_fault_profile("chaos") == t_faults.FAULT_PROFILES["chaos"]
    assert isinstance(t_api.get_fault_profile("chaos"), t_api.FaultProfile)
    assert set(t_api.__all__) == set(ref_api.__all__)


def test_service_faults_on_a_mesh_are_accepted_then_mesh_refused():
    """crash/checkpoint faults are fine on a mesh (the reference's rule):
    both packages make the spec.  In one process (one JAX device, no
    process group) both then refuse mesh=2 with the same ValueError, and
    both build and run mesh=1 alike."""
    xs, ys = _data()
    msgs = []
    for mod, build in ((ref_config, lambda s: ref_api.build_experiment(
            s, xs, ys)), (t_config, _port)):
        with pytest.raises(ValueError, match="device") as info:
            build(_spec(mod, fault_profile="crash_loop", mesh=2))
        msgs.append(str(info.value))
    assert msgs[1].split(" (")[0] == msgs[0].split(" (")[0]
    ref_exp = ref_api.build_experiment(
        _spec(ref_config, fault_profile="crash_loop", mesh=1), xs, ys)
    port_exp = _port(_spec(t_config, fault_profile="crash_loop", mesh=1),
                     ref_exp.u)
    _same_rounds(port_exp.run(ROUNDS), ref_exp.run(ROUNDS))


# --------------------------------------------------------------- draws
@pytest.mark.parametrize("profile", PROFILES)
def test_sample_fault_rows_match_reference(profile):
    t_rng, ref_rng = np.random.default_rng(7), np.random.default_rng(7)
    got = t_faults.sample_fault_rows(t_faults.FAULT_PROFILES[profile],
                                     t_rng, 50, 10)
    want = ref_faults.sample_fault_rows(ref_faults.FAULT_PROFILES[profile],
                                        ref_rng, 50, 10)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # four blocks drawn whatever the knobs: the stream ends in one place
    assert t_rng.bit_generator.state == ref_rng.bit_generator.state


def test_sample_layout_is_fixed_across_knobs():
    """Turning one fault kind on never shifts another's realization."""
    base = t_faults.FAULT_PROFILES["flaky_clients"]
    with_stale = dataclasses.replace(base, stale_prob=0.2)
    c_base, _ = t_faults.sample_fault_rows(base, np.random.default_rng(11),
                                           40, 8)
    c_stale, _ = t_faults.sample_fault_rows(
        with_stale, np.random.default_rng(11), 40, 8)
    nan_mask = np.isin(c_base, (t_faults.CODE_NAN, t_faults.CODE_INF))
    np.testing.assert_array_equal(
        nan_mask, np.isin(c_stale, (t_faults.CODE_NAN, t_faults.CODE_INF)))
    assert not np.any((c_stale == t_faults.CODE_STALE) & nan_mask)
    want, _ = ref_faults.sample_fault_rows(
        ref_faults.FaultProfile(**with_stale.to_dict()),
        np.random.default_rng(11), 40, 8)
    np.testing.assert_array_equal(c_stale, want)


@pytest.mark.parametrize("kind,seeded", [
    ("truncate", False), ("bitflip", False), ("bitflip", True),
    ("mix", False), ("mix", True)])
def test_corrupt_checkpoint_matches_reference(kind, seeded, tmp_path):
    payload = np.random.default_rng(2).integers(
        0, 256, 4099).astype(np.uint8).tobytes()
    paths = []
    for tag, mod in (("port", t_faults), ("ref", ref_faults)):
        path = tmp_path / f"{tag}.npz"
        path.write_bytes(payload)
        rng = np.random.default_rng(5) if seeded else None
        applied = mod.corrupt_checkpoint(str(path), kind, rng=rng)
        paths.append((path, applied))
    (p_port, a_port), (p_ref, a_ref) = paths
    assert a_port == a_ref
    assert p_port.read_bytes() == p_ref.read_bytes() != payload
    with pytest.raises(ValueError):
        t_faults.corrupt_checkpoint(str(p_port), "shred")
    with pytest.raises(ValueError):
        t_faults.truncate_file(str(p_port), frac=1.0)


# ------------------------------------------------------------ the guard
@pytest.mark.parametrize("guard", [True, False])
def test_guard_and_sum_with_bad_rows_matches_reference(guard):
    """Injected rows: a non-finite entry replaces a RETURNED row whole; a
    finite entry (0.0) leaves the row's bits, -0.0 included."""
    g = np.random.default_rng(5).normal(size=(5, 3, 2)).astype(np.float32)
    g[0, 0, 0] = -0.0
    ret = np.array([1.0, 1.0, 0.0, 1.0, 1.0], np.float32)
    bad = np.array([0.0, np.nan, np.inf, np.inf, 0.0], np.float32)
    want_sum, want_masked = ref_runtime._guard_and_sum(
        jnp.asarray(g), jnp.asarray(ret), jnp.asarray(bad), guard)
    got_sum, got_masked = t_runtime.guard_and_sum(
        torch.from_numpy(g), torch.from_numpy(ret), guard,
        torch.from_numpy(bad))
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(want_sum),
                               rtol=1e-6, atol=1e-6, equal_nan=True)
    assert int(got_masked) == int(want_masked) == (2 if guard else 0)


def test_guard_is_bit_exact_noop_on_clean_runs():
    on = _port(_spec(t_config, "naive", nonfinite_guard=True)).run(16)
    off = _port(_spec(t_config, "naive", nonfinite_guard=False)).run(16)
    assert torch.equal(on.theta, off.theta)
    assert on.health.returns_masked == 0
    assert on.health.rounds_skipped == 0
    assert on.health.lr_scale == 1.0


@pytest.mark.parametrize("scheme", ["coded", "naive"])
def test_benign_profile_is_the_fault_free_run(scheme):
    clean = _port(_spec(t_config, scheme)).run(12)
    none = _port(_spec(t_config, scheme, fault_profile="none")).run(12)
    service = _port(_spec(t_config, scheme,
                          fault_profile="crash_loop")).run(12)
    _same_result(none, clean)
    _same_result(service, clean)


def test_faults_do_not_shift_delay_realizations():
    clean = _port(_spec(t_config)).run(16)
    for profile in ("flaky_clients", "chaos"):
        faulty = _port(_spec(t_config, fault_profile=profile)).run(16)
        assert [h.wall_clock for h in clean.history] \
            == [h.wall_clock for h in faulty.history]
        assert [h.returned for h in clean.history] \
            == [h.returned for h in faulty.history]


# ------------------------------------------------------- degradation
@pytest.mark.parametrize("profile", ["flaky_clients", "byzantine_lite"])
def test_coded_degrades_gracefully(profile):
    res = _port(_spec(t_config, fault_profile=profile)).run(ROUNDS)
    assert torch.isfinite(res.theta).all()
    assert res.health.returns_masked > 0
    assert res.health.rounds_degraded > 0
    assert res.health.rounds_skipped == 0


def test_naive_guarded_detects_and_reports():
    res = _port(_spec(t_config, "naive",
                      fault_profile="flaky_clients")).run(ROUNDS)
    assert torch.isfinite(res.theta).all()
    assert res.health.returns_masked > 0


def test_naive_unguarded_stalls():
    """Without the guard a NaN return poisons the round; the divergence
    guard skips it and backs the lr off, again and again."""
    ref_exp, t_exp = _pair("naive", fault_profile="flaky_clients",
                           nonfinite_guard=False)
    res = t_exp.run(ROUNDS)
    assert torch.isfinite(res.theta).all()
    assert res.health.rounds_skipped > 0
    assert res.health.lr_scale < 1.0
    assert res.health.returns_masked == 0
    _same_rounds(res, ref_exp.run(ROUNDS))


# --------------------------------------- every scheme against the reference
_SCHEME_CASES = {
    f"{scheme}-{profile}{'-unfused' if not fused else ''}":
        (scheme, profile, fused)
    for profile in ("byzantine_lite", "chaos")
    for scheme, fused in (("coded", True), ("coded", False), ("naive", True),
                          ("greedy", True), ("ideal", True),
                          ("partial_coded", True))
}


@pytest.mark.parametrize("case", list(_SCHEME_CASES))
def test_faulty_run_matches_reference(case):
    scheme, profile, fused = _SCHEME_CASES[case]
    ref_exp, t_exp = _pair(scheme, fault_profile=profile, fused_coded=fused)
    got, want = t_exp.run(ROUNDS), ref_exp.run(ROUNDS)
    _same_rounds(got, want)
    assert got.health.returns_masked > 0


@pytest.mark.parametrize("profile", ["corrupt_parity", "chaos"])
def test_parity_corruption_is_counted_as_the_draw_says(profile):
    """n_masked a round = non-finite codes of the clients that returned,
    plus the round's corrupted-parity flag (coded): a host replay of the
    fault stream and the delays."""
    exp = _port(_spec(t_config, fault_profile=profile))
    rng = np.random.default_rng()
    rng.bit_generator.state = exp.rng.bit_generator.state
    res = exp.run(ROUNDS)
    from repro_torch.core.delay_model import sample_round_times
    times = sample_round_times(exp.nodes, np.asarray(exp.loads, float), rng,
                               ROUNDS).astype(np.float32)
    ret = (times <= np.float32(exp.t_star)) & (exp.loads > 0)
    codes, fpar = t_faults.sample_fault_rows(
        exp.faults, np.random.default_rng((SEED + 7717,)), ROUNDS, N)
    bad = np.isin(codes, (t_faults.CODE_NAN, t_faults.CODE_INF))
    want = (bad & ret).sum(axis=1) + fpar.astype(int)
    assert [h.n_masked for h in res.history] == want.tolist()
    assert fpar.sum() > 0


def test_run_multi_faults_match_reference():
    ref_exp, t_exp = _pair(fault_profile="chaos")
    got, want = t_exp.run_multi(10, 3), ref_exp.run_multi(10, 3)
    np.testing.assert_array_equal(got.wall_clock, want.wall_clock)
    np.testing.assert_array_equal(got.returned, want.returned)
    assert dataclasses.asdict(got.health) == dataclasses.asdict(want.health)
    assert got.health.returns_masked > 0
    np.testing.assert_allclose(_np(got.theta), _np(want.theta), atol=1e-5)


@pytest.mark.parametrize("scheme", ["coded", "greedy"])
def test_channel_faults_match_reference(scheme):
    kw = dict(fault_profile="chaos", channel_profile="drift_churn")
    ref_exp, t_exp = _pair(scheme, **kw)
    _same_rounds(t_exp.run(ROUNDS), ref_exp.run(ROUNDS))
    multi_t, multi_r = t_exp.run_multi(8, 2), ref_exp.run_multi(8, 2)
    np.testing.assert_array_equal(multi_t.returned, multi_r.returned)
    np.testing.assert_array_equal(multi_t.wall_clock, multi_r.wall_clock)
    assert dataclasses.asdict(multi_t.health) == \
        dataclasses.asdict(multi_r.health)
    np.testing.assert_allclose(_np(multi_t.theta), _np(multi_r.theta),
                               atol=1e-5)


@pytest.mark.parametrize("scheme", ["adaptive_coded", "adaptive_greedy"])
def test_adaptive_faults_match_reference(scheme):
    ref_exp, t_exp = _pair(scheme, fault_profile="chaos",
                           channel_profile="degrade_drift", adapt_every=5)
    _same_rounds(t_exp.run(ROUNDS), ref_exp.run(ROUNDS))


# -------------------------------------------------- checkpoints and resume
def test_run_state_carries_the_fault_fields():
    exp = _port(_spec(t_config, fault_profile="chaos", checkpoint_every=EVERY))
    fresh = exp.init_state(12)
    assert fresh.fault_rng_state == np.random.default_rng(
        (SEED + 7717,)).bit_generator.state
    assert torch.equal(fresh.theta_prev, fresh.theta)
    state = exp.run_block(fresh)
    arrays, meta = t_rs.pack_state(state)
    assert "theta_prev" in arrays and meta["fault_rng_state"] is not None
    assert meta["fault_rng_state"] != fresh.fault_rng_state
    back = t_rs.unpack_state(arrays, meta, device="cpu")
    assert torch.equal(back.theta_prev, state.theta_prev)
    assert back.fault_rng_state == state.fault_rng_state
    # the stale iterate is the one the block's last round started from
    assert not torch.equal(state.theta_prev, state.theta)
    clean = _port(_spec(t_config, checkpoint_every=EVERY)).init_state(12)
    assert clean.theta_prev is None and clean.fault_rng_state is None


@pytest.mark.parametrize("multi", [False, True])
def test_faulty_run_resumes_bit_identically(multi, tmp_path):
    spec = _spec(t_config, fault_profile="byzantine_lite",
                 checkpoint_every=EVERY)
    control = (_port(spec).run_multi(12, 2) if multi
               else _port(spec).run(12))
    exp = _port(spec)
    state = exp.run_block(exp.init_state(
        12, n_realizations=2 if multi else None))
    exp.save_state(_ckpt(tmp_path, state.rounds_done), state)
    fresh = _port(spec)
    if multi:
        resumed = fresh.run_multi(12, 2, checkpoint_dir=str(tmp_path),
                                  resume=True)
        assert torch.equal(control.theta, resumed.theta)
        np.testing.assert_array_equal(control.wall_clock, resumed.wall_clock)
    else:
        resumed = fresh.run(12, checkpoint_dir=str(tmp_path), resume=True)
        _same_result(resumed, control)
    assert dataclasses.asdict(control.health) == \
        dataclasses.asdict(resumed.health)


def test_corrupt_newest_checkpoint_falls_back(tmp_path):
    """A truncated and a bit-flipped newest checkpoint fail their digest;
    the run resumes from the newest intact one, bit for bit."""
    spec = _spec(t_config, fault_profile="chaos", checkpoint_every=EVERY)
    control = _port(spec).run(16, checkpoint_dir=str(tmp_path))
    t_faults.corrupt_checkpoint(_ckpt(tmp_path, 16), "truncate")
    t_faults.corrupt_checkpoint(_ckpt(tmp_path, 12), "bitflip")
    assert t_ckpt.latest_checkpoint(str(tmp_path), valid_only=True) == \
        _ckpt(tmp_path, 8)
    resumed = _port(spec).run(16, checkpoint_dir=str(tmp_path), resume=True)
    _same_result(resumed, control)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_faulty_checkpoint_resumes_across_packages(writer, tmp_path):
    """Stale faults on: the checkpoint holds theta_prev and the fault
    stream, and the other package finishes the run from it."""
    kw = dict(fault_profile="chaos", checkpoint_every=EVERY)
    ref_exp, t_exp = _pair(**kw)
    control = ref_exp.run(ROUNDS)
    ref_w, t_w = _pair(**kw)
    w = ref_w if writer == "reference" else t_w
    state = w.run_block(w.run_block(w.init_state(ROUNDS)))
    path = w.save_state(_ckpt(tmp_path, state.rounds_done), state)
    arrays, meta = ref_ckpt.restore_state(path)
    assert arrays["theta_prev"].shape == (Q, C)
    assert meta["fault_rng_state"] is not None
    reader = t_exp if writer == "reference" else _pair(**kw)[0]
    resumed = reader.run(ROUNDS, checkpoint_dir=str(tmp_path), resume=True)
    _same_rounds(resumed, control)
    t_ckpt.restore_state(_ckpt(tmp_path, ROUNDS))       # digest verified

