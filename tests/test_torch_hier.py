"""The hierarchical tier of the PyTorch port (``repro_torch.hier``, its
routing, telemetry and launchers) against the reference's own
``HierExperiment``, on the CPU.

The reference's chunked solver imports ``jax.experimental.enable_x64``,
which this JAX lacks; JAX has ``jax.enable_x64(True)`` as a context
manager instead.  A module-scoped fixture sets the missing name to it in
this test process only, and takes it away after the module, so the
reference's tier runs here and no file of the reference changes.

The same client data (NumPy, from a seed) goes through both packages at
the size of ``tests/test_hier.py`` (n = 12, l = 4, q = 6, c = 2, seed 3);
the reference's per-shard parity generators (``fold_in(PRNGKey(seed +
99), s)``, a split chain an encode block) are carried over with
``repro_torch.carry.hier_generators_from_reference``.  Held to:

  * plans field for field (t* bit-equal at these sizes, loads, the
    reweights, the setup time), returned counts and the wall clock equal,
    theta within 1e-5 — at (3 shards, f = 0.6), (3, 1.0) and (1, 0.5), and
    once with the reference on its Pallas kernels (interpret mode);
  * streaming equals dense; block partitions and kill/resume bit-identical;
    hier checkpoints resume across packages both ways;
  * attribution field for field by shard, ``events.jsonl`` byte-identical;
  * the routing, the refusals and the service's quirk as the reference's;
  * ``launch.scale.run_scale`` equal to the reference's but for timings.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import config as ref_config
from repro.core import encoding as ref_enc
from repro.core import schemes as ref_schemes
from repro.hier import HierExperiment as RefHier
from repro.launch import scale as ref_scale
from repro.launch.service import ExperimentService as RefService
from repro.obs import spans as ref_spans

from repro_torch import api as t_api
from repro_torch import carry
from repro_torch import config as t_config
from repro_torch.core import fed_runtime as t_runtime
from repro_torch.core import schemes as t_schemes
from repro_torch.hier import HierExperiment
from repro_torch.hier import topology
from repro_torch.launch import hier_scale
from repro_torch.launch import scale as t_scale
from repro_torch.launch.service import ExperimentService
from repro_torch.obs import events as t_events
from repro_torch.obs import spans as t_spans

N, L, Q, C = 12, 4, 6, 2
SEED = 3
ROUNDS = 6
THETA_ATOL = 1e-5
# fewer solver iterations, the same in both packages, wherever the
# solver's defaults are not what a test is about: the plans stay
# comparable field for field and the builds take a fraction of the time
LIGHT = (("n_bisect", 16), ("n_golden", 20), ("n_golden_search", 10))
# (shards, f, the reference's kernel backend, solver settings)
CASES = {"3-0.6": (3, 0.6, "xla", LIGHT), "3-1.0": (3, 1.0, "xla", LIGHT),
         "1-0.5": (1, 0.5, "xla", LIGHT),
         "3-0.6-pallas": (3, 0.6, "pallas", LIGHT),
         "3-0.6-default-solver": (3, 0.6, "xla", ())}


@pytest.fixture(scope="module", autouse=True)
def x64_shim():
    """``jax.experimental.enable_x64`` for the reference's solver, in this
    module only."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's float64 solvers run many small CPU ops: one intra-op
    thread each keeps parallel test workers from oversubscribing the
    cores (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@functools.lru_cache(maxsize=None)
def _data(n=N, l=L, q=Q, c=C, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, l, q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(n, l, c)).astype(np.float32)
    return xs, ys


def _spec(mod, shards=3, f=0.6, **over):
    base = dict(
        fl=mod.FLConfig(n_clients=N, delta=0.25, seed=SEED),
        train=mod.TrainConfig(learning_rate=0.5, l2_reg=1e-5,
                              lr_decay_epochs=(4,)),
        scheme="coded", hier_shards=shards, sample_fraction=f)
    base.update(over)
    return mod.ExperimentSpec(**base)


def _reference_generators(exp, encode_block=1024):
    """The reference's per-shard generator stacks, drawn as its setup
    draws them: ``fold_in(PRNGKey(seed + 99), s)``, then a split chain an
    encode block."""
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    stacks = []
    for s, plan in enumerate(exp.plans):
        key = jax.random.fold_in(jax.random.PRNGKey(exp.fl.seed + 99), s)
        blocks = []
        for a in range(0, plan.n_clients, encode_block):
            b = min(a + encode_block, plan.n_clients)
            key, keys = jax.lax.scan(chain, key, None, length=b - a)
            blocks.append(np.asarray(jax.vmap(
                lambda k: ref_enc.generator_matrix(k, plan.u, exp.l))(keys)))
        stacks.append(np.concatenate(blocks))
    return stacks


@functools.lru_cache(maxsize=None)
def _ref(shards=3, f=0.6, backend="xla", solver=LIGHT, **over):
    xs, ys = _data()
    return RefHier(_spec(ref_config, shards, f, kernel_backend=backend,
                         **over), xs, ys, solver_kwargs=dict(solver))


def _port(shards=3, f=0.6, backend="xla", solver=LIGHT, carried=True,
          **over):
    """A port experiment of the deployment, the reference's generators
    carried over."""
    xs, ys = _data()
    gens = None
    if carried:
        gens = carry.hier_generators_from_reference(
            _reference_generators(_ref(shards, f, backend, solver, **over)),
            device="cpu")
    return HierExperiment(
        _spec(t_config, shards, f, kernel_backend=backend, **over), xs, ys,
        device="cpu", parity_generators=gens, solver_kwargs=dict(solver))


@functools.lru_cache(maxsize=None)
def _port_cached(shards=3, f=0.6, backend="xla", solver=LIGHT):
    return _port(shards, f, backend, solver)


def _fresh_state(exp, iterations):
    """A state at the experiment's initial stream positions, whatever it
    ran before."""
    fl = exp.fl
    return dataclasses.replace(
        exp.init_state(iterations),
        rng_state=np.random.default_rng(fl.seed + 17).bit_generator.state,
        sample_rng_state=np.random.default_rng(
            (fl.seed + 5557,)).bit_generator.state)


def _same_plans(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.lo, g.hi, g.u) == (w.lo, w.hi, w.u)
        assert g.t_star == w.t_star
        np.testing.assert_array_equal(g.loads, np.asarray(w.loads))
        np.testing.assert_array_equal(g.p_return, np.asarray(w.p_return))
        np.testing.assert_array_equal(g.gmask.numpy(), np.asarray(w.gmask))
        np.testing.assert_allclose(g.parity_x.numpy(),
                                   np.asarray(w.parity_x), rtol=0,
                                   atol=THETA_ATOL)
        np.testing.assert_allclose(g.parity_y.numpy(),
                                   np.asarray(w.parity_y), rtol=0,
                                   atol=THETA_ATOL)
        assert g.parity_weight == w.parity_weight
        assert g.expected_return_mass == w.expected_return_mass
        assert g.setup_time == w.setup_time


def _same_result(got, want):
    np.testing.assert_array_equal(got.n_ret, want.n_ret)
    np.testing.assert_array_equal(got.wall_clock, want.wall_clock)
    np.testing.assert_array_equal(got.t_rounds, want.t_rounds)
    assert (got.t_round, got.setup_time, got.shards,
            got.sample_fraction) == (want.t_round, want.setup_time,
                                     want.shards, want.sample_fraction)
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               rtol=0, atol=THETA_ATOL)


# ---------------------------------------------------------------- the tier
@pytest.mark.parametrize("case", sorted(CASES))
def test_hier_experiment_matches_reference(case):
    shards, f, backend, solver = CASES[case]
    ref = _ref(shards, f, backend, solver)
    port = _port_cached(shards, f, backend, solver)
    _same_plans(port.plans, ref.plans)
    assert (port.setup_time, port.t_round, port.m) == \
        (ref.setup_time, ref.t_round, ref.m)
    _same_result(port.finish(port.run_block(_fresh_state(port, ROUNDS))),
                 ref.finish(ref.run_block(_fresh_state(ref, ROUNDS))))


def test_partial_coded_per_shard_matches_reference():
    over = dict(scheme="partial_coded", scheme_params=(("u_fraction", 0.5),))
    ref, port = _ref(**over), _port(**over)
    assert [p.u for p in port.plans] == [p.u for p in ref.plans] == [2, 2, 2]
    _same_plans(port.plans, ref.plans)
    _same_result(port.finish(port.run_block(_fresh_state(port, ROUNDS))),
                 ref.finish(ref.run_block(_fresh_state(ref, ROUNDS))))


def test_non_coded_schemes_refused_as_the_reference():
    non_coded = [n for n in t_schemes.registered_names()
                 if t_schemes.get_scheme(n).step_kind != "coded"]
    assert non_coded
    xs, ys = _data()
    for name in non_coded:
        if name.startswith("adaptive"):
            continue      # the spec wants adapt_every, which hier refuses
        with pytest.raises(ValueError, match="coded-family") as got:
            HierExperiment(_spec(t_config, scheme=name), xs, ys,
                           device="cpu")
        with pytest.raises(ValueError, match="coded-family") as want:
            RefHier(_spec(ref_config, scheme=name), xs, ys)
        assert str(got.value) == str(want.value)
    assert set(t_schemes.coded_names()) >= {"coded", "partial_coded"}
    assert t_schemes.coded_names() == ref_schemes.coded_names()
    assert topology._coded_static_names() == ("coded", "partial_coded")


def test_port_generators_are_the_ports_own_and_block_free():
    """Without carried generators the port draws its own, one CPU
    generator a shard (SeedSequence((seed + 99, s))), client after client:
    the encode block changes no draw, and shards draw disjoint streams."""
    xs, ys = _data()
    spec = _spec(t_config)
    a = HierExperiment(spec, xs, ys, device="cpu",
                       solver_kwargs=dict(LIGHT))
    b = HierExperiment(spec, xs, ys, device="cpu", encode_block=1,
                       solver_kwargs=dict(LIGHT))
    for pa, pb in zip(a.plans, b.plans):
        np.testing.assert_allclose(pa.parity_x.numpy(), pb.parity_x.numpy(),
                                   rtol=1e-6, atol=1e-6)
    g0 = torch.randn((4, 4), generator=topology.shard_generator(SEED, 0))
    g1 = torch.randn((4, 4), generator=topology.shard_generator(SEED, 1))
    assert not torch.equal(g0, g1)
    with pytest.raises(ValueError, match="3 shards"):
        HierExperiment(spec, xs, ys, device="cpu",
                       parity_generators=[np.zeros((4, 4, L))])
    with pytest.raises(ValueError, match=r"parity_generators\[0\]"):
        HierExperiment(spec, xs, ys, device="cpu",
                       parity_generators=[np.zeros((4, 3, L))] * 3)


def test_sample_fraction_toggle_never_shifts_delay_stream():
    """The same stream positions on the f = 1 and f = 0.5 deployments: the
    delay and sampling streams move in lockstep, the sampled run sees no
    more clients, and only the sampled one reweights its parity."""
    a = _port(3, 1.0, carried=False)
    b = _port(3, 0.5, carried=False)
    sa, sb = a.run_block(_fresh_state(a, 5)), b.run_block(_fresh_state(b, 5))
    assert sa.rng_state == sb.rng_state
    assert sa.sample_rng_state == sb.sample_rng_state
    np.testing.assert_array_equal(sa.t_rounds, sb.t_rounds)
    assert np.all(sb.n_ret <= sa.n_ret)
    assert all(p.parity_weight == 1.0 for p in a.plans)
    assert all(p.parity_weight > 1.0 for p in b.plans)


def test_data_fn_streaming_matches_dense():
    xs, ys = _data()
    spec = _spec(t_config)
    gens = carry.hier_generators_from_reference(
        _reference_generators(_ref()), device="cpu")
    dense = _port_cached()
    streams = [lambda lo, hi: (xs[lo:hi], ys[lo:hi]),
               lambda lo, hi: (torch.from_numpy(xs[lo:hi]),
                               torch.from_numpy(ys[lo:hi]))]
    want = dense.run_block(_fresh_state(dense, 4))
    for data_fn in streams:
        streamed = HierExperiment(spec, data_fn=data_fn, device="cpu",
                                  parity_generators=gens,
                                  solver_kwargs=dict(LIGHT))
        got = streamed.run_block(_fresh_state(streamed, 4))
        assert torch.equal(got.theta, want.theta)
        np.testing.assert_array_equal(got.n_ret, want.n_ret)


def test_data_fn_probe_validation():
    xs, ys = _data()
    spec = _spec(t_config)
    with pytest.raises(ValueError, match=r"data_fn\(0, 1\)"):
        HierExperiment(spec, data_fn=lambda lo, hi: (
            np.zeros((hi - lo, L)), np.zeros((hi - lo, L))), device="cpu")
    with pytest.raises(ValueError, match="not both"):
        HierExperiment(spec, xs, ys, device="cpu",
                       data_fn=lambda lo, hi: (xs[lo:hi], ys[lo:hi]))
    with pytest.raises(ValueError, match="needs x_stack"):
        HierExperiment(spec, device="cpu")
    with pytest.raises(ValueError, match="covers 11 clients"):
        HierExperiment(spec, xs[:11], ys[:11], device="cpu")
    with pytest.raises(ValueError, match="encode_block"):
        HierExperiment(spec, xs, ys, device="cpu", encode_block=0)
    with pytest.raises(ValueError, match="batched engine"):
        HierExperiment(dataclasses.replace(spec, hier_shards=1,
                                           sample_fraction=1.0,
                                           engine="legacy"), xs, ys,
                       device="cpu")
    with pytest.raises(TypeError, match="ExperimentSpec"):
        HierExperiment(_spec(ref_config), xs, ys, device="cpu")


def test_block_partitions_and_kill_resume_bit_identical(tmp_path):
    port = _port_cached()
    whole = port.run_block(_fresh_state(port, 6), 6)
    st = port.run_block(_fresh_state(port, 6), 2)
    path = port.save_state(str(tmp_path / "ckpt_000002.npz"), st)
    fresh = _port()
    st = fresh.restore_state(path)              # kill/resume at the boundary
    st = fresh.run_block(st, 3)
    st = fresh.run_block(st, 1)
    assert torch.equal(st.theta, whole.theta)
    np.testing.assert_array_equal(st.n_ret, whole.n_ret)
    assert st.rng_state == whole.rng_state
    assert st.sample_rng_state == whole.sample_rng_state
    # run() with checkpoints, resumed from its newest
    spec_exp = _port()
    ckpt = str(tmp_path / "run")
    first = spec_exp.run_block(_fresh_state(spec_exp, 6), 4)
    spec_exp.save_state(os.path.join(ckpt, "ckpt_000004.npz"), first)
    resumed = _port().run(6, checkpoint_dir=ckpt, resume=True, n_rounds=1)
    assert torch.equal(resumed.theta, whole.theta)
    assert sorted(os.listdir(ckpt)) == [f"ckpt_{r:06d}.npz"
                                        for r in (4, 5, 6)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_hier_checkpoints_resume_across_packages(writer, tmp_path):
    """A hier checkpoint either package writes after 2 rounds resumes in
    the other and finishes as the writer's uninterrupted run."""
    ref, port = _ref(), _port_cached()
    src, dst = (ref, port) if writer == "reference" else (port, ref)
    whole = src.run_block(_fresh_state(src, ROUNDS))
    half = src.run_block(_fresh_state(src, ROUNDS), 2)
    path = src.save_state(str(tmp_path / "ckpt_000002.npz"), half)
    st = dst.restore_state(path)
    assert st.mode == "hier" and st.rounds_done == 2
    while not st.done:
        st = dst.run_block(st, 2)
    np.testing.assert_array_equal(st.n_ret, whole.n_ret)
    np.testing.assert_array_equal(st.t_rounds, whole.t_rounds)
    assert st.rng_state == whole.rng_state
    assert st.sample_rng_state == whole.sample_rng_state
    got = st.theta.numpy() if isinstance(st.theta, torch.Tensor) \
        else np.asarray(st.theta)
    want = whole.theta.numpy() if isinstance(whole.theta, torch.Tensor) \
        else np.asarray(whole.theta)
    np.testing.assert_allclose(got, want, rtol=0, atol=THETA_ATOL)


def test_restore_rejects_foreign_spec_and_mode(tmp_path):
    port = _port_cached()
    path = port.save_state(str(tmp_path / "ckpt_000001.npz"),
                           port.run_block(_fresh_state(port, 2), 1))
    other = _port(3, 1.0, carried=False)
    with pytest.raises(ValueError, match="provenance"):
        other.restore_state(path)
    with pytest.raises(ValueError, match="resume=True requires"):
        port.run(2, resume=True)
    with pytest.raises(ValueError, match="2-round run"):
        port.run(5, checkpoint_dir=str(tmp_path), resume=True)


def test_memory_helpers_and_finish_guards_match_reference():
    ref, port = _ref(), _port_cached()
    assert port.peak_client_tensor_bytes() == ref.peak_client_tensor_bytes()
    assert port.population_tensor_bytes() == ref.population_tensor_bytes() \
        == 8 * N * 7
    for exp in (ref, port):
        st = exp.run_block(_fresh_state(exp, 3), 1)
        with pytest.raises(ValueError, match="not complete"):
            exp.finish(st)
        done = exp.run_block(st, 2)
        with pytest.raises(ValueError, match="already complete"):
            exp.run_block(done)
        with pytest.raises(ValueError, match="hier"):
            exp.run_block(dataclasses.replace(st, mode="single"))
        with pytest.raises(ValueError, match="hier"):
            exp.finish(dataclasses.replace(done, mode="single"))
        with pytest.raises(ValueError, match="n_rounds"):
            exp.run_block(st, 0)
        with pytest.raises(ValueError, match="iterations"):
            exp.init_state(0)


# ---------------------------------------------------------------- telemetry
def test_attribution_matches_reference_by_shard():
    ref, port = _ref(), _port_cached()
    with pytest.raises(RuntimeError, match="no telemetry"):
        port.init_state(2)
        port.attribution()
    ref_spans.enable()
    t_spans.enable()
    for exp in (ref, port):
        exp.run_block(exp.run_block(_fresh_state(exp, ROUNDS), 3), 3)
    got, want = port.attribution(), ref.attribution()
    assert sorted(got) == sorted(want) == [0, 1, 2]
    for s in want:
        assert (got[s].rounds, got[s].k) == (want[s].rounds, want[s].k)
        for field in ("miss_rate", "miss_counts", "active_rounds",
                      "slowest_k_counts", "comp_share"):
            np.testing.assert_array_equal(getattr(got[s], field),
                                          getattr(want[s], field),
                                          err_msg=field)
        assert got[s].to_dict() == want[s].to_dict()


def test_hier_spans_recorded_and_events_byte_identical(tmp_path):
    """The tier's spans in the port's collector; the journal of a hier run
    (t_star_s in every event) is the reference's, byte for byte."""
    ref = _ref(solver=())
    ref.rng = np.random.default_rng(SEED + 17)
    ref._sample_rng = np.random.default_rng((SEED + 5557,))
    xs, ys = _data()
    t_spans.enable()
    port = t_api.build_experiment(
        _spec(t_config), xs, ys, device="cpu",
        parity_generators=carry.hier_generators_from_reference(
            _reference_generators(ref), device="cpu"))
    ref.run(ROUNDS, journal_dir=str(tmp_path / "ref"), n_rounds=4)
    res = port.run(ROUNDS, journal_dir=str(tmp_path / "port"), n_rounds=4)
    totals = t_spans.totals()
    for name in ("setup/experiment", "hier/shard_setup", "solver/two_step",
                 "encode/parity", "hier/round_block"):
        assert name in totals, name
    assert totals["hier/shard_setup"]["count"] == 3
    assert totals["hier/round_block"]["count"] == 2
    raw = (tmp_path / "port" / t_events.EVENTS_NAME).read_bytes()
    assert raw == (tmp_path / "ref" / t_events.EVENTS_NAME).read_bytes()
    events = t_events.load_events(str(tmp_path / "port"))
    assert [e["t_star_s"] for e in events] == \
        [[p.t_star for p in port.plans]] * ROUNDS
    assert [e["returned"] for e in events] == res.n_ret.tolist()


# ------------------------------------------------------------------ routing
def test_identity_routes_to_the_flat_engine_bit_identically():
    xs, ys = _data()
    spec = _spec(t_config, shards=1, f=1.0)
    routed = t_api.build_experiment(spec, xs, ys, device="cpu")
    assert type(routed) is t_runtime.Experiment
    flat = t_runtime.Experiment(spec, xs, ys, device="cpu")
    assert torch.equal(routed.run(3).theta, flat.run(3).theta)
    hier = t_api.build_experiment(
        _spec(t_config), data_fn=lambda lo, hi: (xs[lo:hi], ys[lo:hi]),
        device="cpu")
    assert isinstance(hier, HierExperiment) and len(hier.plans) == 3
    assert hier.device == torch.device("cpu")
    # the reference's scale module's own check, in the port
    ident = t_scale._identity_check(l=L, q=Q, c=C, rounds=3, seed=0,
                                    device="cpu")
    assert ident == {"routes_flat_engine": True, "bit_identical": True}


def test_build_experiment_refusals_match_reference():
    xs, ys = _data()
    for api, mod, kw in ((ref_api, ref_config, {}),
                         (t_api, t_config, {"device": "cpu"})):
        with pytest.raises(ValueError, match="nodes/mesh"):
            api.build_experiment(_spec(mod), xs, ys, nodes=[], **kw)
        with pytest.raises(ValueError, match="hierarchical tier"):
            api.build_experiment(_spec(mod, shards=1, f=1.0), None, None,
                                 data_fn=lambda lo, hi: (None, None), **kw)
    with pytest.raises(ValueError, match="rff_draw and secure_masks"):
        t_api.build_experiment(_spec(t_config), xs, ys, device="cpu",
                               rff_draw=(np.zeros((2, Q)), np.zeros(Q)))


def test_flat_engine_refuses_hier_spec_and_state():
    xs, ys = _data()
    with pytest.raises(ValueError, match="hierarchical tier") as got:
        t_runtime.Experiment(_spec(t_config), xs, ys, device="cpu")
    assert "repro_torch.api.build_experiment" in str(got.value)
    # the reference's flat run_block would run a hier state as a single
    # trajectory; the port's names the tier instead
    flat = t_api.build_experiment(_spec(t_config, shards=1, f=1.0), xs, ys,
                                  device="cpu")
    hier_state = _port_cached().init_state(4)
    with pytest.raises(ValueError, match="hierarchical tier"):
        flat.run_block(hier_state)


# --------------------------------------------------------------- launchers
def test_run_scale_matches_reference():
    kw = dict(ns=(200,), l=3, q=5, c=2, rounds=2, trace_rounds=1)
    want = ref_scale.run_scale(**kw)
    got = t_scale.run_scale(device="cpu", **kw)
    timings = ("setup_seconds", "round_seconds", "wall_seconds",
               "trace_seconds")
    assert {k: v for k, v in got.items() if k != "entries"} == \
        {k: v for k, v in want.items() if k != "entries"}
    for g, w in zip(got["entries"], want["entries"]):
        assert sorted(g) == sorted(w)
        assert {k: v for k, v in g.items() if k not in timings} == \
            {k: v for k, v in w.items() if k not in timings}
    assert t_scale.validate_scale(got, required_ns=(200,)) == []
    assert ref_scale.validate_scale(want, required_ns=(200,)) == []
    assert t_scale.REQUIRED_NS == ref_scale.REQUIRED_NS
    bad = dict(got, identity={"routes_flat_engine": True})
    assert t_scale.validate_scale(bad, required_ns=(200,)) == \
        ref_scale.validate_scale(bad, required_ns=(200,))
    assert t_scale.validate_scale(got) == ref_scale.validate_scale(got)
    for lo, hi in ((0, 3), (5, 9)):
        for a, b in zip(t_scale.synthetic_block(lo, hi, 3, 5, 2),
                        ref_scale.synthetic_block(lo, hi, 3, 5, 2)):
            np.testing.assert_array_equal(a, b)


def test_hier_scale_launcher_runs_on_the_cpu(monkeypatch):
    """The example's flow at a cut population: kill/resume bit-identical,
    the identity configuration flat, every line printed."""
    monkeypatch.setattr(hier_scale, "N", 400)
    monkeypatch.setattr(hier_scale, "SHARDS", 2)
    real = t_scale.run_scale
    monkeypatch.setattr(hier_scale.launch_scale, "run_scale",
                        lambda **kw: real(**dict(kw, ns=(200,))))
    lines = []
    out = hier_scale.main(device="cpu", out=lines.append)
    assert out["bit_identical"] is True
    assert out["section"]["identity"]["bit_identical"] is True
    assert out["peak_bytes"] < out["dense_bytes"]
    assert out["result"].shards == 2 and len(out["result"].n_ret) == 4
    assert len(lines) == 7 and "bit-identical = True" in lines[2]


# ------------------------------------------------------------------ service
def test_service_refuses_hier_jobs_as_the_reference(tmp_path):
    """The reference's service calls ``init_state(iterations,
    n_realizations=..., collect=...)``, which ``HierExperiment.init_state``
    does not take: both packages raise the same TypeError."""
    xs, ys = _data()
    with pytest.raises(TypeError) as want:
        RefService(str(tmp_path / "ref")).submit(
            _spec(ref_config, checkpoint_every=2), xs, ys, 4, run_id="h")
    with pytest.raises(TypeError) as got:
        ExperimentService(str(tmp_path / "port"), device="cpu").submit(
            _spec(t_config, checkpoint_every=2), xs, ys, 4, run_id="h")
    assert "n_realizations" in str(want.value)
    assert "n_realizations" in str(got.value)


def test_hier_modules_import_neither_jax_nor_repro():
    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "import repro_torch.hier, repro_torch.hier.population\n"
        "import repro_torch.hier.sampling, repro_torch.hier.topology\n"
        "import repro_torch.launch.scale, repro_torch.launch.hier_scale\n"
        "import repro_torch.api, repro_torch.carry\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root, timeout=120)
