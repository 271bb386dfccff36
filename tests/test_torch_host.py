"""Host-side NumPy work of the PyTorch port against the JAX reference.

The port keeps its own copies of the reference's NumPy modules (delay
model, scalar allocation solver, privacy, data) and of its config
dataclasses.  On the same `np.random.Generator` and the same inputs they
must give bit-identical results: this is what makes the port's processed
subsets, returned counts and wall clock equal the reference's.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import config as ref_config
from repro.core import delay_model as ref_dm
from repro.core import encoding as ref_enc
from repro.core import load_allocation as ref_la
from repro.core import privacy as ref_privacy
from repro.core import rff as ref_rff
from repro.core import secure_agg as ref_sa
from repro.data import sharding as ref_sharding
from repro.data import synthetic as ref_synthetic

from repro_torch import api as t_api
from repro_torch import config as t_config
from repro_torch.core import delay_model as t_dm
from repro_torch.core import load_allocation as t_la
from repro_torch.core import privacy as t_privacy
from repro_torch.core import rff as t_rff
from repro_torch.core import secure_agg as t_sa
from repro_torch.data import sharding as t_sharding
from repro_torch.data import synthetic as t_synthetic
from repro_torch.device import resolve_device

PROFILES = ["uniform", "paper", "mac_heavy", "brutal"]


def _fl_pair(profile="paper", **kw):
    knobs = dict(t_dm.HETEROGENEITY_PROFILES[profile], **kw)
    return ref_config.FLConfig(**knobs), t_config.FLConfig(**knobs)


def _node_fields(nodes):
    return [dataclasses.astuple(nd) for nd in nodes]


@pytest.mark.parametrize("profile", PROFILES)
def test_mec_network_bit_identical(profile):
    ref_fl, t_fl = _fl_pair(profile, n_clients=12, seed=5)
    assert _node_fields(t_dm.mec_network(t_fl, 640)) == \
        _node_fields(ref_dm.mec_network(ref_fl, 640))


def test_delay_helpers_bit_identical():
    ref_fl, t_fl = _fl_pair(n_clients=6, seed=2)
    ref_nodes = ref_dm.mec_network(ref_fl, 96)
    t_nodes = t_dm.mec_network(t_fl, 96)
    bits = t_dm.packet_bits(t_fl, 96)
    assert bits == ref_dm.packet_bits(ref_fl, 96)
    assert _node_fields([t_dm.scale_tau(nd, bits) for nd in t_nodes]) == \
        _node_fields([ref_dm.scale_tau(nd, bits) for nd in ref_nodes])
    assert t_dm.ideal_round_time(t_nodes, 40.0) == \
        ref_dm.ideal_round_time(ref_nodes, 40.0)
    assert t_dm.HETEROGENEITY_PROFILES == ref_dm.HETEROGENEITY_PROFILES


def test_sample_round_times_bit_identical():
    ref_fl, t_fl = _fl_pair(n_clients=9, seed=1)
    ref_nodes = ref_dm.mec_network(ref_fl, 64)
    t_nodes = t_dm.mec_network(t_fl, 64)
    loads = np.array([0, 3, 5, 8, 8, 2, 0, 7, 1], float)
    got = t_dm.sample_round_times(t_nodes, loads, np.random.default_rng(7),
                                  rounds=13)
    want = ref_dm.sample_round_times(ref_nodes, loads,
                                     np.random.default_rng(7), rounds=13)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("profile", PROFILES)
def test_two_step_allocate_bit_identical(profile):
    ref_fl, t_fl = _fl_pair(profile, n_clients=10, seed=3)
    payload = t_dm.packet_bits(t_fl, 96)
    ref_nodes = [ref_dm.scale_tau(nd, payload)
                 for nd in ref_dm.mec_network(ref_fl, 96)]
    t_nodes = [t_dm.scale_tau(nd, payload)
               for nd in t_dm.mec_network(t_fl, 96)]
    kw = dict(server=None, u_max=60.0, m=400.0)
    got = t_la.two_step_allocate(t_nodes, [40.0] * 10, **kw)
    want = ref_la.two_step_allocate(ref_nodes, [40.0] * 10, **kw)
    assert got.t_star == want.t_star
    np.testing.assert_array_equal(got.loads, want.loads)
    np.testing.assert_array_equal(got.returns, want.returns)
    assert t_la.vectorized_grid_width(t_nodes) == \
        ref_la.vectorized_grid_width(ref_nodes)


def test_mi_dp_budget_bit_identical():
    x = np.random.default_rng(4).normal(size=(30, 17)).astype(np.float32)
    for u in (1, 12, 300):
        assert t_privacy.mi_dp_budget(x, u) == ref_privacy.mi_dp_budget(x, u)


def test_data_helpers_bit_identical():
    kw = dict(m_train=300, m_test=60, d=12, n_classes=4, seed=2)
    t_ds = t_synthetic.synthetic_classification(**kw)
    ref_ds = ref_synthetic.synthetic_classification(**kw)
    for field in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(t_ds, field),
                                      getattr(ref_ds, field))
    np.testing.assert_array_equal(t_ds.one_hot(t_ds.y_test),
                                  ref_ds.one_hot(ref_ds.y_test))
    ref_fl, t_fl = _fl_pair(n_clients=6, seed=0)
    t_shards = t_sharding.sort_and_shard(t_ds.x_train, t_ds.y_train, 6)
    ref_shards = ref_sharding.sort_and_shard(ref_ds.x_train, ref_ds.y_train,
                                             6)
    t_pc = t_sharding.assign_shards_by_speed(
        t_shards, t_dm.mec_network(t_fl, 48), minibatch=50)
    ref_pc = ref_sharding.assign_shards_by_speed(
        ref_shards, ref_dm.mec_network(ref_fl, 48), minibatch=50)
    for got, want in zip(t_sharding.stack_clients(t_pc),
                         ref_sharding.stack_clients(ref_pc)):
        np.testing.assert_array_equal(got, want)


def test_rff_host_helpers_bit_identical():
    x = np.random.default_rng(9).normal(size=(50, 7)).astype(np.float32)
    assert t_rff.median_sigma(x, n_pairs=300) == \
        ref_rff.median_sigma(x, n_pairs=300)
    assert t_rff.suggest_lr(x) == ref_rff.suggest_lr(x)
    assert t_rff.suggest_lr(torch.from_numpy(x)) == ref_rff.suggest_lr(x)


_SPECS = [
    dict(),
    dict(fl=dict(n_clients=12, delta=0.2, psi=0.3, seed=4),
         train=dict(learning_rate=0.5, lr_decay_epochs=[3, 9]),
         rff=dict(q=64, sigma=2.0), scheme="partial_coded",
         scheme_params={"u_fraction": 0.3}, delay_profile="mild"),
    dict(scheme="greedy", kernel_backend="pallas", alloc_backend="scalar",
         nonfinite_guard=False, steps_per_epoch=3, run_id="run-1"),
    dict(channel_profile="markov_loss", fault_profile="none",
         secure_aggregation=True, fused_coded=False, checkpoint_every=5),
]


def _spec(mod, kw):
    kw = dict(kw)
    for key, typ in (("fl", mod.FLConfig), ("train", mod.TrainConfig),
                     ("rff", mod.RFFConfig)):
        if key in kw:
            val = dict(kw[key])
            if "lr_decay_epochs" in val:
                val["lr_decay_epochs"] = tuple(val["lr_decay_epochs"])
            kw[key] = typ(**val)
    return mod.ExperimentSpec(**kw)


@pytest.mark.parametrize("kw", _SPECS, ids=range(len(_SPECS)))
def test_spec_round_trip_matches_reference(kw):
    t_spec = _spec(t_config, kw)
    ref_spec = _spec(ref_config, kw)
    assert t_spec.to_dict() == ref_spec.to_dict()
    # the reference's JSON revives in the port and back
    ref_json = json.loads(json.dumps(ref_spec.to_dict()))
    assert t_config.ExperimentSpec.from_dict(ref_json) == t_spec
    assert ref_config.ExperimentSpec.from_dict(
        json.loads(json.dumps(t_spec.to_dict()))) == ref_spec
    assert t_spec.resolved_fl() == t_config.FLConfig(
        **dataclasses.asdict(ref_spec.resolved_fl()))


# (id, spec fields): the client mesh with each feature it once rode along
# with, when the port refused the mesh.  Each case now takes the
# reference's own outcome for the same spec in the same process (one JAX
# device, no process group): mesh=2 raises the reference's ValueError
# ("device"); mesh=1, in the spec or as the build_experiment override,
# builds and runs as the reference does, or raises the reference's type
# and message (hier, fused_embed, adaptive)
_UNSUPPORTED = [
    ("channel dynamics", dict(channel_profile="static", mesh=2)),
    ("fault injection", dict(fault_profile="crash_loop", mesh=2)),
    ("hierarchical", dict(hier_shards=2, mesh=2)),
    ("client-mesh", dict(mesh=2)),
    ("secure aggregation", dict(secure_aggregation=True, mesh=2)),
    ("adaptive", dict(scheme="adaptive_coded", adapt_every=2, mesh=2)),
    ("fused_embed", dict(fused_embed=True, mesh=2)),
    ("fused_coded=False", dict(fused_coded=False, mesh=2)),
    ("legacy", dict(engine="legacy", mesh=2)),
]
_MESH_N, _MESH_L, _MESH_Q, _MESH_C = 4, 6, 8, 2


def _mesh_draws(u):
    """The reference's coded draws of a `_mesh_outcome` deployment (seed
    0): the generator split chain from PRNGKey(99) and the secure pair
    masks from PRNGKey(1234), for the port to take over."""
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(99), None,
                           length=_MESH_N)
    gens = np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, _MESH_L))(keys))
    like = ref_enc.LocalParity(x=jnp.zeros((u, _MESH_Q), jnp.float32),
                               y=jnp.zeros((u, _MESH_C), jnp.float32))
    key = jax.random.PRNGKey(1234)
    masks = [ref_sa._mask_like(ref_sa._pair_key(key, i, j), like, 1.0)
             for i, j in t_sa.pairs(_MESH_N)]
    return gens, (np.stack([np.asarray(m.x) for m in masks]),
                  np.stack([np.asarray(m.y) for m in masks]))


def _mesh_outcome(mod, api, kw, override, extra):
    """("built", 3-round result, experiment) of making the spec, building
    it with ``mesh=override`` and running it, or (exception type name,
    message) where one of them raises."""
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(_MESH_N, _MESH_L, _MESH_Q)).astype(np.float32)
    xs *= 0.3
    theta_true = rng.normal(size=(_MESH_Q, _MESH_C)).astype(np.float32)
    ys = np.einsum("nlq,qc->nlc", xs, theta_true).astype(np.float32)
    kw = dict(kw)
    if kw.get("fused_embed"):
        kw["rff"] = mod.RFFConfig(q=_MESH_Q)
    try:
        spec = mod.ExperimentSpec(
            fl=mod.FLConfig(n_clients=_MESH_N),
            train=mod.TrainConfig(learning_rate=0.05), **kw)
        exp = api.build_experiment(spec, xs, ys, mesh=override,
                                   **extra(spec, xs, ys))
    except (ValueError, NotImplementedError) as exc:
        return type(exc).__name__, str(exc)
    return "built", exp.run(3), exp


def _port_extra(spec, xs, ys):
    """The port's build arguments: the CPU, and the reference's coded
    draws where the flat engine's coded scheme makes them."""
    extra = {"device": "cpu"}
    if spec.hier_active or spec.resolved_scheme != "coded":
        return extra
    u = t_api.build_experiment(dataclasses.replace(spec, mesh=None), xs, ys,
                               device="cpu").u
    gens, masks = _mesh_draws(u)
    extra["parity_generators"] = gens
    if spec.secure_aggregation:
        extra["secure_masks"] = masks
    return extra


def _same_outcome(ref, port):
    assert port[0] == ref[0]
    if ref[0] != "built":
        assert port[1] == ref[1].replace("repro.hier", "repro_torch.hier")
        return
    want, got = ref[1], port[1]
    assert [h.wall_clock for h in got.history] == \
        [h.wall_clock for h in want.history]
    assert [h.returned for h in got.history] == \
        [h.returned for h in want.history]
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               atol=1e-5)


@pytest.mark.parametrize("kw", [case[1] for case in _UNSUPPORTED],
                         ids=[case[0] for case in _UNSUPPORTED])
def test_unsupported_feature_raises_at_build(kw):
    # mesh=2 in one process: the reference's ValueError, the same words up
    # to the hint on how to get more devices (or the spec's own refusal)
    ref = _mesh_outcome(ref_config, ref_api, kw, None, lambda *a: {})
    port = _mesh_outcome(t_config, t_api, kw, None, _port_extra)
    assert port[0] == ref[0] == "ValueError"
    assert port[1].split(" (")[0] == ref[1].split(" (")[0]
    if kw.get("hier_shards", 1) == 1 and not kw.get("fused_embed"):
        assert "device" in port[1]
    # mesh=1 in the spec, then as the override
    for spec_mesh, override in ((1, None), (None, 1)):
        over = dict(kw, mesh=spec_mesh)
        _same_outcome(
            _mesh_outcome(ref_config, ref_api, over, override,
                          lambda *a: {}),
            _mesh_outcome(t_config, t_api, over, override, _port_extra))


_PORTED = [
    ("fault injection", dict(fault_profile="chaos")),
    ("secure aggregation", dict(secure_aggregation=True)),
    ("secure unfused with faults", dict(secure_aggregation=True,
                                        fused_coded=False,
                                        fault_profile="byzantine_lite")),
    ("fused_embed secure with faults",
     dict(fused_embed=True, rff=t_config.RFFConfig(q=8),
          secure_aggregation=True, fault_profile="corrupt_parity")),
    ("channel with faults", dict(channel_profile="churn",
                                 fault_profile="flaky_clients")),
]


@pytest.mark.parametrize("kw", [k for _, k in _PORTED],
                         ids=[i for i, _ in _PORTED])
def test_ported_features_build_and_run(kw):
    spec = t_config.ExperimentSpec(fl=t_config.FLConfig(n_clients=4),
                                   **kw)
    rng = np.random.default_rng(1)
    xs = rng.normal(size=(4, 6, 8)).astype(np.float32)
    ys = rng.normal(size=(4, 6, 2)).astype(np.float32)
    res = t_api.build_experiment(spec, xs, ys, device="cpu").run(3)
    assert len(res.history) == 3 and torch.isfinite(res.theta).all()


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        t_api.build_experiment(t_config.ExperimentSpec(
            fl=t_config.FLConfig(n_clients=2)),
            np.zeros((2, 3, 4), np.float32), np.zeros((2, 3, 1), np.float32))
    assert resolve_device("cpu") == torch.device("cpu")
