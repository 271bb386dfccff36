"""Host-side NumPy work of the PyTorch port against the JAX reference.

The port keeps its own copies of the reference's NumPy modules (delay
model, scalar allocation solver, privacy, data) and of its config
dataclasses.  On the same `np.random.Generator` and the same inputs they
must give bit-identical results: this is what makes the port's processed
subsets, returned counts and wall clock equal the reference's.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import config as ref_config
from repro.core import delay_model as ref_dm
from repro.core import load_allocation as ref_la
from repro.core import privacy as ref_privacy
from repro.core import rff as ref_rff
from repro.data import sharding as ref_sharding
from repro.data import synthetic as ref_synthetic

from repro_torch import api as t_api
from repro_torch import config as t_config
from repro_torch.core import delay_model as t_dm
from repro_torch.core import load_allocation as t_la
from repro_torch.core import privacy as t_privacy
from repro_torch.core import rff as t_rff
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


# (id, spec fields, the feature the refusal names, a ported feature it
# must no longer name): the ported ones ride along with the one missing
# feature, the client mesh.  The hierarchical tier is ported; with a mesh
# the spec itself refuses it, with the reference's ValueError
_UNSUPPORTED = [
    ("channel dynamics", dict(channel_profile="static", mesh=2),
     "client-mesh", "channel"),
    ("fault injection", dict(fault_profile="crash_loop", mesh=2),
     "client-mesh", "fault injection"),
    ("hierarchical", dict(hier_shards=2, mesh=2), "not a device mesh",
     "hierarchical tier (hier_shards"),
    ("client-mesh", dict(mesh=2), "client-mesh", None),
    ("secure aggregation", dict(secure_aggregation=True, mesh=2),
     "client-mesh", "secure aggregation"),
    ("adaptive", dict(scheme="adaptive_coded", adapt_every=2, mesh=2),
     "client-mesh", "adaptive"),
    # fused_embed combines with neither missing feature (a spec refuses it
    # with a mesh or the hierarchical tier): the mesh refusal alone
    ("fused_embed", dict(mesh=2), "client-mesh", "fused_embed"),
    ("fused_coded=False", dict(fused_coded=False, mesh=2), "client-mesh",
     "fused_coded"),
    ("legacy", dict(engine="legacy", mesh=2), "client-mesh", "legacy"),
]


@pytest.mark.parametrize("kw,feature,ported",
                         [case[1:] for case in _UNSUPPORTED],
                         ids=[case[0] for case in _UNSUPPORTED])
def test_unsupported_feature_raises_at_build(kw, feature, ported):
    if kw.get("hier_shards", 1) > 1:
        # refused when the spec is made, in both packages, as the
        # reference refuses it; the tier itself is no missing feature
        for mod in (ref_config, t_config):
            with pytest.raises(ValueError, match=feature):
                mod.ExperimentSpec(fl=mod.FLConfig(n_clients=4), **kw)
        spec = t_config.ExperimentSpec(fl=t_config.FLConfig(n_clients=4),
                                       hier_shards=2)
        assert t_config.unsupported_features(spec) == []
        assert ported not in " ".join(t_config.unsupported_features(
            t_config.ExperimentSpec(mesh=2)))
        return
    spec = t_config.ExperimentSpec(fl=t_config.FLConfig(n_clients=4), **kw)
    xs = np.zeros((4, 6, 8), np.float32)
    ys = np.zeros((4, 6, 2), np.float32)
    with pytest.raises(NotImplementedError, match=feature) as info:
        t_api.build_experiment(spec, xs, ys, device="cpu")
    if ported is not None:
        assert ported not in str(info.value)
        assert ported not in " ".join(t_config.unsupported_features(spec))


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
    assert t_config.unsupported_features(spec) == []
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
