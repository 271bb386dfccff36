"""The port's profile-grid sweep (``repro_torch.launch.sweep``) against a
looped ``run_multi`` and against the JAX reference's sweep, on the CPU.

The cases of ``tests/test_sweep_engine.py`` on the port: every (scheme,
profile) cell equals the deployment's ``run_multi`` from the same generator
position (wall clock, returned counts and, the padding rows being skipped,
theta bit for bit); coded profiles pad to a common point length; prebuilt
sims are accepted; a profile mismatch and a step-static override are
refused.  Against the reference's ``run_sweep`` (its parity generators
carried over for each profile with ``repro_torch.carry``): wall clock and
returned counts bit-identical, theta within 1e-5, the tolerance of
``tests/test_sweep_engine.py`` and ``tests/test_torch_engine.py``.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro import config as ref_config
from repro.core import encoding as ref_enc
from repro.launch import sweep as ref_sweep

from repro_torch import api as t_api
from repro_torch import config as t_config
from repro_torch.launch import sweep as t_sweep

PROFILES = {
    "uniform": dict(rate_decay=1.0, mac_decay=1.0),
    "paper": dict(rate_decay=0.95, mac_decay=0.8),
    "extreme": dict(rate_decay=0.9, mac_decay=0.6),
}
BASE = dict(n_clients=6, delta=0.25, psi=0.3, seed=3)
N, L, Q, C = 6, 16, 24, 3


def _data(n=N, l=L, q=Q, c=C, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, l, q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(n, l, c)).astype(np.float32)
    return xs, ys


def _tc(mod=t_config):
    return mod.TrainConfig(learning_rate=0.5, l2_reg=1e-5,
                           lr_decay_epochs=(5,))


def _spec(mod, scheme, knobs, base=BASE, **over):
    return mod.ExperimentSpec(fl=mod.FLConfig(**{**base, **knobs}),
                              train=_tc(mod), scheme=scheme, **over)


def _exp(xs, ys, scheme, knobs, base=BASE, gens=None, **over):
    """Spec-built port deployment matching one sweep grid cell."""
    return t_api.build_experiment(_spec(t_config, scheme, knobs, base,
                                        **over), xs, ys, device="cpu",
                                  parity_generators=gens)


@functools.lru_cache(maxsize=None)
def _reference_generators(seed, n, u, l):
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(seed + 99), None,
                           length=n)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, l))(keys))


@pytest.fixture(scope="module")
def sweep_result():
    xs, ys = _data()
    return xs, ys, t_sweep.run_sweep(
        xs, ys, profiles=PROFILES, train_cfg=_tc(), iterations=10,
        realizations=4, fl_kwargs=BASE, device="cpu")


def _same_cell(got, loop):
    np.testing.assert_array_equal(got.wall_clock, loop.wall_clock)
    np.testing.assert_array_equal(got.returned, loop.returned)
    assert torch.equal(got.theta, loop.theta)
    assert got.setup_time == loop.setup_time
    assert got.t_star == loop.t_star
    np.testing.assert_array_equal(got.loads, loop.loads)


@pytest.mark.parametrize("scheme", t_sweep.SCHEMES)
def test_sweep_matches_looped_run_multi(sweep_result, scheme):
    """Every cell reproduces an identically seeded run_multi: wall clock,
    returned counts and theta bit for bit (one step, the same inputs)."""
    xs, ys, sw = sweep_result
    for pname, knobs in PROFILES.items():
        loop = _exp(xs, ys, scheme, knobs).run_multi(10, 4)
        _same_cell(sw.results[scheme][pname], loop)


def test_sweep_shapes_and_metadata(sweep_result):
    xs, ys, sw = sweep_result
    assert tuple(t_sweep.SCHEMES) == tuple(ref_sweep.SCHEMES)
    for scheme in t_sweep.SCHEMES:
        assert set(sw.results[scheme]) == set(PROFILES)
        assert sw.host_seconds[scheme] > 0
        for res in sw.results[scheme].values():
            assert tuple(res.theta.shape) == (4, Q, C)
            assert res.wall_clock.shape == (4, 10)
            assert res.returned.shape == (4, 10)
            assert np.all(np.diff(res.wall_clock, axis=1) > 0)


def test_sweep_accepts_prebuilt_sims():
    xs, ys = _data()
    sims = {"coded": {p: _exp(xs, ys, "coded", k)
                      for p, k in PROFILES.items()}}
    sw = t_sweep.run_sweep(xs, ys, profiles=PROFILES, train_cfg=_tc(),
                           iterations=6, realizations=2,
                           schemes=("coded",), fl_kwargs=BASE, sims=sims)
    assert sw.sims["coded"] is sims["coded"]
    assert set(sw.results["coded"]) == set(PROFILES)


def test_sweep_pads_coded_profiles_to_common_length():
    """Unfused coded at delta = 0.5: the uniform profile's largest load is
    below the others', so its tensors are padded to the longest; every
    cell still gives its unpadded run_multi's bits."""
    base = dict(BASE, delta=0.5)
    xs, ys = _data()
    sims = {p: _exp(xs, ys, "coded", k, base, fused_coded=False)
            for p, k in PROFILES.items()}
    sw = t_sweep.run_sweep(xs, ys, profiles=PROFILES, train_cfg=_tc(),
                           iterations=6, realizations=2, schemes=("coded",),
                           fl_kwargs=base, sims={"coded": sims})
    lens = {p: sims[p].consts_point_len() for p in PROFILES}
    assert len(set(lens.values())) > 1
    for pname, knobs in PROFILES.items():
        assert sims[pname].build_consts()["gx"].shape[1] == lens[pname]
        loop = _exp(xs, ys, "coded", knobs, base,
                    fused_coded=False).run_multi(6, 2)
        _same_cell(sw.results["coded"][pname], loop)
    assert len({sims[p].t_star for p in PROFILES}) > 1


@pytest.mark.parametrize("scheme,fused", [("coded", True), ("coded", False),
                                          ("partial_coded", True),
                                          ("adaptive_coded", True),
                                          ("naive", True)])
def test_padded_round_keeps_the_bits(scheme, fused):
    """Rounds over consts padded past the point length give the unpadded
    rounds' bits: the padding rows lie past the live rows, which the round
    does not read (full-load schemes are not padded at all)."""
    xs, ys = _data()
    over = dict(fused_coded=fused)
    if scheme == "adaptive_coded":
        over.update(adapt_every=2)
    exp = _exp(xs, ys, scheme, {}, **over)
    plain = exp.build_consts()
    l_target = exp.consts_point_len() + 7
    padded = exp.build_consts(l_target=l_target)
    want_len = exp.l if scheme == "naive" else l_target
    assert padded["gx"].shape[1] == want_len
    times = exp._delays(np.random.default_rng(1), 6)
    lrs = exp._device(exp._lr_schedule(6))
    xs_in = (times, lrs)
    if scheme == "adaptive_coded":
        # the static profile's inputs: every client present, the setup's
        # deadline and mask block
        plain = dict(plain, gmask_blocks=plain["gmask"][None])
        padded = dict(padded, gmask_blocks=padded["gmask"][None])
        xs_in = xs_in + (torch.ones_like(times),
                         torch.full((6,), float(exp.t_star)), [0] * 6)
    zeros = torch.zeros((exp.q, exp.c))
    want = exp._rounds(zeros, 1.0, xs_in, consts=plain)
    got = exp._rounds(zeros, 1.0, xs_in, consts=padded)
    assert torch.equal(got[0][0], want[0][0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("scheme,fused", [("coded", True), ("coded", False),
                                          ("partial_coded", True),
                                          ("adaptive_coded", True)])
def test_padded_consts_match_reference(scheme, fused):
    """build_consts(l_target): the reference's shapes, masks and tail;
    consts_point_len the reference's."""
    from repro import api as ref_api
    xs, ys = _data()
    over = dict(fused_coded=fused)
    if scheme == "adaptive_coded":
        over["adapt_every"] = 2
    ref_exp = ref_api.build_experiment(
        _spec(ref_config, scheme, {}, **over), xs, ys)
    gens = _reference_generators(BASE["seed"], N, ref_exp.u, L)
    t_exp = _exp(xs, ys, scheme, {}, gens=gens, **over)
    assert t_exp.consts_point_len() == ref_exp.consts_point_len()
    l_target = ref_exp.consts_point_len() + 5
    got = t_exp.build_consts(l_target=l_target)
    want = ref_exp.build_consts(l_target=l_target)
    for key in ("gmask", "ret_tail"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    for key in ("gx", "gy"):
        assert tuple(got[key].shape) == want[key].shape
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5)


def test_sweep_rejects_sims_profile_mismatch():
    xs, ys = _data()
    partial = {"coded": {"paper": _exp(xs, ys, "coded", PROFILES["paper"])}}
    with pytest.raises(ValueError, match="cover profiles"):
        t_sweep.run_sweep(xs, ys, profiles=PROFILES, train_cfg=_tc(),
                          iterations=3, realizations=2, schemes=("coded",),
                          fl_kwargs=BASE, sims=partial, device="cpu")


def test_sweep_rejects_step_static_overrides():
    xs, ys = _data()
    bad_profiles = {"a": dict(psi=0.1), "b": dict(psi=0.9)}
    with pytest.raises(ValueError, match="n_wait"):
        t_sweep.run_sweep(xs, ys, profiles=bad_profiles, train_cfg=_tc(),
                          iterations=3, realizations=2, schemes=("greedy",),
                          fl_kwargs=BASE, device="cpu")


_REFUSED = [
    ("adaptive", dict(schemes=("adaptive_coded",)), "grid-sweepable"),
    ("channel", dict(base_spec=dict(channel_profile="churn")),
     "traced-channel"),
    ("fused_embed", dict(base_spec=dict(fused_embed=True,
                                        rff=t_config.RFFConfig(q=8))),
     "raw-feature"),
    ("hier", dict(base_spec=dict(hier_shards=2)), "edge-aggregator"),
    ("faults", dict(base_spec=dict(fault_profile="flaky_clients")),
     "fault-injection"),
]


@pytest.mark.parametrize("kw,match", [(k, m) for _, k, m in _REFUSED],
                         ids=[i for i, _, _ in _REFUSED])
def test_sweep_refusals_match_reference(kw, match):
    """The reference's refusals, raised before any deployment is built;
    the reference raises on the same spec."""
    xs, ys = _data()
    for mod, sweep_mod in ((t_config, t_sweep), (ref_config, ref_sweep)):
        args = dict(kw)
        if "base_spec" in args:
            over = dict(args["base_spec"])
            if "rff" in over:
                over["rff"] = mod.RFFConfig(q=8)
            args["base_spec"] = _spec(mod, "coded", {}, **over)
        with pytest.raises(ValueError, match=match):
            sweep_mod.run_sweep(xs, ys, profiles=PROFILES,
                                train_cfg=_tc(mod), iterations=3,
                                realizations=2, fl_kwargs=BASE, **args)


def test_prebuilt_faulty_sims_are_refused():
    xs, ys = _data()
    sims = {"naive": {p: _exp(xs, ys, "naive", k,
                              fault_profile="flaky_clients")
                      for p, k in PROFILES.items()}}
    with pytest.raises(ValueError, match="return faults"):
        t_sweep.run_sweep(xs, ys, profiles=PROFILES, train_cfg=_tc(),
                          iterations=3, realizations=2, schemes=("naive",),
                          fl_kwargs=BASE, sims=sims)


@pytest.mark.parametrize("scheme", ["coded", "greedy", "partial_coded"])
def test_sweep_matches_reference(scheme):
    """The reference's run_sweep against the port's, each profile's parity
    generators carried over."""
    xs, ys = _data()
    want = ref_sweep.run_sweep(xs, ys, profiles=PROFILES,
                               train_cfg=_tc(ref_config), iterations=8,
                               realizations=3, schemes=(scheme,),
                               fl_kwargs=BASE)
    sims = {}
    for pname, knobs in PROFILES.items():
        ref_sim = want.sims[scheme][pname]
        gens = (_reference_generators(BASE["seed"], N, ref_sim.u, L)
                if ref_sim.scheme_obj.coded else None)
        sims[pname] = _exp(xs, ys, scheme, knobs, gens=gens)
    got = t_sweep.run_sweep(xs, ys, profiles=PROFILES, train_cfg=_tc(),
                            iterations=8, realizations=3, schemes=(scheme,),
                            fl_kwargs=BASE, sims={scheme: sims})
    for pname in PROFILES:
        g, w = got.results[scheme][pname], want.results[scheme][pname]
        np.testing.assert_array_equal(g.wall_clock, w.wall_clock)
        np.testing.assert_array_equal(g.returned, w.returned)
        np.testing.assert_allclose(g.theta.numpy(), np.asarray(w.theta),
                                   atol=1e-5)
        assert g.t_star == w.t_star and g.setup_time == w.setup_time
        np.testing.assert_array_equal(g.loads, w.loads)


def test_experiment_sweep_front_end():
    """Experiment.sweep replays the experiment's spec over the profiles:
    the same cells as run_sweep with that spec as base_spec."""
    xs, ys = _data()
    spec = _spec(t_config, "greedy", {})
    exp = t_api.build_experiment(spec, xs, ys, device="cpu")
    got = exp.sweep(profiles=PROFILES, iterations=5, realizations=2)
    assert set(got.results) == {"greedy"}
    want = t_sweep.run_sweep(xs, ys, profiles=PROFILES, train_cfg=_tc(),
                             iterations=5, realizations=2,
                             schemes=("greedy",), base_spec=spec,
                             device="cpu")
    for pname in PROFILES:
        g, w = got.results["greedy"][pname], want.results["greedy"][pname]
        np.testing.assert_array_equal(g.wall_clock, w.wall_clock)
        assert torch.equal(g.theta, w.theta)
        assert got.sims["greedy"][pname].spec == \
            want.sims["greedy"][pname].spec
