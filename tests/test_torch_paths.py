"""The port's fused-embed, unfused-coded and legacy paths against the JAX
reference, end to end, on the CPU.

The same client data (NumPy, from a seed) goes through the reference's
``repro.api.build_experiment(...).run`` and the port's.  The reference's
random draws that the port cannot reproduce (the generator key chain, and
on the fused_embed path the (Omega, delta) its ``Experiment`` draws from
``spec.rff``) are carried over with ``repro_torch.carry`` and the
``parity_generators`` / ``rff_draw`` overrides.  The reference runs with
``kernel_backend="xla"`` and ``"pallas"`` (interpret mode).  Held to:

  * bit-identical: t*, loads, processed subsets, setup time, returned
    counts and the wall clock (same NumPy generator in the same order, same
    float32 casts; the legacy oracle's float64 deadlines on the host);
  * theta within atol 1e-5 and the per-round |theta|_1 trace within rtol
    1e-4, atol 1e-5, the tolerances of ``tests/test_torch_engine.py``;
  * privacy epsilon bit-identical where the port accounts over the same
    embedded features, and within rtol 1e-5 on the fused_embed path, where
    it accounts over its own embeds of the raw features (float32 products
    in another order feed f(X) of eq. 62).

Also: ``encode_local`` + ``aggregate_parity`` with the same generators, the
fused path against its two-pass control inside the port, the zero padding
past the live rows (l_max client rows, u parity rows) that the coded
rounds (fused_embed and the batched fused tensor) tell their kernels to
skip, and the spec combinations that both
packages refuse.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import config as ref_config
from repro.core import aggregation as ref_agg
from repro.core import encoding as ref_enc
from repro.core import rff as ref_rff

from repro_torch import api as t_api
from repro_torch import carry
from repro_torch import config as t_config
from repro_torch.core import aggregation as t_agg
from repro_torch.core import encoding as t_enc

SEED = 3
ROUNDS = 12
# fused_embed deployments: raw features (N, L, D), q = Q
N, L, D, Q, C = 6, 16, 8, 24, 3
# embedded deployments (unfused, legacy): (NE, LE, QE) features
NE, LE, QE = 8, 24, 32


def _raw_data(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(N, L, D)).astype(np.float32) * 0.5
    ys = rng.normal(size=(N, L, C)).astype(np.float32)
    return xs, ys


def _embedded_data(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(NE, LE, QE)).astype(np.float32) * 0.2
    ys = rng.normal(size=(NE, LE, C)).astype(np.float32)
    return xs, ys


def _spec(mod, scheme, n, kernel_backend="xla", **over):
    fl = mod.FLConfig(n_clients=n, delta=0.25, psi=0.3, seed=SEED)
    tc = mod.TrainConfig(learning_rate=0.5, l2_reg=1e-4,
                         lr_decay_epochs=(5, 9))
    params = {"u_fraction": 0.4} if scheme == "partial_coded" else {}
    return mod.ExperimentSpec(fl=fl, train=tc, scheme=scheme,
                              scheme_params=params,
                              kernel_backend=kernel_backend, **over)


def _fused_spec(mod, scheme, kernel_backend="xla", **over):
    return _spec(mod, scheme, N, kernel_backend,
                 rff=mod.RFFConfig(q=Q, sigma=1.5, seed=7), fused_embed=True,
                 **over)


def _reference_generators(n, u, l):
    """The reference's per-client generators: the split chain of
    ``CodedScheme.setup`` from PRNGKey(seed + 99)."""
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(SEED + 99), None,
                           length=n)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, l))(keys))


def _trace(theta):
    """(|theta|_1, 0): the per-round theta trace, recorded as the loss."""
    th = (theta.cpu().numpy() if isinstance(theta, torch.Tensor)
          else np.asarray(theta))
    return float(np.abs(th.astype(np.float64)).sum()), 0.0


def _port_twin(ref_exp, t_spec, xs, ys, **kw):
    gens = None
    if ref_exp.scheme_obj.coded:
        gens = carry.generators_from_reference(
            _reference_generators(ref_exp.n, ref_exp.u, ref_exp.l),
            device="cpu")
    return t_api.build_experiment(t_spec, xs, ys, device="cpu",
                                  parity_generators=gens, **kw)


def _assert_same_run(t_exp, t_res, ref_exp, ref_res, eps_rtol=0.0):
    assert t_res.t_star == ref_res.t_star
    np.testing.assert_array_equal(t_res.loads, ref_res.loads)
    assert len(t_exp.processed_idx) == len(ref_exp.processed_idx)
    for got, want in zip(t_exp.processed_idx, ref_exp.processed_idx):
        np.testing.assert_array_equal(got, want)
    assert t_res.setup_time == ref_res.setup_time
    if ref_res.privacy_eps is None or eps_rtol == 0.0:
        assert t_res.privacy_eps == ref_res.privacy_eps
    else:
        np.testing.assert_allclose(t_res.privacy_eps, ref_res.privacy_eps,
                                   rtol=eps_rtol)
    assert [h.returned for h in t_res.history] == \
        [h.returned for h in ref_res.history]
    assert [h.wall_clock for h in t_res.history] == \
        [h.wall_clock for h in ref_res.history]
    np.testing.assert_allclose(t_res.theta.numpy(), np.asarray(ref_res.theta),
                               atol=1e-5)
    for ht, hr in zip(t_res.history, ref_res.history):
        np.testing.assert_allclose(ht.loss, hr.loss, rtol=1e-4, atol=1e-5)
        assert (ht.n_masked, ht.skipped) == (hr.n_masked, hr.skipped)
    if ref_res.health is None:
        assert t_res.health is None
    else:
        assert dataclasses.astuple(t_res.health) == \
            dataclasses.astuple(ref_res.health)


# --------------------------------------------------------------- fused_embed
_FUSED = [(s, b) for s in ("coded", "naive", "greedy", "partial_coded")
          for b in ("xla", "pallas")]


@pytest.mark.parametrize("scheme,kernel_backend", _FUSED,
                         ids=[f"{s}-{b}" for s, b in _FUSED])
def test_fused_embed_matches_reference(scheme, kernel_backend):
    xs, ys = _raw_data()
    ref_spec = _fused_spec(ref_config, scheme, kernel_backend)
    ref_exp = ref_api.build_experiment(ref_spec, xs, ys)
    omega, delta = ref_rff.rff_params(ref_spec.rff, D)
    t_exp = _port_twin(
        ref_exp, _fused_spec(t_config, scheme, kernel_backend), xs, ys,
        rff_draw=carry.rff_from_reference(np.asarray(omega),
                                          np.asarray(delta), device="cpu"))
    assert t_exp.x.shape == (N, L, D) and t_exp.q == Q
    ref_res = ref_exp.run(ROUNDS, eval_fn=_trace, eval_every=1)
    t_res = t_exp.run(ROUNDS, eval_fn=_trace, eval_every=1)
    _assert_same_run(t_exp, t_res, ref_exp, ref_res, eps_rtol=1e-5)


def test_fused_embed_matches_two_pass_control():
    """Inside the port: the fused run against the two-pass control that
    embeds the same raw features with the same (Omega, delta) and runs with
    fused_embed off (the reference's ``tests/test_fused_embed.py``)."""
    xs, ys = _raw_data()
    spec = _fused_spec(t_config, "coded")
    fused = t_api.build_experiment(spec, xs, ys, device="cpu")
    phi = fused.embedded_x()
    assert phi.shape == (N, L, Q) and fused.x.shape == (N, L, D)
    control = t_api.build_experiment(
        dataclasses.replace(spec, fused_embed=False), phi, ys, device="cpu")
    rf = fused.run(ROUNDS, eval_fn=_trace, eval_every=1)
    rc = control.run(ROUNDS, eval_fn=_trace, eval_every=1)
    assert fused.t_star == control.t_star and fused.u == control.u
    assert fused.privacy_eps == control.privacy_eps
    assert [h.returned for h in rf.history] == [h.returned for h in rc.history]
    assert [h.wall_clock for h in rf.history] == \
        [h.wall_clock for h in rc.history]
    np.testing.assert_allclose(rf.theta.numpy(), rc.theta.numpy(), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="fused_embed"):
        control.embedded_x()


def test_fused_embed_tensors_match_reference():
    n, l_max, d, u, q, c = 3, 5, 4, 7, 6, 2
    rng = np.random.default_rng(11)
    sub_x = rng.normal(size=(n, l_max, d)).astype(np.float32)
    sub_y = rng.normal(size=(n, l_max, c)).astype(np.float32)
    mask = (rng.uniform(size=(n, l_max)) < 0.6).astype(np.float32)
    par_x = rng.normal(size=(u, q)).astype(np.float32)
    par_y = rng.normal(size=(u, c)).astype(np.float32)
    want = ref_agg.fused_embed_client_parity_tensors(
        sub_x, sub_y, mask, par_x, par_y, pnr_c=0.1, l_target=9)
    got = t_agg.fused_embed_client_parity_tensors(
        *(torch.from_numpy(a) for a in (sub_x, sub_y, mask, par_x, par_y)),
        pnr_c=0.1, l_target=9)
    for g_t, w_t in zip(got, want):
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(w_t))


@pytest.mark.parametrize("l_max,u,l_target", [(5, 9, None), (9, 5, None),
                                             (4, 6, 11)])
def test_fused_embed_tensors_are_zero_past_live_rows(l_max, u, l_target):
    """The guarantee the fused round's row skip rests on: past l_max the
    client rows of x, y and mask are zero, and past u so are the parity
    row's labels, mask and block pphi."""
    n, d, q, c = 3, 4, 6, 2
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for shape in ((n, l_max, d), (n, l_max, c), (n, l_max),
                          (u, q), (u, c))]
    fx, fy, fmask, pphi = t_agg.fused_embed_client_parity_tensors(
        *args, pnr_c=0.1, l_target=l_target)
    big = max(l_max, u, l_target or 1)
    assert fx.shape == (n, big, d) and pphi.shape == (big, q)
    for t in (fx[:, l_max:], fy[:n, l_max:], fmask[:n, l_max:],
              fy[n, u:], fmask[n, u:], pphi[u:]):
        assert not t.any()
    assert torch.equal(fx[:, :l_max], args[0])
    assert torch.equal(pphi[:u], args[3])


@pytest.mark.parametrize("scheme", ["coded", "partial_coded"])
def test_fused_embed_round_skips_padding_and_matches_reference(scheme,
                                                              monkeypatch):
    """The fused coded round hands the kernel live_rows = (l_max, u) every
    round, and still takes the reference's rounds and theta (the tolerance
    of test_fused_embed_matches_reference)."""
    from repro_torch.kernels import ops
    xs, ys = _raw_data()
    ref_spec = _fused_spec(ref_config, scheme)
    ref_exp = ref_api.build_experiment(ref_spec, xs, ys)
    omega, delta = ref_rff.rff_params(ref_spec.rff, D)
    t_exp = _port_twin(
        ref_exp, _fused_spec(t_config, scheme), xs, ys,
        rff_draw=carry.rff_from_reference(np.asarray(omega),
                                          np.asarray(delta), device="cpu"))
    consts = t_exp.build_consts()
    l_max, u = int(t_exp.loads.max()), t_exp.u
    assert consts["live_rows"] == (l_max, u)
    assert consts["gmask"].shape[1] > min(l_max, u)   # there is padding
    seen = []
    kernel = ops.rff_linreg_grad_masked

    def spy(*args, **kw):
        seen.append(kw.get("live_rows"))
        return kernel(*args, **kw)
    monkeypatch.setattr(ops, "rff_linreg_grad_masked", spy)
    ref_res = ref_exp.run(ROUNDS, eval_fn=_trace, eval_every=1)
    t_res = t_exp.run(ROUNDS, eval_fn=_trace, eval_every=1)
    assert seen == [(l_max, u)] * ROUNDS
    _assert_same_run(t_exp, t_res, ref_exp, ref_res, eps_rtol=1e-5)


@pytest.mark.parametrize("scheme", ["coded", "partial_coded"])
def test_coded_round_passes_live_rows_and_matches_reference(scheme,
                                                            monkeypatch):
    """The batched coded round (fused_coded, embedded features) hands
    linreg_grad_masked live_rows = (l_max, u) every round, and still takes
    the reference's rounds and theta: host quantities bit for bit, theta
    within the tolerance of tests/test_torch_engine.py."""
    from repro_torch.kernels import ops
    xs, ys = _embedded_data()
    ref_exp = ref_api.build_experiment(_spec(ref_config, scheme, NE), xs, ys)
    t_exp = _port_twin(ref_exp, _spec(t_config, scheme, NE), xs, ys)
    consts = t_exp.build_consts()
    l_max, u = int(t_exp.loads.max()), t_exp.u
    assert consts["live_rows"] == (l_max, u)
    assert consts["gmask"].shape[1] > min(l_max, u)   # there is padding
    seen = []
    kernel = ops.linreg_grad_masked

    def spy(*args, **kw):
        seen.append(kw.get("live_rows"))
        return kernel(*args, **kw)
    monkeypatch.setattr(ops, "linreg_grad_masked", spy)
    ref_res = ref_exp.run(ROUNDS, eval_fn=_trace, eval_every=1)
    t_res = t_exp.run(ROUNDS, eval_fn=_trace, eval_every=1)
    assert seen == [(l_max, u)] * ROUNDS
    _assert_same_run(t_exp, t_res, ref_exp, ref_res)


def test_coded_round_tensors_are_zero_past_live_rows():
    """The guarantee the batched coded round's row skip rests on: past
    l_max the client rows of x, y and mask are zero, and past u so are the
    parity row's."""
    n, l_max, q, c, u = 3, 5, 6, 2, 9
    rng = np.random.default_rng(6)
    args = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            for shape in ((n, l_max, q), (n, l_max, c), (n, l_max),
                          (u, q), (u, c))]
    fx, fy, fmask = t_agg.fused_client_parity_tensors(*args, pnr_c=0.1)
    assert fx.shape == (n + 1, u, q)
    for t in (fx[:n, l_max:], fy[:n, l_max:], fmask[:n, l_max:]):
        assert not t.any()
    assert torch.equal(fx[n, :u], args[3])
    with pytest.raises(ValueError, match="live_rows needs a mask"):
        t_agg.batched_client_gradients(fx, fy, torch.zeros((q, c)),
                                       live_rows=(l_max, u))


def test_rff_draw_is_checked():
    xs, ys = _raw_data()
    spec = _fused_spec(t_config, "naive")
    om = torch.zeros((D, Q + 1))
    with pytest.raises(ValueError, match="rff_draw"):
        t_api.build_experiment(spec, xs, ys, device="cpu",
                               rff_draw=(om, torch.zeros(Q + 1)))
    # the port's own draw from spec.rff is deterministic
    a, b = (t_api.build_experiment(spec, xs, ys, device="cpu")
            for _ in range(2))
    assert torch.equal(a.omega, b.omega) and torch.equal(a.delta, b.delta)
    with pytest.raises(ValueError, match="fused_embed=False"):
        t_api.build_experiment(
            dataclasses.replace(spec, fused_embed=False),
            np.zeros((N, L, Q), np.float32), ys, device="cpu",
            rff_draw=(a.omega, a.delta))


# ------------------------------------------------------- fused_coded=False
@pytest.mark.parametrize("kernel_backend", ["xla", "pallas"])
def test_unfused_coded_matches_reference(kernel_backend):
    xs, ys = _embedded_data()
    over = dict(fused_coded=False)
    ref_exp = ref_api.build_experiment(
        _spec(ref_config, "coded", NE, kernel_backend, **over), xs, ys)
    t_exp = _port_twin(ref_exp, _spec(t_config, "coded", NE, kernel_backend,
                                      **over), xs, ys)
    ref_res = ref_exp.run(ROUNDS, eval_fn=_trace, eval_every=1)
    t_res = t_exp.run(ROUNDS, eval_fn=_trace, eval_every=1)
    _assert_same_run(t_exp, t_res, ref_exp, ref_res)
    # the fused round computes the same gradient in one launch
    fused = _port_twin(ref_exp, _spec(t_config, "coded", NE, kernel_backend),
                       xs, ys).run(ROUNDS)
    np.testing.assert_allclose(fused.theta.numpy(), t_res.theta.numpy(),
                               atol=1e-5)


def test_unfused_guard_masks_a_non_finite_coded_gradient():
    """The unfused round's guard: a non-finite coded gradient is left out
    of the update and counted, as in the reference's `build_step`."""
    xs, ys = _embedded_data()
    exp = t_api.build_experiment(_spec(t_config, "coded", NE,
                                       fused_coded=False), xs, ys,
                                 device="cpu")
    exp.parity.x[0, 0] = float("nan")
    res = exp.run(3)
    assert [h.n_masked for h in res.history] == [1, 1, 1]
    assert torch.isfinite(res.theta).all()


# ------------------------------------------------------------- legacy oracle
@pytest.mark.parametrize("scheme", ["coded", "naive", "greedy", "ideal"])
def test_legacy_matches_reference(scheme):
    xs, ys = _embedded_data()
    over = dict(engine="legacy")
    ref_exp = ref_api.build_experiment(_spec(ref_config, scheme, NE, **over),
                                       xs, ys)
    t_exp = _port_twin(ref_exp, _spec(t_config, scheme, NE, **over), xs, ys)
    ref_res = ref_exp.run(ROUNDS, eval_fn=_trace, eval_every=1)
    t_res = t_exp.run(ROUNDS, eval_fn=_trace, eval_every=1)
    _assert_same_run(t_exp, t_res, ref_exp, ref_res)
    if scheme == "coded":
        for j, idx in enumerate(t_exp.processed_idx):
            torch.testing.assert_close(t_exp._sub_x[j],
                                       t_exp.x[j][torch.from_numpy(idx)],
                                       rtol=0, atol=0)
    # the oracle and the port's batched engine: same rounds, same theta
    batched = _port_twin(ref_exp, _spec(t_config, scheme, NE), xs,
                         ys).run(ROUNDS, eval_fn=_trace, eval_every=1)
    np.testing.assert_allclose(batched.theta.numpy(), t_res.theta.numpy(),
                               atol=1e-5)
    for hb, hl in zip(batched.history, t_res.history):
        assert hb.returned == hl.returned
        np.testing.assert_allclose(hb.wall_clock, hl.wall_clock, rtol=1e-5)


# --------------------------------------------------------------- encoding
def test_encode_local_and_aggregate_parity_match_reference():
    n, u, l, q, c = 3, 7, 11, 9, 2
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, l, q)).astype(np.float32)
    y = rng.normal(size=(n, l, c)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (n, l)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    want = ref_enc.aggregate_parity([
        ref_enc.encode_local(keys[j], x[j], y[j], w[j], u)
        for j in range(n)])
    gens = carry.generators_from_reference(np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, l))(keys)), device="cpu")
    parts = [t_enc.encode_local(gens[j], torch.from_numpy(x[j]),
                                torch.from_numpy(y[j]),
                                torch.from_numpy(w[j])) for j in range(n)]
    got = t_enc.aggregate_parity(parts)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=1e-5,
                               atol=1e-5)
    # the per-client loop and the batched encode: the same sums, though the
    # CPU's BLAS may order a single and a batched product differently
    stacked = t_enc.aggregate_parity_stacked(t_enc.encode_local_batched(
        gens, *(torch.from_numpy(a) for a in (x, y, w))))
    torch.testing.assert_close(got.x, stacked.x, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got.y, stacked.y, rtol=1e-6, atol=1e-6)


def test_client_coded_and_federated_gradients_match_reference():
    m, u, q, c = 9, 13, 7, 2
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, m, q)).astype(np.float32)
    y = rng.normal(size=(3, m, c)).astype(np.float32)
    px = rng.normal(size=(u, q)).astype(np.float32)
    py = rng.normal(size=(u, c)).astype(np.float32)
    theta = rng.normal(size=(q, c)).astype(np.float32) * 0.3
    th = torch.from_numpy(theta)
    want_c = [ref_agg.client_gradient(x[j], y[j], theta) for j in range(3)]
    got_c = [t_agg.client_gradient(torch.from_numpy(x[j]),
                                   torch.from_numpy(y[j]), th)
             for j in range(3)]
    for g, w_ in zip(got_c, want_c):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=1e-5,
                                   atol=1e-5)
    want_p = ref_agg.coded_gradient(px, py, theta, pnr_c=0.2)
    got_p = t_agg.coded_gradient(torch.from_numpy(px), torch.from_numpy(py),
                                 th, pnr_c=0.2)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-5,
                               atol=1e-5)
    ret = [True, False, True]
    want = ref_agg.federated_gradient(want_p, want_c, ret, 40, 1e-3, theta)
    got = t_agg.federated_gradient(got_p, got_c, ret, 40, 1e-3, th)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want_b = ref_agg.batched_client_gradients(x, y, theta)
    got_b = t_agg.batched_client_gradients(torch.from_numpy(x),
                                           torch.from_numpy(y), th)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------- spec validation
def _rff(mod):
    return {"rff": mod.RFFConfig(q=8)}


_REFUSED = [
    ("fused_embed-without-rff", lambda mod: dict(fused_embed=True)),
    ("fused_embed-legacy",
     lambda mod: dict(fused_embed=True, engine="legacy", **_rff(mod))),
    ("fused_embed-mesh",
     lambda mod: dict(fused_embed=True, mesh=2, **_rff(mod))),
    ("fused_embed-hier",
     lambda mod: dict(fused_embed=True, hier_shards=2, **_rff(mod))),
    ("legacy-checkpoint",
     lambda mod: dict(engine="legacy", checkpoint_every=3)),
    ("legacy-channel",
     lambda mod: dict(engine="legacy", channel_profile="static")),
    ("legacy-faults", lambda mod: dict(engine="legacy", fault_profile="none")),
    ("legacy-hier", lambda mod: dict(engine="legacy", sample_fraction=0.5)),
]
_ACCEPTED = [
    ("fused_embed-unfused",
     lambda mod: dict(fused_embed=True, fused_coded=False, **_rff(mod))),
    ("legacy-unfused", lambda mod: dict(engine="legacy", fused_coded=False)),
    ("checkpoint-batched", lambda mod: dict(checkpoint_every=3)),
]


@pytest.mark.parametrize("kw", [k for _, k in _REFUSED],
                         ids=[i for i, _ in _REFUSED])
def test_spec_refusals_match_reference(kw):
    for mod in (ref_config, t_config):
        with pytest.raises(ValueError):
            mod.ExperimentSpec(fl=mod.FLConfig(n_clients=4), **kw(mod))


@pytest.mark.parametrize("kw", [k for _, k in _ACCEPTED],
                         ids=[i for i, _ in _ACCEPTED])
def test_spec_acceptances_match_reference(kw):
    specs = [mod.ExperimentSpec(fl=mod.FLConfig(n_clients=4), **kw(mod))
             for mod in (ref_config, t_config)]
    assert specs[0].to_dict() == specs[1].to_dict()
