"""Secure aggregation of the parity sets in the PyTorch port
(``repro_torch.core.secure_agg`` and the secure branch of
``CodedScheme.setup``) against the JAX reference, on the CPU.

The port draws each pair's mask with a ``torch.Generator`` seeded from
(fl.seed + 1234, lo, hi); the reference folds both ids into a
``jax.random`` key.  The draws differ, so where both packages must compute
the same thing the reference's masks are carried over
(``repro_torch.carry.secure_masks_from_reference``), with its parity
generators.  The CPU and CUDA generators draw different masks too, so a
secure parity set is not bit-identical across devices either.  Held to:

  * bit-identical: each client's masked upload with the reference's masks
    (the same float32 additions in the same order), and the masked
    uploads built pair by pair equal to `mask_parity`'s;
  * the masked global parity within `secure_agg.rounding_tolerance(n,
    scale, max|x_j|)` = 4 eps n^1.5 (scale + max|x_j|) of the unmasked
    sum: float32 does not cancel (x + M) - M exactly; the tolerance
    follows from n, the mask scale and float32's eps (its docstring), and
    the reference's own masked parity sits within it too;
  * a secure coded run: wall clock and returned counts bit-identical to
    the reference's, the global parity set within 1e-5 with its masks
    carried over (the encode sums in another order; the masking adds the
    same bits), within 1e-5 plus twice the rounding tolerance with the
    port's own masks, and theta within 1e-5 either way.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import config as ref_config
from repro.core import encoding as ref_enc
from repro.core import secure_agg as ref_sa

from repro_torch import api as t_api
from repro_torch import carry
from repro_torch import config as t_config
from repro_torch.core import encoding as t_enc
from repro_torch.core import secure_agg as t_sa

N, L, Q, C = 8, 24, 32, 3
SEED = 3
ROUNDS = 16


def _parities(n=4, u=8, q=16, c=3, seed=0):
    """Stacked (n, u, .) local parity sets as NumPy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, u, q)).astype(np.float32),
            rng.normal(size=(n, u, c)).astype(np.float32))


def _local(px, py):
    return [t_enc.LocalParity(x=torch.from_numpy(px[j]),
                              y=torch.from_numpy(py[j]))
            for j in range(px.shape[0])]


@functools.lru_cache(maxsize=None)
def _reference_masks(session_seed, n, u, q, c):
    """The reference's pair masks, one a pair in `secure_agg.pairs` order:
    ``_mask_like(_pair_key(PRNGKey(session_seed), i, j), parity, 1.0)``."""
    key = jax.random.PRNGKey(session_seed)
    like = ref_enc.LocalParity(x=jnp.zeros((u, q), jnp.float32),
                               y=jnp.zeros((u, c), jnp.float32))
    masks = [ref_sa._mask_like(ref_sa._pair_key(key, i, j), like, 1.0)
             for i, j in t_sa.pairs(n)]
    return (np.stack([np.asarray(m.x) for m in masks]),
            np.stack([np.asarray(m.y) for m in masks]))


@functools.lru_cache(maxsize=None)
def _reference_generators(u):
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(SEED + 99), None,
                           length=N)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, L))(keys))


def _data(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(N, L, Q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(N, L, C)).astype(np.float32)
    return xs, ys


def _spec(mod, scheme="coded", **over):
    base = dict(fl=mod.FLConfig(n_clients=N, delta=0.25, psi=0.3,
                                seed=SEED),
                train=mod.TrainConfig(learning_rate=0.5, l2_reg=1e-4,
                                      lr_decay_epochs=(9,)),
                scheme=scheme, secure_aggregation=True)
    base.update(over)
    return mod.ExperimentSpec(**base)


def _port(spec, u, masks=True, xs=None, ys=None):
    """The port's deployment with the reference's generators and, when
    `masks`, its pair masks."""
    if xs is None:
        xs, ys = _data()
    gens = carry.generators_from_reference(_reference_generators(u),
                                           device="cpu")
    secure = None
    if masks and spec.secure_aggregation:
        secure = carry.secure_masks_from_reference(
            *_reference_masks(SEED + 1234, N, u, Q, C), device="cpu")
    return t_api.build_experiment(spec, xs, ys, device="cpu",
                                  parity_generators=gens,
                                  secure_masks=secure)


# --------------------------------------------- the reference's three cases
def test_masks_cancel_exactly():
    px, py = _parities()
    parities = _local(px, py)
    masked = [t_sa.mask_parity(42, j, len(parities), p, scale=5.0)
              for j, p in enumerate(parities)]
    got = t_sa.secure_aggregate(masked)
    want = t_enc.aggregate_parity(parities)
    tol = t_sa.rounding_tolerance(4, 5.0, float(np.abs(px).max()))
    assert tol < 1e-4            # the reference test's own atol
    for g, w in ((got.x, want.x), (got.y, want.y)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=tol)


def test_individual_upload_is_masked():
    parities = _local(*_parities())
    masked = t_sa.mask_parity(43, 0, len(parities), parities[0], scale=10.0)
    diff = float((masked.x - parities[0].x).abs().mean())
    assert diff > 1.0


def test_masks_are_pairwise_consistent():
    like = _local(*_parities())[0]
    a = t_sa.draw_pair_mask(44, 0, 1, like)
    b = t_sa.draw_pair_mask(44, 0, 1, like)
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    other = t_sa.draw_pair_mask(44, 0, 2, like)
    assert not torch.equal(a.x, other.x)
    assert t_sa.pair_seed(44, 0, 1) != t_sa.pair_seed(45, 0, 1)
    for n in (2, 5, 9):
        for k, (lo, hi) in enumerate(t_sa.pairs(n)):
            assert t_sa.pair_index(lo, hi, n) == k


# -------------------------------------------------------- the port's own
@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_masked_uploads_equal_mask_parity(scale):
    """Each pair drawn once, in pairs order: the same bits as masking
    client after client."""
    px, py = _parities(n=5)
    stacked = t_enc.LocalParity(x=torch.from_numpy(px),
                                y=torch.from_numpy(py))
    got = t_sa.masked_uploads(7, stacked, scale)
    for j, p in enumerate(_local(px, py)):
        want = t_sa.mask_parity(7, j, 5, p, scale)
        assert torch.equal(got.x[j], want.x) and torch.equal(got.y[j], want.y)
    assert torch.equal(t_sa.secure_aggregate(got).x,
                       t_sa.secure_aggregate(
                           [t_enc.LocalParity(x=got.x[j], y=got.y[j])
                            for j in range(5)]).x)


def test_uploads_match_reference_with_carried_masks():
    """The reference's masks: every client's upload bit for bit, and the
    server's sum within float32 summation-order error."""
    n, u, q, c = 4, 8, 16, 3
    px, py = _parities(n, u, q, c)
    mx, my = _reference_masks(42, n, u, q, c)
    masks = carry.secure_masks_from_reference(mx, my, device="cpu")
    key = jax.random.PRNGKey(42)
    ref_masked = [ref_sa.mask_parity(
        key, j, n, ref_enc.LocalParity(x=jnp.asarray(px[j]),
                                       y=jnp.asarray(py[j])))
        for j in range(n)]
    stacked = t_enc.LocalParity(x=torch.from_numpy(px),
                                y=torch.from_numpy(py))
    got = t_sa.masked_uploads(0, stacked, pair_masks=masks)
    for j in range(n):
        np.testing.assert_array_equal(got.x[j].numpy(),
                                      np.asarray(ref_masked[j].x))
        np.testing.assert_array_equal(got.y[j].numpy(),
                                      np.asarray(ref_masked[j].y))
        one = t_sa.mask_parity(0, j, n, _local(px, py)[j], pair_masks=masks)
        assert torch.equal(one.x, got.x[j])
    want = ref_sa.secure_aggregate(ref_masked)
    agg = t_sa.secure_aggregate(got)
    np.testing.assert_allclose(agg.x.numpy(), np.asarray(want.x), rtol=1e-6,
                               atol=1e-6)


def test_carried_masks_are_checked():
    mx, my = _reference_masks(42, 4, 8, 16, 3)
    stacked = t_enc.LocalParity(*(torch.from_numpy(a)
                                  for a in _parities(n=5)))
    with pytest.raises(ValueError, match="one mask a pair"):
        t_sa.masked_uploads(0, stacked, pair_masks=(torch.from_numpy(mx),
                                                    torch.from_numpy(my)))
    with pytest.raises(ValueError, match="disagree"):
        carry.secure_masks_from_reference(mx, my[:2], device="cpu")
    xs, ys = _data()
    with pytest.raises(ValueError, match="secure_aggregation=False"):
        t_api.build_experiment(_spec(t_config, secure_aggregation=False),
                               xs, ys, device="cpu",
                               secure_masks=(mx, my))


def test_rounding_tolerance_separates_rounding_from_a_lost_mask():
    """At n = 30 the masked sum sits within the tolerance of the unmasked
    one; the same sum with one mask left out sits far outside it."""
    n, u, q, c = 30, 16, 32, 3
    px, py = _parities(n, u, q, c, seed=4)
    stacked = t_enc.LocalParity(x=torch.from_numpy(px),
                                y=torch.from_numpy(py))
    uploads = t_sa.masked_uploads(9, stacked)
    tol = t_sa.rounding_tolerance(n, 1.0, float(np.abs(px).max()))
    gap = float((t_sa.secure_aggregate(uploads).x
                 - stacked.x.sum(dim=0)).abs().max())
    assert 0.0 < gap <= tol
    lost = uploads.x[:-1].sum(dim=0) + stacked.x[-1]
    assert float((lost - stacked.x.sum(dim=0)).abs().max()) > 100 * tol


# ------------------------------------------------ the secure deployment
@pytest.mark.parametrize("scheme,fused,masks", [
    ("coded", True, True), ("coded", False, True),
    ("partial_coded", True, True), ("coded", True, False)])
def test_secure_run_matches_reference(scheme, fused, masks):
    over = dict(fused_coded=fused)
    if scheme == "partial_coded":
        over["scheme_params"] = {"u_fraction": 0.5}
    ref_exp = ref_api.build_experiment(_spec(ref_config, scheme, **over),
                                       *_data())
    t_exp = _port(_spec(t_config, scheme, **over), ref_exp.u, masks=masks)
    # with the reference's masks: the global parity set within the
    # encode's float32 summation-order error, 1e-5 (the masking adds the
    # same bits, test_uploads_match_reference_with_carried_masks); with
    # the port's own masks each package sits within the rounding
    # tolerance of its unmasked sum, so the two within twice it more
    tol = 1e-5
    if not masks:
        stacked = t_enc.encode_local_batched(
            carry.generators_from_reference(
                _reference_generators(ref_exp.u), device="cpu"),
            t_exp.x, t_exp.y, t_exp.w_stack)
        tol += 2 * t_sa.rounding_tolerance(
            N, 1.0, float(stacked.x.abs().max()))
    for got, want in ((t_exp.parity.x, ref_exp.parity.x),
                      (t_exp.parity.y, ref_exp.parity.y)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=tol)
    got, want = t_exp.run(ROUNDS), ref_exp.run(ROUNDS)
    assert [h.wall_clock for h in got.history] == \
        [h.wall_clock for h in want.history]
    assert [h.returned for h in got.history] == \
        [h.returned for h in want.history]
    assert got.t_star == want.t_star and got.privacy_eps == want.privacy_eps
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               atol=1e-5)


def test_secure_parity_within_tolerance_of_unmasked_both_packages():
    """The port's own masks and the reference's both leave the global
    parity within the rounding tolerance of the unmasked sum, and the
    secure run sees the plain run's rounds."""
    ref_exp = ref_api.build_experiment(_spec(ref_config), *_data())
    u = ref_exp.u
    plain = _port(_spec(t_config, secure_aggregation=False), u)
    own = _port(_spec(t_config), u, masks=False)
    carried = _port(_spec(t_config), u)
    stacked = t_enc.encode_local_batched(
        carry.generators_from_reference(_reference_generators(u),
                                        device="cpu"),
        plain.x, plain.y, plain.w_stack)
    tol = t_sa.rounding_tolerance(N, 1.0, float(stacked.x.abs().max()))
    for exp in (own, carried):
        gap = float((exp.parity.x - plain.parity.x).abs().max())
        assert 0.0 < gap <= tol
    ref_gap = float(np.abs(np.asarray(ref_exp.parity.x)
                           - plain.parity.x.numpy()).max())
    assert 0.0 < ref_gap <= tol
    a, b = own.run(ROUNDS), plain.run(ROUNDS)
    assert [h.wall_clock for h in a.history] == \
        [h.wall_clock for h in b.history]
    np.testing.assert_allclose(a.theta.numpy(), b.theta.numpy(), atol=1e-5)


def test_adaptive_coded_inherits_the_secure_setup():
    kw = dict(adapt_every=4, channel_profile="churn")
    ref_exp = ref_api.build_experiment(
        _spec(ref_config, "adaptive_coded", **kw), *_data())
    t_exp = _port(_spec(t_config, "adaptive_coded", **kw), ref_exp.u)
    np.testing.assert_allclose(t_exp.parity.x.numpy(),
                               np.asarray(ref_exp.parity.x), rtol=1e-5,
                               atol=1e-5)
    got, want = t_exp.run(ROUNDS), ref_exp.run(ROUNDS)
    assert [h.wall_clock for h in got.history] == \
        [h.wall_clock for h in want.history]
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(want.theta),
                               atol=1e-5)


@pytest.mark.cuda
def test_secure_parity_on_the_card_within_tolerance():
    """On the card the CUDA generator draws other masks than the CPU's:
    the secure parity sets differ across devices, each within the
    rounding tolerance of the unmasked sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    px, py = _parities(n=30, u=64, q=128, c=10, seed=6)
    out = {}
    for dev in ("cpu", "cuda"):
        stacked = t_enc.LocalParity(x=torch.from_numpy(px).to(dev),
                                    y=torch.from_numpy(py).to(dev))
        out[dev] = t_sa.secure_aggregate(t_sa.masked_uploads(5, stacked)).x
    tol = t_sa.rounding_tolerance(30, 1.0, float(np.abs(px).max()))
    plain = torch.from_numpy(px).sum(dim=0)
    for got in out.values():
        assert float((got.cpu() - plain).abs().max()) <= tol
    assert not torch.equal(out["cuda"].cpu(), out["cpu"])


@pytest.mark.cuda
def test_full_width_masked_parity_gap_both_packages():
    """MNIST-RFF full width (n = 30 clients, u = 2400 parity rows, q =
    2000, c = 10), local parity sets of the deployment's scale (N(0,
    0.5^2)): the reference's masked sum (its own masks, on JAX's default
    device) and the port's (its own masks, on the card) each sit within
    the rounding tolerance of their unmasked sums.  Prints both gaps as
    one JSON line (run with -s)."""
    import json
    import time

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n, u, q, c = 30, 2400, 2000, 10
    rng = np.random.default_rng(19)
    px = (rng.normal(size=(n, u, q)) * 0.5).astype(np.float32)
    py = (rng.normal(size=(n, u, c)) * 0.5).astype(np.float32)
    t0 = time.perf_counter()
    key = jax.random.PRNGKey(SEED + 1234)
    ref = ref_sa.secure_aggregate([ref_sa.mask_parity(
        key, j, n, ref_enc.LocalParity(x=jnp.asarray(px[j]),
                                       y=jnp.asarray(py[j])))
        for j in range(n)])
    ref_gap = float(jnp.abs(ref.x - jnp.sum(jnp.asarray(px), axis=0)).max())
    ref_s = time.perf_counter() - t0
    stacked = t_enc.LocalParity(x=torch.from_numpy(px).cuda(),
                                y=torch.from_numpy(py).cuda())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    port = t_sa.secure_aggregate(t_sa.masked_uploads(SEED + 1234, stacked))
    torch.cuda.synchronize()
    port_s = time.perf_counter() - t0
    port_gap = float((port.x - stacked.x.sum(dim=0)).abs().max())
    tol = t_sa.rounding_tolerance(n, 1.0, float(np.abs(px).max()))
    print("SECURE_GAP " + json.dumps({
        "shape": [n, u, q, c], "reference_gap": ref_gap,
        "reference_device": str(jax.devices()[0]), "reference_s": ref_s,
        "port_gap": port_gap, "port_s": port_s, "tol": tol,
        "card": torch.cuda.get_device_name(0)}))
    assert 0.0 < ref_gap <= tol
    assert 0.0 < port_gap <= tol
