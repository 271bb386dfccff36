"""The port's coded linear-probe head (``repro_torch.core.coded_probe``)
against ``repro.core.coded_probe``, on the CPU.

The backbone's weights come from the reference's ``init_params``
(``repro_torch.carry.model_params_from_reference``); the tokens are NumPy
draws from a seed.  Held to:

  * ``extract_features`` (float32 backbone): within 1e-5 of the largest
    feature (float32 sums through 2 layers and the pool, in another
    order);
  * the FL half with the reference's (Omega, delta) and parity generators
    carried over: t* and every round's simulated wall clock and returned
    count equal, theta within 1e-4 of its largest entry (features 1e-6
    apart move the RFF map, the power-iteration lr and 60 rounds of
    updates by a few float32 ulps);
  * the reference test's own run (bf16 backbone, 4 clients of 24 rows):
    the probe's training accuracy above 0.5.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as RefFLConfig
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.core import coded_probe as ref_probe
from repro.core import encoding as ref_enc
from repro.models.model_zoo import build as ref_build

from repro_torch import carry
from repro_torch.config import FLConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import coded_probe, rff
from repro_torch.kernels import ops, ref

N, L, S, C = 4, 24, 16, 3
FL_KW = dict(n_clients=N, delta=0.25)
PROBE_KW = dict(rff_q=128, iterations=60)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _backbone(dtype):
    rcfg = dataclasses.replace(ref_smoke_variant(ref_get_config("qwen3-4b")),
                               dtype=dtype)
    cfg = dataclasses.replace(smoke_variant(get_config("qwen3-4b")),
                              dtype=dtype)
    params = ref_build(rcfg).init_params(jax.random.PRNGKey(0))
    params_np = jax.tree_util.tree_map(np.asarray, params)
    return rcfg, cfg, params, params_np


@pytest.fixture(scope="module")
def f32():
    return _backbone("float32")


def _client_data(extract, vocab, n=N, l=L, seq=S, n_classes=C, seed=0):
    """Labels linear in the backbone's features by construction (the
    reference test's `_client_data`), `extract` the package's own."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(n, l, seq)).astype(np.int32)
    feats = np.stack([extract(tokens[j]) for j in range(n)])
    w = rng.normal(size=(feats.shape[-1], n_classes))
    labels = np.argmax(np.einsum("nld,dc->nlc", feats, w), axis=-1)
    return tokens, labels.astype(np.int64)


def _reference_generators(n, u, l, seed=0):
    """The split chain of ``CodedScheme.setup`` from PRNGKey(seed + 99)."""
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(seed + 99), None,
                           length=n)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, l))(keys))


@pytest.mark.parametrize("batch_size", [2, 8])
def test_extract_features_match(f32, batch_size):
    rcfg, cfg, params, params_np = f32
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (11, S)).astype(
        np.int32)
    want = ref_probe.extract_features(rcfg, params, toks, batch_size)
    got = coded_probe.extract_features(
        cfg, carry.model_params_from_reference(params_np, cfg, "cpu"), toks,
        batch_size, device="cpu")
    assert got.dtype == np.float32 and got.shape == (11, cfg.d_model)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_probe_with_carried_draws_matches_reference(f32):
    rcfg, cfg, params, params_np = f32
    tp = carry.model_params_from_reference(params_np, cfg, "cpu")
    tokens, labels = _client_data(
        lambda t: ref_probe.extract_features(rcfg, params, t), cfg.vocab)
    want, (omega, delta) = ref_probe.coded_probe_training(
        rcfg, params, tokens, labels, n_classes=C,
        fl_cfg=RefFLConfig(**FL_KW), **PROBE_KW)
    u = max(1, int(round(FL_KW["delta"] * N * L)))
    gens = carry.generators_from_reference(_reference_generators(N, u, L),
                                           device="cpu")
    got, (g_omega, g_delta) = coded_probe.coded_probe_training(
        cfg, tp, tokens, labels, n_classes=C, fl_cfg=FLConfig(**FL_KW),
        device="cpu", rff_draw=carry.rff_from_reference(omega, delta, "cpu"),
        parity_generators=gens, **PROBE_KW)
    np.testing.assert_array_equal(g_omega.numpy(), np.asarray(omega))
    np.testing.assert_array_equal(g_delta.numpy(), np.asarray(delta))
    assert got.t_star == want.t_star
    assert [h.wall_clock for h in got.history] == \
        [h.wall_clock for h in want.history]
    assert [h.returned for h in got.history] == \
        [h.returned for h in want.history]
    theta, want_theta = got.theta.numpy(), np.asarray(want.theta)
    np.testing.assert_allclose(theta, want_theta, rtol=0,
                               atol=1e-4 * np.abs(want_theta).max())


def test_coded_probe_learns_as_the_reference_test():
    """tests/test_coded_probe.py::test_coded_probe_learns on the port: the
    bf16 smoke backbone (the reference's weights), the port's own draws."""
    _, cfg, _, params_np = _backbone("bfloat16")
    tp = carry.model_params_from_reference(params_np, cfg, "cpu")

    def extract(t):
        return coded_probe.extract_features(cfg, tp, t, device="cpu")
    tokens, labels = _client_data(extract, cfg.vocab)
    res, (omega, delta) = coded_probe.coded_probe_training(
        cfg, tp, tokens, labels, n_classes=C, fl_cfg=FLConfig(**FL_KW),
        device="cpu", **PROBE_KW)
    theta = res.theta.numpy()
    assert np.all(np.isfinite(theta))
    assert res.t_star is not None and res.t_star > 0
    feats = np.stack([extract(tokens[j]) for j in range(N)])
    xh = rff.rff_transform(torch.from_numpy(feats.reshape(-1, cfg.d_model)),
                           omega, delta)
    acc = float(((xh @ res.theta).argmax(1).numpy()
                 == labels.reshape(-1)).mean())
    assert acc > 0.5, acc


def test_probe_entry_points_run_on_the_card_by_default(f32):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg, _, params_np = f32
    tp = carry.model_params_from_reference(params_np, cfg, "cpu")
    toks = np.zeros((2, S), np.int32)
    with pytest.raises(RuntimeError, match="cuda"):
        coded_probe.extract_features(cfg, tp, toks)
    with pytest.raises(RuntimeError, match="cuda"):
        coded_probe.coded_probe_training(cfg, tp, toks[None], np.zeros(
            (1, 2), np.int64), n_classes=2)


@pytest.mark.cuda
def test_probe_on_the_card_matches_the_cpu(f32):
    """The card launches rff_embed once a client, parity_encode_batched
    twice (features, labels) and linreg_grad_masked once a round; theta
    within 1e-5 of the CPU run's on the same features and draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, cfg, _, params_np = f32
    tp = carry.model_params_from_reference(params_np, cfg, "cpu")
    tokens, labels = _client_data(
        lambda t: coded_probe.extract_features(cfg, tp, t, device="cpu"),
        cfg.vocab)
    feats = np.stack([coded_probe.extract_features(cfg, tp, tokens[j],
                                                   device="cpu")
                      for j in range(N)])
    ops.reset_launch_counts()
    gpu, draw = coded_probe.probe_head(feats, labels, C, FLConfig(**FL_KW),
                                       device="cuda", **PROBE_KW)
    launches = dict(ops.LAUNCHES)
    assert launches["rff_embed"] == N
    assert launches["parity_encode_batched"] == 2
    assert launches["linreg_grad_masked"] == PROBE_KW["iterations"]
    assert launches["linreg_grad"] == 0
    cpu, _ = coded_probe.probe_head(
        feats, labels, C, FLConfig(**FL_KW), device="cpu",
        rff_draw=tuple(t.cpu() for t in draw), **PROBE_KW)
    assert gpu.t_star == cpu.t_star
    want = cpu.theta.numpy()
    np.testing.assert_allclose(gpu.theta.cpu().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the embedding's plain version on the card's own inputs
    x = torch.from_numpy(feats[0]).cuda()
    torch.testing.assert_close(rff.rff_transform(x, *draw),
                               ref.rff_embed(x, *draw), rtol=0, atol=1e-5)
