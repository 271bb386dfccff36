"""The port's serving path (model zoo, dense family) against the JAX
reference, on the CPU (the other families: test_torch_families.py and
test_torch_recurrent.py).

Configs, the packed-LM pipeline and the prompt batch must be the same
values (configs under ``dataclasses.asdict``, tokens bit for bit).  Model
weights come from the reference's ``init_params`` and are carried over
with ``repro_torch.carry.model_params_from_reference``; activations are
made with NumPy from a seed.  On the CPU the port's decode attention runs
the plain version of ``gqa_decode``.  Tolerances, all float32:

  * building blocks (rms_norm, apply_rope, swiglu): atol 1e-6, one or two
    roundings apart;
  * one attention layer (prefill and decode, outputs and cache): atol 1e-5,
    sums of <= 64 terms in another order;
  * whole-model logits (prefill, teacher-forced decode_step): atol 1e-4,
    the same differences through 2 layers, the final norm and a 256-term
    head;
  * greedy tokens: identical.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as ref_config
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import decode_window as ref_decode_window
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.data import pipeline as ref_pipeline
from repro.launch import serve as ref_serve
from repro.launch.train import make_batch as ref_make_batch
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models.model_zoo import build as ref_build

from repro_torch import carry
from repro_torch import config as t_config
from repro_torch.configs import ARCH_IDS, decode_window, get_config, \
    smoke_variant
from repro_torch.configs import mnist_rff as t_mnist_rff
from repro_torch.data import pipeline
from repro_torch.launch.serve import serve
from repro_torch.launch.train import make_batch
from repro_torch.models import attention, common, transformer
from repro_torch.models.model_zoo import build

DENSE = ("qwen3-4b", "yi-6b")


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------ configs
def test_arch_ids_match():
    assert ARCH_IDS == REF_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in t_config.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_config.SHAPES.items()}
    from repro.configs import mnist_rff as ref_mnist_rff
    assert dataclasses.asdict(t_mnist_rff.RFF) \
        == dataclasses.asdict(ref_mnist_rff.RFF)
    assert (t_mnist_rff.D_RAW, t_mnist_rff.N_CLASSES,
            t_mnist_rff.GLOBAL_MINIBATCH, t_mnist_rff.N_CLIENTS) \
        == (ref_mnist_rff.D_RAW, ref_mnist_rff.N_CLASSES,
            ref_mnist_rff.GLOBAL_MINIBATCH, ref_mnist_rff.N_CLIENTS)


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_config_and_smoke_variant_match(arch):
    for port, ref in ((get_config(arch), ref_get_config(arch)),
                      (smoke_variant(get_config(arch)),
                       ref_smoke_variant(ref_get_config(arch)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for prop in ("vocab_padded", "attention_free", "is_encdec",
                     "subquadratic"):
            assert getattr(port, prop) == getattr(ref, prop)
        for shape in ref_config.SHAPES:
            assert decode_window(port, shape) == ref_decode_window(ref, shape)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("vocab,seq,batch,seed,shards,shard", [
    (512, 64, 3, 0, 1, 0), (151936, 33, 2, 7, 3, 2), (100, 300, 1, 5, 1, 0)])
def test_packed_lm_batch_at_is_bit_identical(vocab, seq, batch, seed, shards,
                                             shard):
    kw = dict(vocab=vocab, seq_len=seq, batch=batch, seed=seed,
              n_shards=shards, shard_id=shard)
    port = pipeline.PackedLMDataset(pipeline.PipelineConfig(**kw))
    ref = ref_pipeline.PackedLMDataset(ref_pipeline.PipelineConfig(**kw))
    for step in (0, 3):
        got, want = port.batch_at(step), ref.batch_at(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("arch", ["qwen3-4b", "yi-6b", "internvl2-1b"])
@pytest.mark.parametrize("seed", [0, 4])
def test_make_batch_is_bit_identical(arch, seed):
    cfg = smoke_variant(get_config(arch))
    got = make_batch(cfg, 3, 40, seed)
    want = ref_make_batch(ref_smoke_variant(ref_get_config(arch)), 3, 40,
                          seed)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# ------------------------------------------------------------------ blocks
def test_building_blocks_match():
    x = _np((2, 5, 3, 64), 0)
    w = _np((64,), 1) + 1.0
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(ref_common.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6, rtol=0)
    pos = np.array([[0, 1, 7, 4095, 4159]], np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta).numpy(),
            np.asarray(ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                             theta)),
            atol=1e-6, rtol=0)
    h, w1, w3, w2 = (_np((4, 32), 2), _np((32, 48), 3, 0.2),
                     _np((32, 48), 4, 0.2), _np((48, 32), 5, 0.2))
    np.testing.assert_allclose(
        common.swiglu(*map(torch.from_numpy, (h, w1, w3, w2))).numpy(),
        np.asarray(ref_common.swiglu(*map(jnp.asarray, (h, w1, w3, w2)))),
        atol=1e-6, rtol=0)


# ------------------------------------------------------------------ attention
@pytest.mark.parametrize("window", [0, 24])
def test_attention_layer_prefill_and_decode_match(window):
    """One layer: prefill into a cache with room to decode, then 6 decode
    steps (the rolling cache wraps at window 24), against the reference."""
    cfg = dataclasses.replace(smoke_variant(get_config("qwen3-4b")),
                              d_model=64, n_heads=8, n_kv_heads=2,
                              head_dim=16)
    ref_cfg = dataclasses.replace(ref_smoke_variant(
        ref_get_config("qwen3-4b")), d_model=64, n_heads=8, n_kv_heads=2,
        head_dim=16)
    p_ref = ref_attention.init_attn(jax.random.PRNGKey(0), ref_cfg,
                                    jnp.float32)
    p_ref["qn"] = jnp.asarray(_np((16,), 9, 0.1) + 1.0)
    p = {k: torch.from_numpy(np.array(a)) for k, a in p_ref.items()}
    B, S, steps = 2, 40, 6
    x = _np((B, S, 64), 1)
    xs = _np((steps, B, 1, 64), 2)
    max_seq = S + steps if window == 0 else S
    cache_ref = ref_attention.init_cache(ref_cfg, B, max_seq, jnp.float32,
                                         window)
    cache = attention.init_cache(cfg, B, max_seq, torch.float32, window)
    pos = np.arange(S, dtype=np.int32)
    want, cache_ref = ref_attention.attn_prefill(
        p_ref, jnp.asarray(x), jnp.asarray(pos), ref_cfg, cache_ref, window)
    got, cache = attention.attn_prefill(p, torch.from_numpy(x),
                                        torch.from_numpy(pos), cfg, cache,
                                        window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    for i in range(steps):
        want, cache_ref = ref_attention.attn_decode(
            p_ref, jnp.asarray(xs[i]), jnp.int32(S + i), ref_cfg, cache_ref,
            window)
        got, cache = attention.attn_decode(p, torch.from_numpy(xs[i]), S + i,
                                           cfg, cache, window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(cache_ref["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(cache_ref[key]), atol=1e-5,
                                       rtol=0)


def test_prefill_skips_no_live_chunk():
    """The port's prefill walks 512-slot chunks in query tiles and skips
    dead (tile, chunk) pairs; at S = 1100 (three ragged chunks) and a
    window it still equals the reference's _flash."""
    B, S, H, K, hd = 1, 1100, 4, 2, 8
    q, k, v = _np((B, S, H, hd), 0), _np((B, S, K, hd), 1), _np((B, S, K, hd), 2)
    pos = np.arange(S, dtype=np.int32)
    for window in (0, 300):
        want = ref_attention._flash(*map(jnp.asarray, (q, k, v, pos, pos)),
                                    window)
        got = attention._flash(*map(torch.from_numpy, (q, k, v, pos, pos)),
                               window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


# ------------------------------------------------------------------ model
def _grow_ref_cache(cache, extra):
    """The reference serve's growth of a prefill cache by `extra` slots."""
    def grow(a):
        if a.dtype == jnp.int32:
            return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, extra)],
                           constant_values=-1)
        return jnp.pad(a, [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)])
    return jax.tree_util.tree_map(grow, cache)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_logits_match(arch):
    cfg = smoke_variant(get_config(arch))
    ref_model = ref_build(ref_smoke_variant(ref_get_config(arch)))
    params_ref = ref_model.init_params(jax.random.PRNGKey(1))
    params = carry.model_params_from_reference(_tree_np(params_ref), cfg,
                                               device="cpu")
    model = build(cfg)
    B, S, steps = 2, 24, 5
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (B, S + steps),
                                             dtype=np.int32)
    want, cache_ref = ref_model.prefill(params_ref,
                                        {"tokens": jnp.asarray(toks[:, :S])})
    got, cache = model.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :S])}, cache_len=S + steps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    cache_ref = _grow_ref_cache(cache_ref, steps)
    for i in range(steps):
        tok = toks[:, S + i:S + i + 1]
        want, cache_ref = ref_model.decode_step(
            params_ref, cache_ref, jnp.asarray(tok), jnp.int32(S + i))
        got, cache = model.decode_step(params, cache, torch.from_numpy(tok),
                                       S + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
    # the decode path agrees with a longer prefill (independent of decode)
    full, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("prompt_len,gen_len,window", [
    (40, 8, 0),        # full cache, grown to prompt + gen
    (40, 8, 16),       # rolling cache, slots = window < prompt
    (24, 8, 64),       # prompt < window: slots = prompt (reference quirk)
])
def test_serve_tokens_match_reference(prompt_len, gen_len, window):
    cfg = smoke_variant(get_config("qwen3-4b"))
    ref_cfg = ref_smoke_variant(ref_get_config("qwen3-4b"))
    seed = 2
    params_ref = ref_build(ref_cfg).init_params(jax.random.PRNGKey(seed))
    params = carry.model_params_from_reference(_tree_np(params_ref), cfg,
                                               device="cpu")
    want = np.asarray(ref_serve.serve(ref_cfg, batch=3,
                                      prompt_len=prompt_len, gen_len=gen_len,
                                      window=window, seed=seed,
                                      verbose=False))
    res = serve(cfg, batch=3, prompt_len=prompt_len, gen_len=gen_len,
                window=window, seed=seed, device="cpu", params=params,
                verbose=False)
    assert res.tokens.shape == (3, gen_len)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert res.device == "cpu" and np.isfinite(res.logits.numpy()).all()
    if window > prompt_len:
        # the cache keeps prompt_len slots, so the effective window is
        # prompt_len: serving with that window gives the same tokens
        same = serve(cfg, batch=3, prompt_len=prompt_len, gen_len=gen_len,
                     window=prompt_len, seed=seed, device="cpu",
                     params=params, verbose=False)
        np.testing.assert_array_equal(same.tokens.numpy(), want)


@pytest.mark.parametrize("S", [40, 48])
def test_rolling_cache_after_ragged_prefill(S):
    """A reference quirk both packages keep: prefill leaves position
    S - slots + i in slot i, but decode writes position p into slot
    p % slots.  With S % window != 0 the first decode step overwrites a
    slot that is still inside the window (position 32 at S = 40, window
    16) and keeps one outside it (24), so the step's logits differ from
    a prefill over the same tokens; with S % window == 0 they agree."""
    W = 16
    cfg = smoke_variant(get_config("qwen3-4b"))
    ref_model = ref_build(ref_smoke_variant(ref_get_config("qwen3-4b")))
    params_ref = ref_model.init_params(jax.random.PRNGKey(4))
    params = carry.model_params_from_reference(_tree_np(params_ref), cfg,
                                               device="cpu")
    model = build(cfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (1, S + 1),
                                             dtype=np.int32)
    _, cache_ref = ref_model.prefill(params_ref, {"tokens": jnp.asarray(
        toks[:, :S])}, window=W)
    want, cache_ref = ref_model.decode_step(
        params_ref, cache_ref, jnp.asarray(toks[:, S:]), jnp.int32(S),
        window=W)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(
        toks[:, :S])}, window=W)
    got, cache = model.decode_step(params, cache, torch.from_numpy(
        toks[:, S:]), S, window=W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    pos_ref = np.asarray(cache_ref["stage0"]["l0"]["attn"]["pos"])
    for i, c in enumerate(cache):
        np.testing.assert_array_equal(c["pos"].numpy(), pos_ref[i])
    full, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                            window=W)
    live = sorted(cache[0]["pos"].tolist())
    if S % W:
        assert live == [q for q in range(S - W, S + 1) if q != 32]
        assert np.abs(got.numpy() - full.numpy()).max() > 1e-3
    else:
        assert live == list(range(S - W + 1, S + 1))
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-4,
                                   rtol=0)


def test_carried_params_keep_reference_layouts():
    cfg = smoke_variant(get_config("qwen3-4b"))
    params_ref = _tree_np(ref_build(ref_smoke_variant(
        ref_get_config("qwen3-4b"))).init_params(jax.random.PRNGKey(0)))
    params = carry.model_params_from_reference(params_ref, cfg, device="cpu")
    np.testing.assert_array_equal(params.embed.numpy(), params_ref["embed"])
    np.testing.assert_array_equal(params.lm_head.numpy(),
                                  params_ref["lm_head"])
    stage = params_ref["stage0"]["l0"]
    for i, layer in enumerate(params.layers):
        for name in ("wq", "wk", "wv", "wo", "qn", "kn"):
            np.testing.assert_array_equal(layer.attn[name].numpy(),
                                          stage["attn"][name][i])
        for name in ("w1", "w3", "w2"):
            np.testing.assert_array_equal(layer.ffn[name].numpy(),
                                          stage["ffn"][name][i])
    # the port's own init draws the same shapes and dtypes
    own = transformer.init_params(cfg, seed=0, device="cpu")
    assert [(n, tuple(t.shape), t.dtype) for n, t in own.named_parameters()] \
        == [(n, tuple(t.shape), t.dtype) for n, t in params.named_parameters()]


def test_carried_bfloat16_params_keep_their_bits():
    """The full-width dtype: bf16 arrays (ml_dtypes) carry over bit for
    bit."""
    ref_cfg = dataclasses.replace(ref_smoke_variant(
        ref_get_config("yi-6b")), dtype="bfloat16")
    cfg = dataclasses.replace(smoke_variant(get_config("yi-6b")),
                              dtype="bfloat16")
    params_ref = _tree_np(ref_build(ref_cfg).init_params(
        jax.random.PRNGKey(0)))
    params = carry.model_params_from_reference(params_ref, cfg, device="cpu")
    assert params.embed.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params.layers[1].attn["wo"].float().numpy(),
        params_ref["stage0"]["l0"]["attn"]["wo"][1].astype(np.float32))


def test_serve_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: serve() runs on it")
    cfg = smoke_variant(get_config("qwen3-4b"))
    with pytest.raises(RuntimeError, match="cuda"):
        serve(cfg, batch=1, prompt_len=8, gen_len=2, verbose=False)


def test_serve_cli_on_the_cpu(capsys):
    from repro_torch.launch import serve as t_serve
    t_serve.main(["--arch", "yi-6b", "--smoke", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "16", "--gen-len", "3"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["smoke"]
    assert np.array(out["tokens"]).shape == (2, 3)
