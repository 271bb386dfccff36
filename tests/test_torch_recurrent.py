"""The port's serving path for the recurrent and encoder-decoder families
(rwkv6-1.6b, jamba-1.5-large-398b, whisper-base) against the JAX
reference, on the CPU.

Weights come from the reference's ``init_params`` and are carried over
with ``repro_torch.carry.model_params_from_reference``; activations are
made with NumPy from a seed.  Tolerances, all float32:

  * the RWKV-6 and Mamba functions (``wkv_naive``, ``wkv_chunked``, the
    token and channel mixes, ``_conv_causal``, ``_ssm_scan``,
    ``_ssm_chunked``, ``mamba_block``) and their states: within 1e-5 of
    the largest magnitude (float32 products and cumulative sums in
    another order); the chunked forms against the sequential ones: 1e-4
    (the two forms round differently, in the reference too);
  * the whisper encoder and a decoder layer (prefill, decode, cache):
    atol 1e-5;
  * whole-model logits (prefill, 5 teacher-forced decode steps): atol
    1e-4, as ``test_torch_serve.test_prefill_and_decode_logits_match``;
  * served tokens: identical to ``repro.launch.serve.serve``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as ref_encdec
from repro.models import ssm_mamba as ref_mamba
from repro.models import ssm_rwkv as ref_rwkv

from repro_torch.models import encdec, ssm_mamba, ssm_rwkv
from torch_zoo import Family, cfgs, normal, tensors

TOL = 1e-5
FORM_TOL = 1e-4
FAMILIES = ("rwkv6-1.6b", "jamba-1.5-large-398b", "whisper-base")


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               rtol=0)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return Family(request.param)


# ------------------------------------------------------------------ RWKV
def _rwkv_inputs(B=2, S=128, H=4, hs=16, seed=0):
    r, k, v = (normal((B, S, H, hs), seed + i, 0.5) for i in range(3))
    w = np.exp(-np.exp(normal((B, S, H, hs), seed + 3, 0.5) - 2.0))
    u = normal((H, hs), seed + 4, 0.3)
    state = normal((B, H, hs, hs), seed + 5, 0.1)
    return r, k, v, w.astype(np.float32), u, state


@pytest.mark.parametrize("S", [1, 7, 128])
def test_wkv_naive_matches(S):
    args = _rwkv_inputs(S=S)
    want_o, want_s = ref_rwkv.wkv_naive(*map(jnp.asarray, args))
    got_o, got_s = ssm_rwkv.wkv_naive(*map(torch.from_numpy, args))
    _close(got_o, want_o)
    _close(got_s, want_s)


def test_wkv_chunked_matches_and_agrees_with_naive():
    args = _rwkv_inputs(S=128)
    want_o, want_s = ref_rwkv.wkv_chunked(*map(jnp.asarray, args))
    got_o, got_s = ssm_rwkv.wkv_chunked(*map(torch.from_numpy, args))
    _close(got_o, want_o)
    _close(got_s, want_s)
    naive_o, naive_s = ssm_rwkv.wkv_naive(*map(torch.from_numpy, args))
    _close(got_o, naive_o.numpy(), FORM_TOL)
    _close(got_s, naive_s.numpy(), FORM_TOL)


@pytest.mark.parametrize("S,chunked", [(64, True), (64, False), (24, True),
                                       (1, True)])
def test_rwkv_mix_and_ffn_match(S, chunked):
    """The token mix (the form chosen by the reference's rule: chunked at
    S % 64 == 0 and S > 1) and the channel mix, from a nonzero state."""
    rcfg, cfg = cfgs("rwkv6-1.6b")
    p_ref = ref_rwkv.init_rwkv_mix(jax.random.PRNGKey(0), rcfg, jnp.float32)
    f_ref = ref_rwkv.init_rwkv_ffn(jax.random.PRNGKey(1), rcfg, jnp.float32)
    D, H = cfg.d_model, cfg.d_model // cfg.rwkv.head_size
    x = normal((2, S, D), 2)
    x_prev = normal((2, D), 3)
    wkv = normal((2, H, 64, 64), 4, 0.1)
    out, (x_last, s) = ref_rwkv.rwkv_mix_train(
        p_ref, jnp.asarray(x), jnp.asarray(x_prev), jnp.asarray(wkv), rcfg,
        chunked=chunked)
    state = {"x_prev_mix": torch.from_numpy(x_prev),
             "wkv": torch.from_numpy(wkv)}
    got = ssm_rwkv.rwkv_mix(tensors(p_ref), torch.from_numpy(x), state, cfg,
                            chunked=chunked)
    _close(got, out)
    _close(state["wkv"], s)
    _close(state["x_prev_mix"], x_last, 0)
    want_f, want_last = ref_rwkv.rwkv_ffn(f_ref, jnp.asarray(x),
                                          jnp.asarray(x_prev), rcfg)
    got_f, got_last = ssm_rwkv.rwkv_ffn(tensors(f_ref), torch.from_numpy(x),
                                        torch.from_numpy(x_prev), cfg)
    _close(got_f, want_f)
    _close(got_last, want_last, 0)


def test_rwkv_prefill_chunked_agrees_with_naive():
    """Prefill at S = 64 takes the chunked form, at chunked=False the
    sequential one: the logits and states agree within FORM_TOL."""
    fam = Family("rwkv6-1.6b")
    _, b, _ = fam.prompt(2, 64, 7)
    got, cache = fam.model.prefill(fam.params, b)
    want, cache_n = fam.model.prefill(fam.params, b, chunked=False)
    _close(got, want.numpy(), FORM_TOL)
    for c, cn in zip(cache, cache_n):
        _close(c["wkv"], cn["wkv"].numpy(), FORM_TOL)


# ------------------------------------------------------------------ Mamba
def _ssm_inputs(B=2, S=128, din=24, N=16, seed=0):
    u = normal((B, S, din), seed)
    dt = np.log1p(np.exp(normal((B, S, din), seed + 1) - 4.0)).astype(
        np.float32)
    b_t, c_t = normal((B, S, N), seed + 2), normal((B, S, N), seed + 3)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (din, 1))
    D = normal((din,), seed + 4)
    h0 = normal((B, din, N), seed + 5, 0.1)
    return u, dt, b_t, c_t, A, D, h0


@pytest.mark.parametrize("S", [1, 5])
def test_conv_causal_matches(S):
    x = normal((2, S, 24), 0)
    w, b = normal((4, 24), 1, 0.5), normal((24,), 2)
    st = normal((2, 3, 24), 3)
    want_y, want_st = ref_mamba._conv_causal(*map(jnp.asarray,
                                                  (x, w, b, st)))
    got_y, got_st = ssm_mamba._conv_causal(*map(torch.from_numpy,
                                                (x, w, b, st)))
    _close(got_y, want_y)
    _close(got_st, want_st, 0)


def test_ssm_scan_and_chunked_match():
    args = _ssm_inputs(S=256)
    want = ref_mamba._ssm_scan(*map(jnp.asarray, args))
    got = ssm_mamba._ssm_scan(*map(torch.from_numpy, args))
    want_c = ref_mamba._ssm_chunked(*map(jnp.asarray, args))
    got_c = ssm_mamba._ssm_chunked(*map(torch.from_numpy, args))
    for g, w in zip(got + got_c, want + want_c):
        _close(g, w)
    for g, w in zip(got_c, got):
        _close(g, w.numpy(), FORM_TOL)


def test_ssm_chunked_overflows_as_the_reference():
    """A reference fault the port keeps (ROADMAP F4): `_ssm_chunked`
    scales a chunk's inputs by exp(-cum), cum the cumulative log decay
    dt * A over the chunk; where it passes about -88 (here dt = 0.06,
    A = -16: -123 by the chunk's end) that overflows float32 and the
    output is not finite, in both packages, where the sequential scan
    stays finite.  jamba's full-width prefill at 1024 positions meets it
    on the card (chip_smoke.py's families line)."""
    B, S, din, N = 1, 128, 4, 16
    u = np.ones((B, S, din), np.float32)
    dt = np.full((B, S, din), 0.06, np.float32)
    b_t = c_t = np.ones((B, S, N), np.float32)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (din, 1))
    D, h0 = np.ones(din, np.float32), np.zeros((B, din, N), np.float32)
    args = (u, dt, b_t, c_t, A, D, h0)
    assert not bool(jnp.isfinite(
        ref_mamba._ssm_chunked(*map(jnp.asarray, args))[0]).all())
    assert not bool(torch.isfinite(
        ssm_mamba._ssm_chunked(*map(torch.from_numpy, args))[0]).all())
    assert bool(jnp.isfinite(
        ref_mamba._ssm_scan(*map(jnp.asarray, args))[0]).all())
    y, _ = ssm_mamba._ssm_scan(*map(torch.from_numpy, args))
    assert bool(torch.isfinite(y).all())


@pytest.mark.parametrize("S,chunked", [(128, True), (24, True), (1, False)])
def test_mamba_block_matches(S, chunked):
    rcfg, cfg = cfgs("jamba-1.5-large-398b")
    p_ref = ref_mamba.init_mamba(jax.random.PRNGKey(0), rcfg, jnp.float32)
    din = cfg.ssm.expand * cfg.d_model
    x = normal((2, S, cfg.d_model), 1)
    st = {"conv": normal((2, 3, din), 2), "h": normal((2, din, 16), 3, 0.1)}
    want, want_st = ref_mamba.mamba_block(
        p_ref, jnp.asarray(x), {k: jnp.asarray(a) for k, a in st.items()},
        rcfg, chunked=chunked)
    state = {k: torch.from_numpy(a) for k, a in st.items()}
    got = ssm_mamba.mamba_block(tensors(p_ref), torch.from_numpy(x), state, cfg,
                                chunked=chunked)
    _close(got, want)
    _close(state["h"], want_st["h"])
    _close(state["conv"], want_st["conv"])


# ------------------------------------------------------------------ whisper
def test_encode_matches():
    fam = Family("whisper-base")
    frames = normal((2, fam.cfg.encoder_seq, fam.cfg.d_model), 1)
    want = ref_encdec.encode(fam.rcfg, fam.params_ref, jnp.asarray(frames))
    got = encdec.encode(fam.cfg, fam.params, torch.from_numpy(frames))
    _close(got, want)


@pytest.mark.parametrize("window", [0, 8])
def test_decoder_layer_matches(window):
    """One decoder layer: prefill (self-attention into a cache with room
    to decode, cross K/V from the encoder output), then 4 decode steps."""
    fam = Family("whisper-base")
    cfg, rcfg = fam.cfg, fam.rcfg
    p_ref = jax.tree_util.tree_map(lambda a: a[0], fam.params_ref["dec"])
    layer = fam.params.dec[0]
    B, S, steps = 2, 12, 4
    x, enc = normal((B, S, cfg.d_model), 2), normal((B, 16, cfg.d_model), 3)
    xs = normal((steps, B, 1, cfg.d_model), 4)
    max_seq = S + steps if window == 0 else S
    one = lambda a: a[0]                                   # noqa: E731
    cache_ref = jax.tree_util.tree_map(
        one, ref_encdec.init_cache(rcfg, B, max_seq, window))
    cache = encdec.init_cache(cfg, B, max_seq, window)[0]
    pos = np.arange(S, dtype=np.int32)
    want, cache_ref = ref_encdec._dec_layer(
        rcfg, p_ref, jnp.asarray(x), jnp.asarray(enc), jnp.asarray(pos),
        "prefill", cache=cache_ref, window=window)
    got = encdec.dec_layer(cfg, layer, torch.from_numpy(x),
                           torch.from_numpy(enc), cache,
                           positions=torch.from_numpy(pos), window=window)
    _close(got, want)
    for i in range(steps):
        want, cache_ref = ref_encdec._dec_layer(
            rcfg, p_ref, jnp.asarray(xs[i]), None, jnp.int32(S + i),
            "decode", cache=cache_ref, window=window)
        got = encdec.dec_layer(cfg, layer, torch.from_numpy(xs[i]), None,
                               cache, pos=S + i, window=window)
        _close(got, want)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(cache_ref["pos"]))
        for key in ("k", "v", "xk", "xv"):
            _close(cache[key], cache_ref[key])


def test_pos_embed_at_matches():
    rcfg, cfg = cfgs("whisper-base")
    for pos in (0, 1, 17, 447):
        _close(encdec.pos_embed_at(cfg, pos),
               ref_encdec._pos_embed_at(rcfg, jnp.int32(pos)), 1e-6)


# ------------------------------------------------------------------ models
def test_prefill_and_decode_logits_match(family):
    family.check_prefill_and_decode()


@pytest.mark.parametrize("arch,S", [("rwkv6-1.6b", 64),
                                    ("jamba-1.5-large-398b", 128)])
def test_chunked_prefill_then_decode_matches(arch, S):
    """Prompts where prefill takes the chunked forms (RWKV at S % 64 == 0,
    Mamba at S % 128 == 0)."""
    Family(arch).check_prefill_and_decode(S=S)


def test_jamba_superblocks_unstack_in_order():
    """Two superblocks (n_layers 4): the carried layers run stage0/l0[0],
    l1[0], l0[1], l1[1], and the logits still match the reference's."""
    fam = Family("jamba-1.5-large-398b", n_layers=4)
    assert [layer.spec for layer in fam.params.layers] == [
        ("attn", "dense"), ("mamba", "moe")] * 2
    np.testing.assert_array_equal(
        fam.params.layers[3].mamba["A_log"].numpy(),
        np.asarray(fam.params_ref["stage0"]["l1"]["mamba"]["A_log"][1]))
    fam.check_prefill_and_decode(steps=3)


@pytest.mark.parametrize("prompt_len,gen_len", [(24, 6), (33, 4)])
def test_serve_tokens_match_reference(family, prompt_len, gen_len):
    family.check_serve(prompt_len, gen_len)


def test_recurrent_states_are_not_grown():
    """serve grows the attention caches to prompt + gen slots; the RWKV
    and Mamba states keep their shapes."""
    fam = Family("jamba-1.5-large-398b")
    _, b, _ = fam.prompt(2, 24, 1)
    _, cache = fam.model.prefill(fam.params, b, cache_len=30)
    assert cache[0]["k"].shape[1] == 30 and cache[0]["pos"].shape == (30,)
    din = fam.cfg.ssm.expand * fam.cfg.d_model
    assert cache[1]["conv"].shape == (2, 3, din)
    assert cache[1]["h"].shape == (2, din, 16)
    assert cache[1]["h"].dtype == torch.float32
