"""The port's serving path for the MoE, MLA and VLM-prefix families
(mixtral-8x7b, deepseek-v2-lite-16b, internvl2-1b) against the JAX
reference, on the CPU, and the weight carry of every architecture.

Weights come from the reference's ``init_params`` and are carried over
with ``repro_torch.carry.model_params_from_reference``; activations are
made with NumPy from a seed.  On the CPU the port's decode attention runs
the plain version of ``gqa_decode``.  Tolerances, all float32:

  * ``moe_ffn`` (no drops, drops, shared experts): the output within 1e-5
    of its largest magnitude (~20: the reference's expert weights take
    their fan-in from the expert axis, 1/sqrt(E)), the aux value atol
    1e-6; the routing (top-k indices, kept pairs) equal;
  * MLA prefill and decode (outputs and latent cache), the VLM prefix
    embeddings: atol 1e-5 (sums of <= 256 terms in another order);
  * whole-model logits (prefill, 5 teacher-forced decode steps): atol
    1e-4, as ``test_torch_serve.test_prefill_and_decode_logits_match``;
  * served tokens: identical to ``repro.launch.serve.serve``'s;
  * the carry round trip: every leaf's bits and dtype.

MoE decode is held against the reference's decode, never against a
prefill: at decode the N = B tokens give each expert a capacity of 1, so
tokens are dropped by design and a decode step is not a prefill
continuation (a reference quirk the port keeps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as RefModelConfig
from repro.config import MoEConfig as RefMoEConfig
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.models import mla as ref_mla
from repro.models import moe as ref_moe
from repro.models import transformer as ref_transformer
from repro.models.model_zoo import build as ref_build

from repro_torch import carry
from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve
from repro_torch.models import mla, moe, transformer
from repro_torch.models.model_zoo import build
from torch_zoo import Family, cfgs, normal, tensors, tree_np

FAMILIES = ("mixtral-8x7b", "deepseek-v2-lite-16b", "internvl2-1b")
ATOL = 1e-5


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return Family(request.param)


# ------------------------------------------------------------------ MoE
def _moecfgs(cap, shared):
    kw = dict(name="t", arch_type="moe", n_layers=1, d_model=32, n_heads=2,
              n_kv_heads=2, d_ff=48, vocab=64, dtype="float32")
    mkw = dict(num_experts=4, top_k=2, d_ff_expert=48, capacity_factor=cap,
               num_shared_experts=shared)
    return (RefModelConfig(moe=RefMoEConfig(**mkw), **kw),
            ModelConfig(moe=MoEConfig(**mkw), **kw))


@pytest.mark.parametrize("cap,shared,drops", [
    (64.0, 0, False),        # no pair past its expert's capacity
    (0.5, 0, True),          # tight capacity: pairs dropped
    (1.25, 1, None),         # the default factor, one shared expert
])
def test_moe_ffn_matches_reference(cap, shared, drops):
    rcfg, cfg = _moecfgs(cap, shared)
    p_ref = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg, jnp.float32)
    p = tensors(p_ref)
    assert p["router"].dtype == torch.float32
    x = normal((2, 16, 32), 1)
    want, want_aux = ref_moe.moe_ffn(p_ref, jnp.asarray(x), rcfg)
    got, aux = moe.moe_ffn(p, torch.from_numpy(x), cfg)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=ATOL * max(1.0, np.abs(want).max()),
                               rtol=0)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6,
                               rtol=0)
    # the routing: jax.lax.top_k's indices (descending, ties to the lower
    # index) and the kept pairs
    xt = torch.from_numpy(x).reshape(-1, 32)
    _, _, idx = moe.route(p, xt, cfg.moe)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, 32) @ p_ref["router"])
    _, want_idx = jax.lax.top_k(probs, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    cap_n = moe.capacity(cfg.moe, 32)
    assert cap_n == max(int(cap * 32 * 2 / 4), 1)
    _, keep = moe.dispatch(idx, 4, cap_n)
    if drops is not None:
        assert bool((~keep).any()) == drops


def test_moe_dispatch_positions_are_token_major():
    """Slots count earlier pairs over the flattened (token, choice) pairs,
    the k choices inner: the reference's cumsum."""
    idx = torch.tensor([[0, 1], [1, 0], [0, 2], [1, 0]])
    slot, keep = moe.dispatch(idx, 3, 2)
    # expert 0 gets pairs 0, 3, 4, 7 -> positions 0, 1, 2 (dropped), 3
    # (dropped); expert 1 gets 1, 2, 6 -> 0, 1, 2 (dropped)
    assert keep.tolist() == [True, True, True, True, False, True, False,
                             False]
    assert slot.tolist() == [0, 2, 3, 1, 1, 4, 3, 1]


def test_moe_decode_capacity_is_one():
    """At decode N = B: the serving batch gives every expert one row."""
    for arch in ("mixtral-8x7b", "deepseek-v2-lite-16b"):
        assert moe.capacity(get_config(arch).moe, 4) == 1


# ------------------------------------------------------------------ MLA
@pytest.mark.parametrize("window", [0, 16])
def test_mla_prefill_and_decode_match(window):
    """One MLA layer (deepseek's smoke widths): prefill into a latent cache
    with room to decode (rolling at window 16), then 6 decode steps, each
    decompressing K/V from the whole cache."""
    rcfg, cfg = cfgs("deepseek-v2-lite-16b")
    p_ref = ref_mla.init_mla(jax.random.PRNGKey(0), rcfg, jnp.float32)
    p_ref["kv_norm"] = jnp.asarray(normal((64,), 9, 0.1) + 1.0)
    p = tensors(p_ref)
    B, S, steps = 2, 40, 6
    x = normal((B, S, cfg.d_model), 1)
    xs = normal((steps, B, 1, cfg.d_model), 2)
    max_seq = S + steps if window == 0 else S
    cache_ref = ref_mla.init_mla_cache(rcfg, B, max_seq, jnp.float32, window)
    cache = mla.init_mla_cache(cfg, B, max_seq, torch.float32, window)
    pos = np.arange(S, dtype=np.int32)
    want, cache_ref = ref_mla.mla_prefill(p_ref, jnp.asarray(x),
                                          jnp.asarray(pos), rcfg, cache_ref,
                                          window)
    got, cache = mla.mla_prefill(p, torch.from_numpy(x),
                                 torch.from_numpy(pos), cfg, cache, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for i in range(steps):
        want, cache_ref = ref_mla.mla_decode(p_ref, jnp.asarray(xs[i]),
                                             jnp.int32(S + i), rcfg,
                                             cache_ref, window)
        got, cache = mla.mla_decode(p, torch.from_numpy(xs[i]), S + i, cfg,
                                    cache, window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(cache_ref["pos"]))
        for key in ("c", "kpe"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(cache_ref[key]), atol=ATOL,
                                       rtol=0)


# ------------------------------------------------------------------ VLM
def test_vlm_prefix_embeddings_match():
    fam = Family("internvl2-1b")
    b_ref, b, _ = fam.prompt(2, 12, 5)
    want = ref_transformer._inputs_embeds(fam.rcfg, fam.params_ref, b_ref)
    got = transformer._inputs_embeds(fam.cfg, fam.params, b)
    assert got.shape == (2, 12, fam.cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    assert fam.params.patch_proj is not None and fam.cfg.tie_embeddings


# ------------------------------------------------------------------ models
def test_prefill_and_decode_logits_match(family):
    family.check_prefill_and_decode()


def test_mixtral_rolling_window_matches():
    """mixtral's smoke window of 32 as a rolling cache: a 40-token prompt
    keeps its last 32 positions, and decode evicts slots in the
    reference's order (the ragged-prefill quirk both packages keep)."""
    fam = Family("mixtral-8x7b")
    assert fam.cfg.swa_window == 32
    cache = fam.check_prefill_and_decode(S=40, window=32)
    assert cache[0]["k"].shape[1] == 32


@pytest.mark.parametrize("prompt_len,gen_len", [(24, 6), (33, 4)])
def test_serve_tokens_match_reference(family, prompt_len, gen_len):
    family.check_serve(prompt_len, gen_len)


def test_serve_decode_starts_after_the_patches():
    """internvl2's prompt length counts its patch positions: the decode
    positions start at prompt_len, after the 4 smoke patches."""
    fam = Family("internvl2-1b")
    seen = []
    decode = fam.model.decode_step

    def spy(params, cache, tokens, pos, window=0):
        seen.append(pos)
        return decode(params, cache, tokens, pos, window=window)

    model = dataclasses.replace(fam.model, decode_step=spy)
    import repro_torch.launch.serve as t_serve
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_serve, "build", lambda cfg: model)
        serve(fam.cfg, batch=2, prompt_len=20, gen_len=4, device="cpu",
              params=fam.params, verbose=False)
    assert seen == [20, 21, 22]


# ------------------------------------------------------------------ carry
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", REF_ARCH_IDS)
def test_carry_round_trip_keeps_bits_and_dtypes(arch):
    """model_params_to_reference(model_params_from_reference(tree)) is the
    tree, in bf16 (bf16 leaves come back as float32 with the same values;
    the MoE router and the recurrent mixers' float32 leaves stay float32
    in the port); the port's own init has the carried layout."""
    rcfg, cfg = cfgs(arch, dtype="bfloat16")
    tree = _flat(tree_np(ref_build(rcfg).init_params(
        jax.random.PRNGKey(0))))
    params = carry.model_params_from_reference(_unflat(tree), cfg, "cpu")
    back = _flat(carry.model_params_to_reference(params))
    layout = carry.reference_layout(params)
    assert set(back) == set(tree) == set(layout)
    for key, want in tree.items():
        got = back[key]
        assert got.shape == want.shape, key
        assert str(layout[key][1]) == f"torch.{want.dtype.name}", key
        np.testing.assert_array_equal(got.astype(want.dtype), want)
        np.testing.assert_array_equal(got, want.astype(np.float32))
    f32 = {k for k, (_, dt) in layout.items() if dt == torch.float32}
    assert f32 == {k for k in tree if tuple(k.split("/")[-2:])
                   in transformer.FLOAT32_LEAVES}
    own = build(cfg).init_params(seed=0, device="cpu")
    assert carry.reference_layout(own) == layout


def _unflat(flat):
    tree: dict = {}
    for key, arr in flat.items():
        *parents, last = key.split("/")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[last] = arr
    return tree
