"""The port's training path for the MoE, MLA and VLM-prefix families and
the encoder-decoder (mixtral-8x7b, deepseek-v2-lite-16b, internvl2-1b,
whisper-base) against the JAX reference, on the CPU.

Weights come from the reference's ``init_params`` and are carried over
with ``repro_torch.carry.model_params_from_reference``; the batches are
``make_batch``'s.  Smoke-variant configs in float32 (bf16 for the
checkpoints).  Tolerances, as ``tests/test_torch_train.py``'s:

  * ``loss_fn``: 1e-5 relative; each gradient leaf of
    ``jax.value_and_grad`` within 1e-5 of its largest |g| (float32 sums
    in another order through 2 layers and the head); ``remat`` changes
    no bit; ``hidden_states`` 1e-5;
  * MoE: the routing (each (token, choice) pair's expert and whether it
    is kept) equal at every MoE layer, then each layer's load-balance
    value within 1e-5 relative;
  * the whisper encoder's and internvl2's patch_proj gradients: the
    leaf tolerance, and non-zero.

``abstract_params``, the param checkpoints, ``train`` and the probe of
these families are in ``tests/test_torch_train_zoo.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models.model_zoo import build as ref_build

from repro_torch.configs import get_config
from repro_torch.models import moe, transformer
from repro_torch.models.model_zoo import build
from torch_zoo import LEAF_TOL, TrainCase

FAMILIES = ("mixtral-8x7b", "deepseek-v2-lite-16b", "internvl2-1b",
            "whisper-base")
# jamba's Mamba + MoE layer too (48 positions: the sequential scan)
MOE = ("mixtral-8x7b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops, so parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, arch) -> TrainCase:
    if arch not in cases:
        cases[arch] = TrainCase(arch)
    return cases[arch]


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_every_grad_leaf_match(cases, arch):
    _case(cases, arch).check_loss_and_grads()


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_bit(cases, arch):
    _case(cases, arch).check_remat_changes_no_bit()


@pytest.mark.parametrize("arch", FAMILIES[:3])
def test_hidden_states_match(cases, arch):
    """internvl2's keep the patch positions: (B, P + S, D)."""
    case = _case(cases, arch)
    P = case.cfg.n_prefix_patches
    assert case.hidden.shape[1] == P + case.batch["tokens"].shape[1]
    case.check_hidden_states()


# ------------------------------------------------------------------ MoE
def _spy(monkeypatch, module, seen):
    """Record each MoE layer's input, router and load-balance value."""
    inner = module.moe_ffn

    def spy(p, x, cfg):
        out, aux = inner(p, x, cfg)
        seen.append((x, p["router"], aux))
        return out, aux
    monkeypatch.setattr(module, "moe_ffn", spy)


def _reference_routing(x, router, m):
    """The reference's moe_ffn's routing lines: (gate indices (N, k),
    kept (N, k)) of its layer input."""
    N = x.shape[0] * x.shape[1]
    probs = jax.nn.softmax(x.reshape(N, -1).astype(jnp.float32) @ router,
                           axis=-1)
    _, gate_idx = jax.lax.top_k(probs, m.top_k)
    cap = max(int(m.capacity_factor * N * m.top_k / m.num_experts), 1)
    flat = jax.nn.one_hot(gate_idx, m.num_experts,
                          dtype=jnp.int32).reshape(N * m.top_k, -1)
    pos = jnp.max(jnp.cumsum(flat, axis=0) * flat - 1, axis=-1)
    return (np.asarray(gate_idx),
            np.asarray(pos.reshape(N, m.top_k) < cap))


@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_equal_and_aux_matches(cases, arch, monkeypatch):
    """At every MoE layer, each package routes its own layer input: the
    experts chosen and the pairs kept are equal (a flipped choice would
    show here first), some pairs are dropped at the training capacity,
    and the layer's load-balance value is the reference's; the loss's aux
    part (loss - cross-entropy) is their sum."""
    case = _case(cases, arch)
    m = case.cfg.moe
    ref_seen, seen = [], []
    _spy(monkeypatch, ref_moe, ref_seen)
    _spy(monkeypatch, moe, seen)
    with jax.disable_jit():            # the stages' scan runs eagerly
        ref_build(case.rcfg).loss_fn(case.params_ref, case.batch_ref,
                                     remat=False)
    params = case.port_params()
    loss = build(case.cfg).loss_fn(params, case.batch, remat=False)
    n_moe = sum(ffn == "moe" for _, ffn in transformer.layer_specs(case.cfg))
    assert len(seen) == len(ref_seen) == n_moe >= 1
    dropped = 0
    for (x_r, router_r, aux_r), (x, router, aux) in zip(ref_seen, seen):
        want_idx, want_keep = _reference_routing(x_r, router_r, m)
        xt = x.detach().reshape(-1, x.shape[-1])
        _, _, gate_idx = moe.route({"router": router}, xt, m)
        _, keep = moe.dispatch(gate_idx, m.num_experts,
                               moe.capacity(m, xt.shape[0]))
        np.testing.assert_array_equal(gate_idx.numpy(), want_idx)
        np.testing.assert_array_equal(
            keep.reshape(gate_idx.shape).numpy(), want_keep)
        dropped += int((~want_keep).sum())
        assert abs(float(aux.detach()) - float(aux_r)) <= 1e-5 * abs(
            float(aux_r))
    assert dropped > 0
    # the aux part of the loss: the sum of the layers' values
    total = sum(float(a.detach()) for _, _, a in seen)
    with torch.no_grad():
        ce = float(loss) - total
    assert total > 0 and abs(ce + total - case.loss) <= LEAF_TOL * case.loss


def test_moe_training_capacity():
    """max(int(1.25 N k / E), 1) with N = B S, the reference's rule: at
    4 x 64 tokens 80 for mixtral (8 experts, top 2), 40 for jamba (16,
    top 2), 30 for deepseek (64, top 6)."""
    for arch in ("mixtral-8x7b", "jamba-1.5-large-398b",
                 "deepseek-v2-lite-16b"):
        m, rm = get_config(arch).moe, ref_get_config(arch).moe
        want = max(int(rm.capacity_factor * 256 * rm.top_k
                       / rm.num_experts), 1)
        assert moe.capacity(m, 4 * 64) == want
    assert [moe.capacity(get_config(a).moe, 4 * 64) for a in (
        "mixtral-8x7b", "jamba-1.5-large-398b",
        "deepseek-v2-lite-16b")] == [80, 40, 30]


# ------------------------------------------------------------------ VLM, enc-dec
def test_vlm_prefix_is_cut_and_patch_proj_trains(cases):
    """internvl2: the labels cover the token positions only (the loss of
    a batch whose patch positions change differs, its label count does
    not), and patch_proj's gradient is non-zero and the reference's."""
    case = _case(cases, "internvl2-1b")
    loss, grads = case.port_loss_and_grads()
    g, want = grads["patch_proj"], case.grads["patch_proj"]
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(g, want, rtol=0,
                               atol=LEAF_TOL * np.abs(want).max())
    b = dict(case.batch)
    assert b["labels"].shape == b["tokens"].shape
    b["patch_embeds"] = b["patch_embeds"] * 2
    other = build(case.cfg).loss_fn(case.port_params(), b, remat=False)
    assert float(other) != float(loss)


def test_encoder_leaves_have_the_references_gradients(cases):
    """whisper: every encoder leaf (enc_in_proj, enc_norm, the encoder
    layers) gets a non-zero gradient equal to the reference's: the
    encoder runs under autograd in training."""
    case = _case(cases, "whisper-base")
    _, grads = case.port_loss_and_grads()
    keys = [k for k in case.grads if k.startswith(("enc/", "enc_"))]
    assert len(keys) >= 9
    for key in keys:
        want = case.grads[key]
        assert np.abs(want).max() > 0 and np.abs(grads[key]).max() > 0, key
        np.testing.assert_allclose(grads[key], want, rtol=0,
                                   atol=LEAF_TOL * np.abs(want).max())
