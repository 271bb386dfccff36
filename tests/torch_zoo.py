"""Helpers shared by the model zoo's family tests (test_torch_families.py,
test_torch_recurrent.py): smoke configs of both packages, the reference's
weights carried into the port, and the port's prefill, decode and serve
held against the reference's."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.launch import serve as ref_serve
from repro.models.model_zoo import build as ref_build

from repro_torch import carry
from repro_torch.configs import get_config, smoke_variant
from repro_torch.launch.serve import serve
from repro_torch.models.model_zoo import build

LOGIT_ATOL = 1e-4


def normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tensors(tree):
    """A dict of arrays as torch tensors (copies)."""
    return {k: torch.from_numpy(np.array(a)) for k, a in tree.items()}


def cfgs(arch, **kw):
    """(reference config, port config): the smoke variant of `arch` with
    `kw` replaced."""
    return (dataclasses.replace(ref_smoke_variant(ref_get_config(arch)), **kw),
            dataclasses.replace(smoke_variant(get_config(arch)), **kw))


def grow_like_serve(cache, prompt_slots, max_seq):
    """The reference serve's growth of a prefill cache to max_seq slots."""
    def grow(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "pos":
            pad = [(0, 0)] * (leaf.ndim - 1) + [(0, max_seq - leaf.shape[-1])]
            return jnp.pad(leaf, pad, constant_values=-1)
        if name in ("xk", "xv"):
            return leaf
        if leaf.ndim >= 3 and leaf.shape[2] == prompt_slots:
            pad = [(0, 0)] * leaf.ndim
            pad[2] = (0, max_seq - prompt_slots)
            return jnp.pad(leaf, pad)
        return leaf
    return jax.tree_util.tree_map_with_path(grow, cache)


class Family:
    """A family's smoke configs, the reference's weights (seed 0) carried
    into the port, and the reference's prefill / decode jitted once a
    window."""

    def __init__(self, arch, **kw):
        self.rcfg, self.cfg = cfgs(arch, **kw)
        self.ref_model = ref_build(self.rcfg)
        self.params_ref = self.ref_model.init_params(jax.random.PRNGKey(0))
        self.params = carry.model_params_from_reference(
            tree_np(self.params_ref), self.cfg, device="cpu")
        self.model = build(self.cfg)
        self._jits = {}

    def ref_fns(self, window):
        if window not in self._jits:
            self._jits[window] = (
                jax.jit(functools.partial(self.ref_model.prefill,
                                          window=window)),
                jax.jit(functools.partial(self.ref_model.decode_step,
                                          window=window)))
        return self._jits[window]

    def prompt(self, B, S, seed):
        """A prompt of S positions (a VLM's patches among them; an enc-dec's
        frames beside them) and 8 tokens after it: (reference batch, port
        batch, next tokens)."""
        cfg = self.cfg
        P = cfg.n_prefix_patches
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab, (B, S - P + 8), dtype=np.int32)
        b = {"tokens": toks[:, :S - P]}
        if P:
            b["patch_embeds"] = normal((B, P, cfg.d_model), seed + 1)
        if cfg.is_encdec:
            b["frames"] = normal((B, cfg.encoder_seq, cfg.d_model), seed + 1)
        return ({k: jnp.asarray(a) for k, a in b.items()},
                {k: torch.from_numpy(a) for k, a in b.items()},
                toks[:, S - P:])

    def check_prefill_and_decode(self, B=2, S=24, steps=5, window=0,
                                 seed=3):
        """Prefill logits and `steps` teacher-forced decode steps, the
        port against the reference, atol LOGIT_ATOL; returns the port's
        cache."""
        ref_prefill, ref_decode = self.ref_fns(window)
        b_ref, b, nxt = self.prompt(B, S, seed)
        max_seq = S + steps
        grow = window == 0 and not self.cfg.attention_free
        want, cache_ref = ref_prefill(self.params_ref, b_ref)
        got, cache = self.model.prefill(self.params, b, window=window,
                                        cache_len=max_seq if grow else None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, rtol=0)
        if grow:
            cache_ref = grow_like_serve(cache_ref, S, max_seq)
        for i in range(steps):
            tok = nxt[:, i:i + 1]
            want, cache_ref = ref_decode(self.params_ref, cache_ref,
                                         jnp.asarray(tok), jnp.int32(S + i))
            got, cache = self.model.decode_step(self.params, cache,
                                                torch.from_numpy(tok), S + i,
                                                window=window)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=LOGIT_ATOL, rtol=0)
        return cache

    def check_serve(self, prompt_len, gen_len, window=0):
        """serve's tokens equal ``repro.launch.serve.serve``'s."""
        want = np.asarray(ref_serve.serve(
            self.rcfg, batch=3, prompt_len=prompt_len, gen_len=gen_len,
            window=window, seed=0, verbose=False))
        res = serve(self.cfg, batch=3, prompt_len=prompt_len,
                    gen_len=gen_len, window=window, seed=0, device="cpu",
                    params=self.params, verbose=False)
        assert res.tokens.shape == (3, gen_len)
        np.testing.assert_array_equal(res.tokens.numpy(), want)
        assert np.isfinite(res.logits.numpy()).all()
