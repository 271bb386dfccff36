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


# ------------------------------------------------------------------ training
LEAF_TOL = 1e-5


def flat(tree) -> dict:
    """{reference key path: float32 array} of a reference tree."""
    from repro_torch.checkpoint import io as ckpt
    return ckpt._flatten(tree_np(tree))


def port_grads(params) -> dict:
    """The port's gradients in the reference's key paths (layers
    stacked)."""
    out = {}
    for key, leaf in carry._layer_leaves(params).items():
        out[key] = (np.stack([carry._host(t.grad) for t in leaf])
                    if isinstance(leaf, list) else carry._host(leaf.grad))
    return out


def assert_leaves_close(got: dict, want: dict, tol: float = LEAF_TOL):
    """Each leaf within `tol` of its largest magnitude in `want`."""
    assert sorted(got) == sorted(want)
    for key in want:
        scale = max(float(np.abs(want[key]).max()), 1e-30)
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= tol * scale, (key, err, scale)


def port_batch(b) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


class TrainCase:
    """A family's smoke configs (float32 unless `kw` says otherwise), the
    reference's weights (seed 0), a training batch and the reference's
    loss, every gradient leaf (``jax.value_and_grad`` of its ``loss_fn``
    at remat=False) and hidden states.  The batch is ``make_batch``'s
    (B, S, seed) with the first row's first 5 labels masked (-100), its
    tokens replaced by `tokens` where given."""

    def __init__(self, arch, B=2, S=48, seed=3, tokens=None, chunked=True,
                 **kw):
        from repro.launch.train import make_batch as ref_make_batch
        from repro.models import transformer as ref_transformer
        self.rcfg, self.cfg = cfgs(arch, **kw)
        self.chunked = chunked
        ref_model = ref_build(self.rcfg)
        self.params_ref = ref_model.init_params(jax.random.PRNGKey(0))
        self.params_np = tree_np(self.params_ref)
        b = ref_make_batch(self.rcfg, B, S, seed)
        if tokens is not None:
            b["tokens"] = jnp.asarray(tokens)
        b["labels"] = b["labels"].at[0, :5].set(-100)
        self.batch_ref = b
        self.batch = port_batch(b)
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: ref_model.loss_fn(p, b, remat=False,
                                        chunked=chunked)))(self.params_ref)
        self.loss, self.grads = float(loss), flat(g)
        self.hidden = None
        if not self.cfg.is_encdec:
            self.hidden = np.asarray(jax.jit(functools.partial(
                ref_transformer.hidden_states, self.rcfg,
                chunked=chunked))(self.params_ref, b))

    def port_params(self):
        """A fresh port model with the reference's weights, gradients on."""
        params = carry.model_params_from_reference(self.params_np, self.cfg,
                                                   device="cpu")
        return params.requires_grad_(True)

    def port_loss_and_grads(self, remat=False):
        params = self.port_params()
        loss = build(self.cfg).loss_fn(params, self.batch, remat=remat,
                                       chunked=self.chunked)
        loss.backward()
        return loss.detach(), port_grads(params)

    def check_loss_and_grads(self):
        loss, grads = self.port_loss_and_grads()
        assert abs(float(loss) - self.loss) <= LEAF_TOL * abs(self.loss)
        assert_leaves_close(grads, self.grads)

    def check_remat_changes_no_bit(self):
        (l0, g0), (l1, g1) = (self.port_loss_and_grads(remat=r)
                              for r in (False, True))
        assert torch.equal(l0, l1)
        for key, g in g0.items():
            np.testing.assert_array_equal(g1[key], g)

    def check_hidden_states(self):
        from repro_torch.models import transformer
        got = transformer.hidden_states(self.cfg, self.port_params(),
                                        self.batch, chunked=self.chunked)
        assert got.shape == self.hidden.shape
        np.testing.assert_allclose(
            got.detach().numpy(), self.hidden, rtol=0,
            atol=LEAF_TOL * max(1.0, float(np.abs(self.hidden).max())))


def reference_plan(rcfg, fl, batch, seq, seed, steps):
    """The reference train's federated host setup and delay draws, replayed
    with the reference's own modules: (t*, loads, returned sets)."""
    from repro.core import load_allocation as ref_alloc
    from repro.core.delay_model import mec_network, packet_bits, scale_tau
    n_param = sum(np.prod(leaf.shape) for leaf in jax.tree_util.tree_leaves(
        ref_build(rcfg).abstract_params()))
    nodes = [scale_tau(nd, packet_bits(fl, int(n_param)))
             for nd in mec_network(fl, d_scalars_per_point=seq * 4)]
    alloc = ref_alloc.two_step_allocate(
        nodes, [float(batch)] * fl.n_clients, server=None,
        u_max=0.25 * batch * fl.n_clients, m=float(batch * fl.n_clients))
    rng = np.random.default_rng(seed + 5)
    returned = [[j for j in range(fl.n_clients)
                 if nodes[j].sample(rng, float(alloc.loads[j]))[0]
                 <= alloc.t_star] for _ in range(steps)]
    return alloc.t_star, list(alloc.loads), returned


def check_param_checkpoints(arch, tmp_path):
    """A bf16 tree of `arch` both ways across packages: the reference
    writes and the port restores into ``abstract_params`` (the same bits,
    each leaf in its dtype), the port writes and the reference restores
    (the same bits), and a port file restores into a port model."""
    from repro.checkpoint import io as ref_io
    from repro_torch.checkpoint import io as ckpt
    from repro_torch.models import transformer
    rcfg, cfg = cfgs(arch, dtype="bfloat16")
    params = ref_build(rcfg).init_params(jax.random.PRNGKey(4))
    ref_file = str(tmp_path / f"{arch}-ref.npz")
    ref_io.save(ref_file, params, step=3)
    got = ckpt.restore(ref_file, build(cfg).abstract_params(), device="cpu")
    assert type(got).__name__ == ("EncDec" if cfg.is_encdec
                                  else "Transformer")
    assert ckpt.restore_step(ref_file) == ref_io.restore_step(ref_file) == 3
    layout = carry.reference_layout(got)
    want = flat(params)
    back = ckpt._flatten(carry.model_params_to_reference(got))
    assert sorted(back) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(back[key], arr)
        name = tuple(key.split("/")[-2:])
        assert layout[key][1] == (
            torch.float32 if name in transformer.FLOAT32_LEAVES
            else torch.bfloat16), key
    port_file = str(tmp_path / f"{arch}-port.npz")
    ckpt.save(port_file, got, step=5)
    again = ref_io.restore(port_file, params)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a, np.float32), np.asarray(b, np.float32)),
        again, params)
    mine = ckpt.restore(port_file, got)
    for (ka, a), (kb, b) in zip(mine.named_parameters(),
                                got.named_parameters()):
        assert ka == kb and a.dtype == b.dtype and torch.equal(a, b)
