"""The port's training path (model zoo loss and gradients, optimizers,
plain and federated ``train``, param checkpoints) against the JAX
reference, on the CPU.

Weights come from the reference's ``init_params`` and are carried over
with ``repro_torch.carry.model_params_from_reference``; activations are
made with NumPy from a seed.  Smoke-variant configs in float32 unless a
test says otherwise.  Tolerances:

  * ``softmax_cross_entropy``, ``layer_norm``, ``sinusoidal_positions``:
    atol 1e-6 (one or two roundings apart);
  * ``attn_train`` value and gradient: 1e-5 of the largest magnitude
    (float32 sums of <= 64 terms in another order);
  * ``loss_fn``: 1e-5 relative; each gradient leaf within 1e-5 of its
    largest |g| (the same differences through 2 layers and the head);
    ``hidden_states`` 1e-5; ``remat`` changes no bit;
  * bfloat16 (qwen3-4b smoke): loss 1e-3 relative, each leaf within
    2e-2 of its largest |g| (five bf16 ulps, 2^-8 relative each): the
    packages round their bf16 products and sums at other places
    (measured on this case: loss 6.3e-5, leaves <= 7.4e-3, at
    ``stage0/l0/attn/qn``);
  * optimizers: 1e-6 relative over 1 and 3 updates; the schedules equal;
  * ``train``: losses within 1e-4 relative; the federated host quantities
    (t*, the loads, the simulated wall clock, the returned clients of
    each step) equal.
"""
import contextlib
import dataclasses
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as ref_io
from repro.config import FLConfig as RefFLConfig
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_variant as ref_smoke_variant
from repro.data import synthetic as ref_synthetic
from repro.launch import train as ref_train
from repro.launch.train import make_batch as ref_make_batch
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import transformer as ref_transformer
from repro.models.model_zoo import build as ref_build
from repro.optim import optimizers as ref_optimizers
from repro.optim import schedule as ref_schedule

from repro_torch import carry
from repro_torch.checkpoint import io as ckpt
from repro_torch.config import FLConfig
from repro_torch.configs import get_config, smoke_variant
from repro_torch.data import synthetic
from repro_torch.launch import train as t_train
from repro_torch.launch import train_llm_federated
from repro_torch.launch.train import train
from repro_torch.models import attention, common, transformer
from repro_torch.models.model_zoo import build
from repro_torch.optim import optimizers, schedule
from torch_zoo import (assert_leaves_close, flat, port_grads, reference_plan,
                       tree_np)

ROOT = Path(__file__).resolve().parents[1]
DENSE = ("qwen3-4b", "yi-6b")
LEAF_TOL = 1e-5
BF16_LOSS_TOL, BF16_LEAF_TOL = 1e-3, 2e-2
TRAIN_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's small CPU ops, so parallel test
    workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _cfgs(arch, dtype="float32", **kw):
    ref = dataclasses.replace(ref_smoke_variant(ref_get_config(arch)),
                              dtype=dtype, **kw)
    port = dataclasses.replace(smoke_variant(get_config(arch)), dtype=dtype,
                               **kw)
    return ref, port


def _ref_params(ref_cfg, seed=0):
    return ref_build(ref_cfg).init_params(jax.random.PRNGKey(seed))


# ------------------------------------------------------------------ common
@pytest.mark.parametrize("case", ["mean", "mask", "ignore"])
def test_softmax_cross_entropy_matches(case):
    logits = _np((3, 7, 50), 0, 3.0)
    labels = np.random.default_rng(1).integers(0, 50, (3, 7))
    mask = None
    if case == "mask":
        mask = (np.random.default_rng(2).random((3, 7)) > 0.4).astype(
            np.float32)
    if case == "ignore":
        labels[0, :3] = -100
        labels[2, 5] = -100
        mask = (labels >= 0).astype(np.float32)
        labels = np.maximum(labels, 0)
    want = ref_common.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = common.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert abs(float(got) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))


def test_softmax_cross_entropy_all_masked_is_zero():
    logits = torch.from_numpy(_np((2, 3, 9), 3))
    labels = torch.zeros((2, 3), dtype=torch.int64)
    got = common.softmax_cross_entropy(logits, labels, torch.zeros((2, 3)))
    want = ref_common.softmax_cross_entropy(
        jnp.asarray(logits.numpy()), jnp.zeros((2, 3), jnp.int32),
        jnp.zeros((2, 3)))
    assert float(got) == float(want) == 0.0


def test_layer_norm_and_sinusoidal_positions_match():
    x, w, b = _np((4, 5, 32), 4, 2.0), _np((32,), 5), _np((32,), 6)
    want = ref_common.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b))
    got = common.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    for seq, d in ((16, 32), (7, 10)):
        got = common.sinusoidal_positions(seq, d)
        want = np.asarray(ref_common.sinusoidal_positions(seq, d))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ attention
@pytest.mark.parametrize("window", [0, 16])
def test_attn_train_value_and_gradient_match(window):
    rcfg, cfg = _cfgs("qwen3-4b")
    p_ref = ref_attention.init_attn(jax.random.PRNGKey(3), rcfg, jnp.float32)
    x = _np((2, 40, cfg.d_model), 7)
    r = _np((2, 40, cfg.d_model), 8)
    pos = np.arange(40, dtype=np.int32)

    def f(p, x_):
        out = ref_attention.attn_train(p, x_, jnp.asarray(pos), rcfg, window)
        return jnp.sum(out * r), out
    (_, want), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1),
                                             has_aux=True)(
        p_ref, jnp.asarray(x))
    p = {k: torch.tensor(np.asarray(v), requires_grad=True)
         for k, v in p_ref.items()}
    xt = torch.tensor(x, requires_grad=True)
    out = attention.attn_train(p, xt, torch.from_numpy(pos), cfg, window)
    (out * torch.from_numpy(r)).sum().backward()
    assert_leaves_close({"out": out.detach().numpy()},
                         {"out": np.asarray(want)}, 1e-5)
    assert_leaves_close({k: t.grad.numpy() for k, t in p.items()}
                         | {"x": xt.grad.numpy()},
                         {k: np.asarray(v) for k, v in gp.items()}
                         | {"x": np.asarray(gx)}, 1e-5)


# ------------------------------------------------------------------ loss_fn
@pytest.fixture(scope="module")
def dense_pairs():
    """{arch: (port cfg, reference params as NumPy, batch, reference loss,
    reference grads)}."""
    out = {}
    for arch in DENSE:
        rcfg, cfg = _cfgs(arch)
        params = _ref_params(rcfg)
        b = ref_make_batch(rcfg, 2, 48, 3)
        b["labels"] = b["labels"].at[0, :5].set(-100)
        model = ref_build(rcfg)
        loss, g = jax.value_and_grad(
            lambda p: model.loss_fn(p, b, remat=False))(params)
        hidden = ref_transformer.hidden_states(rcfg, params, b)
        out[arch] = (cfg, tree_np(params), b, float(loss), flat(g),
                     np.asarray(hidden))
    return out


def _port_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_every_grad_leaf_match(dense_pairs, arch):
    cfg, params_np, b, want_loss, want_g, _ = dense_pairs[arch]
    params = carry.model_params_from_reference(params_np, cfg, "cpu")
    params.requires_grad_(True)
    loss = transformer.loss_fn(cfg, params, _port_batch(b), remat=False)
    loss.backward()
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    assert_leaves_close(port_grads(params), want_g, LEAF_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_remat_changes_no_bit(dense_pairs, arch):
    cfg, params_np, b, _, _, _ = dense_pairs[arch]
    got = {}
    for remat in (False, True):
        params = carry.model_params_from_reference(params_np, cfg, "cpu")
        params.requires_grad_(True)
        loss = transformer.loss_fn(cfg, params, _port_batch(b), window=8,
                                   remat=remat)
        loss.backward()
        got[remat] = (loss.detach(), port_grads(params))
    assert torch.equal(got[False][0], got[True][0])
    for key, g in got[False][1].items():
        np.testing.assert_array_equal(got[True][1][key], g)


@pytest.mark.parametrize("arch", DENSE)
def test_hidden_states_match(dense_pairs, arch):
    cfg, params_np, b, _, _, want = dense_pairs[arch]
    params = carry.model_params_from_reference(params_np, cfg, "cpu")
    got = transformer.hidden_states(cfg, params, _port_batch(b))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_bf16_loss_and_grads_within_bf16_tolerance():
    rcfg, cfg = _cfgs("qwen3-4b", dtype="bfloat16")
    params = _ref_params(rcfg, seed=1)
    b = ref_make_batch(rcfg, 2, 32, 5)
    loss, g = jax.value_and_grad(
        lambda p: ref_build(rcfg).loss_fn(p, b, remat=False))(params)
    tp = carry.model_params_from_reference(tree_np(params), cfg, "cpu")
    tp.requires_grad_(True)
    got = transformer.loss_fn(cfg, tp, _port_batch(b))
    got.backward()
    assert got.dtype == torch.float32
    assert all(p.grad.dtype == torch.bfloat16 for p in tp.parameters())
    assert abs(float(got) - float(loss)) <= BF16_LOSS_TOL * float(loss)
    assert_leaves_close(port_grads(tp), flat(g), BF16_LEAF_TOL)


def test_abstract_params_shapes_match_reference():
    for arch in DENSE:
        rcfg, cfg = _cfgs(arch, dtype="bfloat16")
        want = {k: (v.shape, str(v.dtype)) for k, v in dict(
            ckpt._path_leaves(ref_transformer.abstract_params(rcfg))).items()}
        ghost = build(cfg).abstract_params()
        assert all(p.is_meta for p in ghost.parameters())
        got = {k: (shape, str(dt).replace("torch.", ""))
               for k, (shape, dt) in carry.reference_layout(ghost).items()}
        assert got == want


# ------------------------------------------------------------------ optim
def _opt_trees(dtype):
    names = ("a", "b/c", "d")
    shapes = ((5, 3), (4,), (2, 2, 3))
    params = {k: _np(s, i) for i, (k, s) in enumerate(zip(names, shapes))}
    grads = [{k: _np(s, 10 * t + i, 0.5)
              for i, (k, s) in enumerate(zip(names, shapes))}
             for t in range(3)]
    return params, grads


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("updates", [1, 3])
def test_optimizers_match(name, updates):
    params, grads = _opt_trees("float32")
    r_init, r_update = ref_optimizers.get(name)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rs = r_init(rp)
    t_init, t_update = optimizers.get(name)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = t_init(tp)
    for t in range(updates):
        lr = 0.05 / (t + 1)
        rp, rs = r_update(rp, {k: jnp.asarray(v) for k, v in
                               grads[t].items()}, rs, lr)
        tp, ts = t_update(tp, {k: torch.from_numpy(v) for k, v in
                               grads[t].items()}, ts, lr)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=1e-7)
    if name == "adam":
        assert ts["t"] == int(rs["t"]) == updates
        for part in ("m", "v"):
            for k in params:
                np.testing.assert_allclose(ts[part][k].numpy(),
                                           np.asarray(rs[part][k]),
                                           rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_bf16_params_keep_float32_state(name):
    p = {"w": torch.from_numpy(_np((6, 4), 1)).to(torch.bfloat16)}
    init, update = optimizers.get(name)
    state = init(p)
    moments = [state["w"]] if name == "momentum" else [state["m"]["w"],
                                                        state["v"]["w"]]
    assert all(m.dtype == torch.float32 for m in moments)
    g = {"w": torch.from_numpy(_np((6, 4), 2)).to(torch.bfloat16)}
    before = p["w"].clone()
    p, state = update(p, g, state, 0.1)
    assert p["w"].dtype == torch.bfloat16 and not torch.equal(p["w"], before)
    assert all(m.dtype == torch.float32 for m in moments)
    # the reference's arithmetic: float32 moments, the new value cast once
    rp = {"w": jnp.asarray(before.float().numpy(), jnp.bfloat16)}
    r_init, r_update = ref_optimizers.get(name)
    rp, _ = r_update(rp, {"w": jnp.asarray(g["w"].float().numpy(),
                                           jnp.bfloat16)}, r_init(rp), 0.1)
    np.testing.assert_array_equal(p["w"].float().numpy(),
                                  np.asarray(rp["w"], np.float32))


def test_schedules_equal():
    for args in ((3e-3, 20, 2), (1e-2, 7, 0), (0.5, 100, 10), (1.0, 1, 0)):
        port, ref = schedule.cosine(*args), ref_schedule.cosine(*args)
        assert [port(s) for s in range(-1, args[1] + 3)] == \
            [ref(s) for s in range(-1, args[1] + 3)]
    port = schedule.step_decay(0.4, 0.1, (5, 9))
    ref = ref_schedule.step_decay(0.4, 0.1, (5, 9))
    assert [port(e) for e in range(12)] == [ref(e) for e in range(12)]
    with pytest.raises(ValueError):
        optimizers.get("lamb")


@pytest.mark.parametrize("vocab,batch,seq,seed", [(512, 3, 17, 0),
                                                  (50, 2, 64, 9)])
def test_synthetic_tokens_bit_identical(vocab, batch, seq, seed):
    got = synthetic.synthetic_tokens(vocab, batch, seq, seed)
    want = ref_synthetic.synthetic_tokens(vocab, batch, seq, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ train
def test_train_plain_matches_reference():
    rcfg, cfg = _cfgs("qwen3-4b")
    _, want, wall = ref_train.train(rcfg, steps=4, batch=2, seq=32,
                                    log_every=0, seed=2)
    params = carry.model_params_from_reference(
        tree_np(_ref_params(rcfg, seed=2)), cfg, "cpu")
    got_params, got, got_wall = train(cfg, steps=4, batch=2, seq=32,
                                      log_every=0, seed=2, device="cpu",
                                      params=params)
    assert got_params is params and got_wall == wall == 0.0
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL)
    assert got[-1] < got[0]


# (n_clients, seed): 4 clients; 1 client at a seed whose second step has no
# return (found by the host replay; the test asserts it)
@pytest.mark.parametrize("n,seed", [(4, 0), (1, 1)])
def test_train_federated_matches_reference(n, seed):
    rcfg, cfg = _cfgs("qwen3-4b")
    steps, batch, seq = 3, 2, 32
    t_star, loads, returned = reference_plan(
        rcfg, RefFLConfig(n_clients=n), batch, seq, seed, steps)
    if n == 1:
        assert [] in returned
    _, want, wall = ref_train.train(rcfg, steps=steps, batch=batch, seq=seq,
                                    federated=True,
                                    fl_cfg=RefFLConfig(n_clients=n),
                                    log_every=0, seed=seed)
    params = carry.model_params_from_reference(
        tree_np(_ref_params(rcfg, seed=seed)), cfg, "cpu")
    hist = {}
    _, got, got_wall = train(cfg, steps=steps, batch=batch, seq=seq,
                             federated=True, fl_cfg=FLConfig(n_clients=n),
                             log_every=0, seed=seed, device="cpu",
                             params=params, history=hist)
    assert got_wall == wall == steps * t_star
    assert hist["t_star"] == t_star and hist["loads"] == loads
    assert hist["returned"] == returned
    assert len(hist["step_s"]) == steps
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=TRAIN_TOL)


def test_train_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, cfg = _cfgs("qwen3-4b")
    with pytest.raises(RuntimeError, match="cuda"):
        train(cfg, steps=1)
    with pytest.raises(RuntimeError, match="cuda"):
        train_llm_federated.main(steps=1)


# ------------------------------------------------------------------ checkpoints
def test_param_checkpoints_cross_packages(tmp_path):
    rcfg, cfg = _cfgs("yi-6b", dtype="bfloat16")
    params = _ref_params(rcfg, seed=4)
    ref_file = str(tmp_path / "ref.npz")
    ref_io.save(ref_file, params, step=7)
    like = build(cfg).abstract_params()
    got = ckpt.restore(ref_file, like, device="cpu")
    assert ckpt.restore_step(ref_file) == ref_io.restore_step(ref_file) == 7
    assert got.embed.dtype == torch.bfloat16
    back = carry.model_params_to_reference(got)
    for key, arr in flat(params).items():
        np.testing.assert_array_equal(ckpt._flatten(back)[key], arr)
    # the port writes, the reference restores: the same bits
    port_file = str(tmp_path / "port.npz")
    ckpt.save(port_file, got)
    assert ckpt.restore_step(port_file) is None
    # (the reference's restore reads values, not ShapeDtypeStructs, from
    # its like tree)
    again = ref_io.restore(port_file, _ref_params(rcfg))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(
            np.asarray(a, np.float32), np.asarray(b, np.float32)),
        again, params)
    # a port tree restored into a port Transformer on the CPU
    dense = ckpt.restore(port_file, got)
    for (ka, a), (kb, b) in zip(dense.named_parameters(),
                                got.named_parameters()):
        assert ka == kb and torch.equal(a, b)


def test_plain_tree_checkpoints_and_optimizer_state(tmp_path):
    init, update = optimizers.adam()
    p = {"w": torch.from_numpy(_np((3, 2), 0)), "b": torch.zeros(2)}
    state = init(p)
    p, state = update(p, {k: torch.ones_like(v) for k, v in p.items()},
                      state, 0.1)
    path = str(tmp_path / "opt.npz")
    ckpt.save(path, {"params": p, "opt": state}, step=1)
    ref_like = {"params": {k: jnp.zeros(v.shape) for k, v in p.items()},
                "opt": {"m": {k: jnp.zeros(v.shape) for k, v in p.items()},
                        "v": {k: jnp.zeros(v.shape) for k, v in p.items()},
                        "t": jnp.zeros((), jnp.int32)}}
    ref_got = ref_io.restore(path, ref_like)
    assert int(ref_got["opt"]["t"]) == 1
    got = ckpt.restore(path, {"params": p, "opt": state})
    assert got["opt"]["t"] == 1 and isinstance(got["opt"]["t"], int)
    for k in p:
        assert torch.equal(got["params"][k], p[k])
        np.testing.assert_array_equal(np.asarray(ref_got["opt"]["m"][k]),
                                      state["m"][k].numpy())


def _refusal(fn) -> str:
    with pytest.raises(ValueError) as exc:
        fn()
    return str(exc.value)


def test_param_restore_refusals_match_reference(tmp_path):
    rcfg, cfg = _cfgs("qwen3-4b")
    params = _ref_params(rcfg)
    path = str(tmp_path / "p.npz")
    leaves = flat(params)
    cases = {
        "extra": dict(leaves, **{"stage0/l0/bogus": np.zeros(2)}),
        "missing": {k: v for k, v in leaves.items() if k != "stage0/l0/ln2"},
        "shape": dict(leaves, final_norm=np.zeros(3, np.float32)),
    }
    for name, payload in cases.items():
        np.savez(path, **payload)
        want = _refusal(lambda: ref_io.restore(path, params))
        got = _refusal(lambda: ckpt.restore(
            path, transformer.abstract_params(cfg), device="cpu"))
        assert got == want, name


# ------------------------------------------------------------------ launchers
def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "ref_train_llm_federated", ROOT / "examples" / "train_llm_federated.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_printed(fn) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


_NUM = re.compile(r"-?\d+(\.\d+)?")


def _shape(lines):
    return [_NUM.sub("#", ln) for ln in lines]


def test_train_llm_federated_prints_the_examples_lines(monkeypatch):
    ref = _reference_example()
    monkeypatch.setattr(sys, "argv", ["train_llm_federated.py", "--steps",
                                      "2", "--clients", "3", "--seq", "64"])
    want = _run_printed(ref.main)
    hist = {}
    got = _run_printed(lambda: train_llm_federated.main(
        "20m", steps=2, clients=3, seq=64, device="cpu", history=hist))
    assert _shape(got) == _shape(want)
    assert got[0] == want[0]
    # the simulated wall clock is a host quantity: the same digits
    sim = re.compile(r"(\d+)s simulated")
    assert sim.search(got[-1]).group(1) == sim.search(want[-1]).group(1)
    assert len(hist["returned"]) == 2


def test_train_main_prints_the_references_lines(monkeypatch):
    argv = ["--steps", "2", "--batch", "2", "--seq", "16", "--federated"]
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    want = _run_printed(ref_train.main)
    got = _run_printed(lambda: t_train.main(argv + ["--device", "cpu"]))
    assert _shape(got) == _shape(want)
    sim = re.compile(r"wall-clock ([\d.]+)s")
    assert sim.search(got[-1]).group(1) == sim.search(want[-1]).group(1)
