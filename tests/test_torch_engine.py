"""The PyTorch port's main path against the JAX reference, end to end.

The same client data (NumPy, from a seed) goes through the reference's
``repro.api.build_experiment(...).run`` and the port's, on the CPU.  The
reference's random draws that the port cannot reproduce (the ``jax.random``
generator key chain, the RFF frequencies) are carried over with
``repro_torch.carry``.  Held to:

  * bit-identical: t*, loads, processed subsets, setup time, privacy
    epsilon, returned counts and the wall clock (same NumPy generator in
    the same order, same float32 casts);
  * theta after 25 rounds within atol 1e-5, the tolerance of
    ``tests/test_batched_engine.py``;
  * the per-round eval (|theta|_1 as the loss, and accuracy) within
    rtol 1e-4, atol 1e-5.

Also: each module that holds a kernel (rff, encoding, aggregation) at the
module level, and the port's import isolation from ``jax`` and ``repro``.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import config as ref_config
from repro.core import aggregation as ref_agg
from repro.core import encoding as ref_enc
from repro.core import fed_runtime as ref_runtime
from repro.core import rff as ref_rff

from repro_torch import api as t_api
from repro_torch import carry
from repro_torch import config as t_config
from repro_torch.core import aggregation as t_agg
from repro_torch.core import encoding as t_enc
from repro_torch.core import fed_runtime as t_runtime
from repro_torch.core import rff as t_rff

ROOT = Path(__file__).resolve().parents[1]
N, L, Q, C = 8, 24, 32, 3
ROUNDS = 25


def _data(n=N, l=L, q=Q, c=C, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, l, q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(n, l, c)).astype(np.float32)
    return xs, ys


def _spec(mod, scheme, kernel_backend="xla"):
    fl = mod.FLConfig(n_clients=N, delta=0.25, psi=0.3, seed=3)
    tc = mod.TrainConfig(learning_rate=0.5, l2_reg=1e-4,
                         lr_decay_epochs=(10, 18))
    params = {"u_fraction": 0.4} if scheme == "partial_coded" else {}
    return mod.ExperimentSpec(fl=fl, train=tc, scheme=scheme,
                              scheme_params=params,
                              kernel_backend=kernel_backend)


def _reference_generators(seed, n, u, l):
    """The reference's per-client generators: the split chain of
    ``CodedScheme.setup`` from PRNGKey(seed + 99)."""
    def chain(key, _):
        key, sub = jax.random.split(key)
        return key, sub
    _, keys = jax.lax.scan(chain, jax.random.PRNGKey(seed + 99), None,
                           length=n)
    return np.asarray(jax.vmap(
        lambda k: ref_enc.generator_matrix(k, u, l))(keys))


def _eval_fn(xs, ys):
    """(|theta|_1, accuracy of argmax(x theta) against argmax(y))."""
    x = xs.reshape(-1, xs.shape[-1]).astype(np.float64)
    labels = ys.reshape(-1, ys.shape[-1]).argmax(1)

    def fn(theta):
        th = (theta.cpu().numpy() if isinstance(theta, torch.Tensor)
              else np.asarray(theta)).astype(np.float64)
        acc = float(((x @ th).argmax(1) == labels).mean())
        return float(np.abs(th).sum()), acc
    return fn


CASES = [("naive", "xla"), ("greedy", "xla"), ("ideal", "xla"),
         ("coded", "xla"), ("partial_coded", "xla"), ("coded", "pallas")]


@pytest.mark.parametrize("scheme,kernel_backend", CASES,
                         ids=[f"{s}-{k}" for s, k in CASES])
def test_port_matches_reference(scheme, kernel_backend):
    xs, ys = _data()
    ref_exp = ref_api.build_experiment(
        _spec(ref_config, scheme, kernel_backend), xs, ys)
    gens = None
    if ref_exp.scheme_obj.coded:
        gens = carry.generators_from_reference(
            _reference_generators(3, N, ref_exp.u, L), device="cpu")
    t_exp = t_api.build_experiment(_spec(t_config, scheme, kernel_backend),
                                   xs, ys, device="cpu",
                                   parity_generators=gens)
    ref_res = ref_exp.run(ROUNDS, eval_fn=_eval_fn(xs, ys), eval_every=1)
    t_res = t_exp.run(ROUNDS, eval_fn=_eval_fn(xs, ys), eval_every=1)

    assert t_res.t_star == ref_res.t_star
    np.testing.assert_array_equal(t_res.loads, ref_res.loads)
    assert len(t_exp.processed_idx) == len(ref_exp.processed_idx)
    for got, want in zip(t_exp.processed_idx, ref_exp.processed_idx):
        np.testing.assert_array_equal(got, want)
    assert t_res.setup_time == ref_res.setup_time
    assert t_res.privacy_eps == ref_res.privacy_eps
    assert [h.returned for h in t_res.history] == \
        [h.returned for h in ref_res.history]
    assert [h.wall_clock for h in t_res.history] == \
        [h.wall_clock for h in ref_res.history]
    np.testing.assert_allclose(t_res.theta.numpy(), np.asarray(ref_res.theta),
                               atol=1e-5)
    for ht, hr in zip(t_res.history, ref_res.history):
        np.testing.assert_allclose(ht.loss, hr.loss, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ht.accuracy, hr.accuracy, rtol=1e-4,
                                   atol=1e-5)
        assert (ht.n_masked, ht.skipped) == (hr.n_masked, hr.skipped)
    assert dataclasses.astuple(t_res.health) == \
        dataclasses.astuple(ref_res.health)


def test_port_without_carried_generators_is_deterministic():
    """The port's own generator draw: equal seeds give equal runs, and the
    host-side quantities still match the reference (they do not depend on
    the generators)."""
    xs, ys = _data()
    runs = [t_api.build_experiment(_spec(t_config, "coded"), xs, ys,
                                   device="cpu").run(6) for _ in range(2)]
    torch.testing.assert_close(runs[0].theta, runs[1].theta, rtol=0, atol=0)
    ref_res = ref_api.build_experiment(_spec(ref_config, "coded"),
                                       xs, ys).run(6)
    assert [h.wall_clock for h in runs[0].history] == \
        [h.wall_clock for h in ref_res.history]


def test_parity_generators_shape_is_checked():
    xs, ys = _data()
    with pytest.raises(ValueError, match="parity_generators"):
        t_api.build_experiment(_spec(t_config, "coded"), xs, ys,
                               device="cpu",
                               parity_generators=np.zeros((N, 3, L),
                                                          np.float32))


# ----------------------------------------------------- modules with a kernel
def test_rff_transform_matches_reference():
    x = np.random.default_rng(1).uniform(0, 1, (41, 13)).astype(np.float32)
    cfg = ref_config.RFFConfig(q=70, sigma=2.0, seed=5)
    omega, delta = ref_rff.rff_params(cfg, 13)
    want = ref_rff.rff_transform(jnp.asarray(x), omega, delta)
    om, de = carry.rff_from_reference(np.asarray(omega), np.asarray(delta),
                                      device="cpu")
    got = t_rff.rff_transform(torch.from_numpy(x), om, de)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the port's own shared-seed draw: deterministic, right shapes/moments
    om2, de2 = t_rff.rff_params(t_config.RFFConfig(q=70, sigma=2.0, seed=5),
                                13, device="cpu")
    om3, _ = t_rff.rff_params(t_config.RFFConfig(q=70, sigma=2.0, seed=5),
                              13, device="cpu")
    assert om2.shape == (13, 70) and de2.shape == (70,)
    torch.testing.assert_close(om2, om3, rtol=0, atol=0)
    assert 0.0 <= float(de2.min()) and float(de2.max()) < 2 * np.pi


def test_encode_local_batched_matches_reference():
    n, u, l, q, c = 3, 7, 11, 9, 2
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, l, q)).astype(np.float32)
    y = rng.normal(size=(n, l, c)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (n, l)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    want = ref_enc.aggregate_parity_stacked(
        ref_enc.encode_local_batched(keys, x, y, w, u))
    g = np.asarray(jax.vmap(lambda k: ref_enc.generator_matrix(k, u, l))(
        keys))
    got = t_enc.aggregate_parity_stacked(t_enc.encode_local_batched(
        carry.generators_from_reference(g, device="cpu"),
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w)))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        t_enc.weight_vector(l, np.array([1, 4]), 0.3),
        ref_enc.weight_vector(l, np.array([1, 4]), 0.3))


def test_fused_round_tensors_and_gradients_match_reference():
    n, l_max, u, q, c = 4, 6, 9, 10, 3
    rng = np.random.default_rng(3)
    sub_x = rng.normal(size=(n, l_max, q)).astype(np.float32)
    sub_y = rng.normal(size=(n, l_max, c)).astype(np.float32)
    mask = (rng.uniform(size=(n, l_max)) < 0.7).astype(np.float32)
    par_x = rng.normal(size=(u, q)).astype(np.float32)
    par_y = rng.normal(size=(u, c)).astype(np.float32)
    theta = rng.normal(size=(q, c)).astype(np.float32) * 0.3
    want = ref_agg.fused_client_parity_tensors(sub_x, sub_y, mask, par_x,
                                               par_y, pnr_c=0.1)
    got = t_agg.fused_client_parity_tensors(
        *(torch.from_numpy(a) for a in (sub_x, sub_y, mask, par_x, par_y)),
        pnr_c=0.1)
    for g_t, w_t in zip(got, want):
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(w_t))
    grads_want = ref_agg.batched_client_gradients(
        want[0], want[1], jnp.asarray(theta), mask=want[2])
    grads = t_agg.batched_client_gradients(
        got[0], got[1], carry.theta_from_reference(theta, device="cpu"),
        mask=got[2])
    np.testing.assert_allclose(grads.numpy(), np.asarray(grads_want),
                               rtol=1e-5, atol=1e-5)
    ret = np.array([1, 0, 1, 1, 1], np.float32)
    np.testing.assert_allclose(
        t_agg.masked_gradient_sum(grads, torch.from_numpy(ret)).numpy(),
        np.asarray(ref_agg.masked_gradient_sum(grads_want, ret)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("guard", [True, False])
def test_guard_and_sum_matches_reference(guard):
    """The non-finite guard: a returned client's non-finite gradient row is
    zeroed out of the sum and counted; without the guard it poisons it."""
    g = np.random.default_rng(5).normal(size=(4, 3, 2)).astype(np.float32)
    g[1, 2, 0] = np.nan
    g[3, 0, 1] = np.inf
    ret = np.array([1.0, 1.0, 0.0, 0.0], np.float32)
    want_sum, want_masked = ref_runtime._guard_and_sum(
        jnp.asarray(g), jnp.asarray(ret), None, guard)
    got_sum, got_masked = t_runtime.guard_and_sum(
        torch.from_numpy(g), torch.from_numpy(ret), guard)
    np.testing.assert_allclose(got_sum.numpy(), np.asarray(want_sum),
                               rtol=1e-6, atol=1e-6, equal_nan=True)
    assert int(got_masked) == int(want_masked) == (1 if guard else 0)


# ------------------------------------------------------------ import isolation
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s))",
    re.MULTILINE)


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.api, repro_torch.carry\n"
        "import repro_torch.core.rff, repro_torch.data.synthetic\n"
        "import repro_torch.data.sharding, repro_torch.kernels.build\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT, timeout=120)
    sources = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    offenders = [str(p) for p in sources if _FORBIDDEN.search(p.read_text())]
    assert not offenders, offenders
