"""Block-structured runs, RunState checkpoints, run_multi, the vectorized
load allocator and the quickstart of the PyTorch port, against the JAX
reference, on the CPU.

The same client data (NumPy, from a seed) goes through both packages; the
reference's ``jax.random`` draws (the parity generator key chain, the RFF
frequencies) are carried over with ``repro_torch.carry``.  Sizes are those
of ``tests/test_torch_engine.py`` (n = 8, l = 24, q = 32, c = 3).  Held to:

  * bit-identical: wall clock, returned counts, t*, loads, the RNG state
    and every checkpoint field but theta (same NumPy generator in the same
    order, same float32 casts);
  * theta within atol 1e-5 and eval losses within rtol 1e-4, atol 1e-5,
    the tolerances of ``tests/test_torch_engine.py``; run_multi accuracy
    within 1e-4;
  * a checkpoint either package writes restores, digest-verified, in the
    other and finishes the run;
  * port kill/resume bit-identical to the uninterrupted port run.

The port's vectorized allocator is held to the reference's own contract
against the scalar solver (``tests/test_load_allocation.py``): t* within
2e-6 (1 + t*), loads within 1e-4, and node for node at the same deadline
within 1e-6 (1 + cap) (1e-5 on asymmetric links, as there).  It is also
held against the reference's vectorized allocator itself, to the same
contract: that one imports ``jax.experimental.enable_x64``, which this JAX
lacks, so the `x64_shim` fixture sets the name to ``jax.enable_x64(True)``
for those tests only (no file of the reference changes).
"""
import dataclasses
import json
import os

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import config as ref_config
from repro.checkpoint import io as ref_ckpt
from repro.core import delay_model as ref_dm
from repro.core import encoding as ref_enc
from repro.core import load_allocation as ref_la
from repro.core.delay_model import NodeDelayParams as RefNode
from repro.core import rff as ref_rff
from repro.core.run_state import pack_state as ref_pack
from repro.data import sharding as ref_sharding
from repro.data import synthetic as ref_synthetic
from repro.faults import bitflip_file, truncate_file

from repro_torch import api as t_api
from repro_torch import carry
from repro_torch import config as t_config
from repro_torch.checkpoint import io as t_ckpt
from repro_torch.core import load_allocation as la
from repro_torch.core import run_state as t_rs
from repro_torch.core.delay_model import NodeDelayParams
from repro_torch.launch import quickstart

N, L, Q, C = 8, 24, 32, 3
D = 8                     # raw features of the fused_embed cases
SEED = 3
ROUNDS = 12
EVERY = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's float64 solvers run many small CPU ops: one intra-op
    thread each keeps parallel test workers from oversubscribing the
    cores (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(n=N, l=L, q=Q, c=C, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, l, q)).astype(np.float32) * 0.2
    ys = rng.normal(size=(n, l, c)).astype(np.float32)
    return xs, ys


def _spec(mod, scheme="coded", **over):
    fl = mod.FLConfig(n_clients=N, delta=0.25, psi=0.3, seed=SEED)
    tc = mod.TrainConfig(learning_rate=0.5, l2_reg=1e-4,
                         lr_decay_epochs=(5, 9))
    params = {"u_fraction": 0.4} if scheme == "partial_coded" else {}
    base = dict(fl=fl, train=tc, scheme=scheme, scheme_params=params,
                checkpoint_every=EVERY)
    base.update(over)
    return mod.ExperimentSpec(**base)


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


def _pair(scheme="coded", xs=None, ys=None, **over):
    """(reference experiment, port experiment) of one deployment, the
    port's generators carried over from the reference."""
    if xs is None:
        xs, ys = _data()
    ref_exp = ref_api.build_experiment(_spec(ref_config, scheme, **over),
                                       xs, ys)
    gens = None
    if ref_exp.scheme_obj.coded:
        gens = carry.generators_from_reference(
            _reference_generators(SEED, N, ref_exp.u, L), device="cpu")
    t_exp = t_api.build_experiment(_spec(t_config, scheme, **over), xs, ys,
                                   device="cpu", parity_generators=gens)
    return ref_exp, t_exp


def _port(spec, xs=None, ys=None):
    if xs is None:
        xs, ys = _data()
    return t_api.build_experiment(spec, xs, ys, device="cpu")


def _loss_fn(theta):
    th = (theta.cpu().numpy() if isinstance(theta, torch.Tensor)
          else np.asarray(theta))
    return float(np.abs(th.astype(np.float64)).sum()), 0.0


def _np(theta):
    return (theta.cpu().numpy() if isinstance(theta, torch.Tensor)
            else np.asarray(theta))


def _same_host(got, want):
    """Bit-identical host quantities of two FedResults."""
    assert [h.wall_clock for h in got.history] == \
        [h.wall_clock for h in want.history]
    assert [h.returned for h in got.history] == \
        [h.returned for h in want.history]
    assert got.t_star == want.t_star
    np.testing.assert_array_equal(got.loads, want.loads)
    assert got.privacy_eps == want.privacy_eps


def _close(got, want):
    """Theta within 1e-5 and eval losses within rtol 1e-4 of `want`."""
    np.testing.assert_allclose(_np(got.theta), _np(want.theta), atol=1e-5)
    for hg, hw in zip(got.history, want.history):
        np.testing.assert_allclose(hg.loss, hw.loss, rtol=1e-4, atol=1e-5)


def _same_result(a, b):
    """Bit-identical port results (theta, history, health)."""
    assert torch.equal(a.theta, b.theta)
    assert a.privacy_eps == b.privacy_eps
    for ha, hb in zip(a.history, b.history):
        assert ha.wall_clock == hb.wall_clock
        assert ha.returned == hb.returned
        assert (ha.loss == hb.loss
                or (np.isnan(ha.loss) and np.isnan(hb.loss)))
    assert a.health == b.health


def _ckpt(tmp_path, rounds_done):
    return str(tmp_path / f"{t_ckpt.CKPT_PREFIX}{rounds_done:06d}.npz")


# --------------------------------------------------------------- run state
def test_pack_unpack_round_trip():
    exp = _port(_spec(t_config))
    state = exp.run_block(exp.init_state(ROUNDS, collect=True),
                          eval_fn=_loss_fn, eval_every=1)
    arrays, meta = t_rs.pack_state(state)
    back = t_rs.unpack_state(arrays, meta, device="cpu")
    for f in dataclasses.fields(state):
        a, b = getattr(state, f.name), getattr(back, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        elif isinstance(a, np.ndarray):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    assert back.rounds_done == EVERY and not back.done


def test_state_digest_matches_reference(tmp_path):
    exp = _port(_spec(t_config))
    state = exp.run_block(exp.init_state(ROUNDS))
    arrays, meta = t_rs.pack_state(state)
    meta["spec"] = exp.spec.to_dict()
    assert t_ckpt._state_digest(arrays, meta) == \
        ref_ckpt._state_digest(arrays, meta)
    # the digest the port writes is the one the reference recomputes
    path = exp.save_state(_ckpt(tmp_path, state.rounds_done), state)
    with np.load(path) as data:
        stored = json.loads(str(data["__meta__"][()]))["__digest__"]
    ref_arrays, ref_meta = ref_ckpt.restore_state(path)
    assert stored == ref_ckpt._state_digest(ref_arrays, ref_meta)


def test_packed_state_matches_reference_layout():
    """Same keys, dtypes and shapes, equal host arrays and equal meta (RNG
    state included) after one block of the same run."""
    ref_exp, t_exp = _pair()
    ref_state = ref_exp.run_block(ref_exp.init_state(ROUNDS, collect=True),
                                  eval_fn=_loss_fn, eval_every=1)
    t_state = t_exp.run_block(t_exp.init_state(ROUNDS, collect=True),
                              eval_fn=_loss_fn, eval_every=1)
    ref_arrays, ref_meta = ref_pack(ref_state)
    t_arrays, t_meta = t_rs.pack_state(t_state)
    assert t_meta == ref_meta
    assert sorted(t_arrays) == sorted(ref_arrays)
    for key, want in ref_arrays.items():
        got = t_arrays[key]
        assert (got.dtype, got.shape) == (want.dtype, want.shape), key
        if key == "theta":
            np.testing.assert_allclose(got, want, atol=1e-5)
        elif key in ("losses", "accs"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_array_equal(got, want)


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    ref_exp, _ = _pair()
    control = ref_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1)
    writer, t_exp = _pair()
    state = writer.run_block(writer.init_state(ROUNDS, collect=True),
                             eval_fn=_loss_fn, eval_every=1)
    writer.save_state(_ckpt(tmp_path, state.rounds_done), state)
    resumed = t_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1,
                        checkpoint_dir=str(tmp_path), resume=True)
    _same_host(resumed, control)
    _close(resumed, control)
    # the port's blocks after the restored one wrote checkpoints the
    # reference reads back, digest-verified
    ref_ckpt.restore_state(_ckpt(tmp_path, ROUNDS))


def test_port_checkpoint_resumes_in_the_reference(tmp_path):
    _, t_exp = _pair()
    control = t_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1)
    ref_exp, writer = _pair()
    state = writer.run_block(writer.init_state(ROUNDS, collect=True),
                             eval_fn=_loss_fn, eval_every=1)
    path = writer.save_state(_ckpt(tmp_path, state.rounds_done), state)
    ref_ckpt.restore_state(path, verify=True)
    resumed = ref_exp.run(ROUNDS, eval_fn=_loss_fn, eval_every=1,
                          checkpoint_dir=str(tmp_path), resume=True)
    _same_host(resumed, control)
    _close(resumed, control)


def _raw_data(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(N, L, D)).astype(np.float32) * 0.5
    ys = rng.normal(size=(N, L, C)).astype(np.float32)
    return xs, ys


_KILL_CASES = {
    "coded": dict(scheme="coded"),
    "naive": dict(scheme="naive"),
    "greedy": dict(scheme="greedy"),
    "ideal": dict(scheme="ideal"),
    "partial_coded": dict(scheme="partial_coded"),
    "fused_embed": dict(scheme="coded", fused_embed=True,
                        rff=t_config.RFFConfig(q=Q, sigma=2.0, seed=5)),
    "unfused": dict(scheme="coded", fused_coded=False),
}


@pytest.mark.parametrize("case", list(_KILL_CASES))
def test_port_kill_and_resume_bit_identical(case, tmp_path):
    """Save at the first block boundary, rebuild the experiment from
    scratch, resume: the result equals the uninterrupted blocked run."""
    spec = _spec(t_config, **_KILL_CASES[case])
    xs, ys = _raw_data() if spec.fused_embed else _data()
    control = _port(spec, xs, ys).run(ROUNDS, eval_fn=_loss_fn,
                                      eval_every=1)
    interrupted = _port(spec, xs, ys)
    state = interrupted.run_block(interrupted.init_state(ROUNDS,
                                                         collect=True),
                                  eval_fn=_loss_fn, eval_every=1)
    assert state.rounds_done == EVERY
    path = interrupted.save_state(_ckpt(tmp_path, EVERY), state)
    assert os.path.exists(path)
    del interrupted, state       # the kill
    resumed = _port(spec, xs, ys).run(
        ROUNDS, eval_fn=_loss_fn, eval_every=1,
        checkpoint_dir=str(tmp_path), resume=True)
    _same_result(control, resumed)


def test_one_block_keeps_the_unblocked_trajectory():
    """checkpoint_every = 0 is one block; an explicit n_rounds chain over
    the same draws' partition gives the run's bits too."""
    spec = _spec(t_config, checkpoint_every=0)
    whole = _port(spec).run(ROUNDS)
    exp = _port(spec)
    state = exp.init_state(ROUNDS)
    state = exp.run_block(state, n_rounds=ROUNDS + 5)     # clipped
    assert state.done
    _same_result(whole, exp.finish(state))


# --------------------------------------------------------------- run_multi
@pytest.mark.parametrize("scheme", ["coded", "naive"])
def test_run_multi_matches_reference(scheme):
    xs, ys = _data()
    ref_exp, t_exp = _pair(scheme, checkpoint_every=0)
    x = xs.reshape(-1, Q).astype(np.float64)
    labels = ys.reshape(-1, C).argmax(1)

    def acc_fn(theta):
        th = _np(theta).astype(np.float64)
        return 0.0, float(((x @ th).argmax(1) == labels).mean())

    want = ref_exp.run_multi(ROUNDS, 4, eval_fn=acc_fn)
    got = t_exp.run_multi(ROUNDS, 4, eval_fn=acc_fn)
    assert got.wall_clock.shape == (4, ROUNDS)
    np.testing.assert_array_equal(got.wall_clock, want.wall_clock)
    np.testing.assert_array_equal(got.returned, want.returned)
    np.testing.assert_allclose(_np(got.theta), np.asarray(want.theta),
                               atol=1e-5)
    np.testing.assert_allclose(got.accuracy, want.accuracy, atol=1e-4)
    assert got.t_star == want.t_star
    for g, w in zip(got.wall_clock_bands(), want.wall_clock_bands()):
        np.testing.assert_array_equal(g, w)
    assert got.health == t_api.RunHealth(0, 0, 0, 1.0)


def test_run_multi_of_one_realization_is_run():
    spec = _spec(t_config, checkpoint_every=0)
    single = _port(spec).run(ROUNDS)
    multi = _port(spec).run_multi(ROUNDS, 1)
    assert torch.equal(multi.theta[0], single.theta)
    assert multi.wall_clock[0].tolist() == \
        [h.wall_clock for h in single.history]
    assert multi.returned[0].tolist() == [h.returned for h in single.history]


def test_run_multi_kill_and_resume(tmp_path):
    spec = _spec(t_config, checkpoint_every=3)
    control = _port(spec).run_multi(6, 3)
    exp = _port(spec)
    state = exp.run_block(exp.init_state(6, n_realizations=3))
    exp.save_state(_ckpt(tmp_path, state.rounds_done), state)
    resumed = _port(spec).run_multi(6, 3, checkpoint_dir=str(tmp_path),
                                    resume=True)
    assert torch.equal(control.theta, resumed.theta)
    np.testing.assert_array_equal(control.wall_clock, resumed.wall_clock)
    np.testing.assert_array_equal(control.returned, resumed.returned)


# ------------------------------------- the stationary cases of test_resume
def test_checkpoint_every_partitioning_is_self_consistent():
    """Different checkpoint_every values are different (equally valid)
    partitions of the stream; equal partitions agree bit for bit."""
    r4a = _port(_spec(t_config, checkpoint_every=4)).run(ROUNDS)
    r4b = _port(_spec(t_config, checkpoint_every=4)).run(ROUNDS)
    _same_result(r4a, r4b)
    r0a = _port(_spec(t_config, checkpoint_every=0)).run(ROUNDS)
    r0b = _port(_spec(t_config, checkpoint_every=0)).run(ROUNDS)
    _same_result(r0a, r0b)


def test_run_block_validation_errors():
    exp = _port(_spec(t_config))
    state = exp.init_state(4)
    with pytest.raises(ValueError, match="collect"):
        exp.run_block(state, eval_fn=_loss_fn)
    with pytest.raises(ValueError, match="eval_fn"):
        exp.run_block(exp.init_state(4, collect=True))
    done = exp._drive(state, None)
    with pytest.raises(ValueError, match="complete"):
        exp.run_block(done)
    with pytest.raises(ValueError, match="complete"):
        exp.finish(state)      # the original state: 0/4 rounds
    with pytest.raises(ValueError, match="checkpoint_dir"):
        exp.run(4, resume=True)
    with pytest.raises(ValueError, match="iterations"):
        exp.init_state(0)
    with pytest.raises(ValueError, match="n_realizations"):
        exp.init_state(4, n_realizations=0)


@pytest.mark.parametrize("mode,feature", [("multi_channel", "channel"),
                                          ("hier", "hierarchical")])
def test_run_block_refuses_modes_not_ported(mode, feature):
    """A traced run_multi state runs in the port, but only on an experiment
    with a channel (this one has none); a hier state belongs to
    `repro_torch.hier.HierExperiment`, and the flat engine refuses it
    naming the tier (the reference's flat run_block would run it as a
    single trajectory)."""
    exp = _port(_spec(t_config))
    state = dataclasses.replace(exp.init_state(4, n_realizations=2),
                                mode=mode)
    with pytest.raises(ValueError, match=feature):
        exp.run_block(state)


@pytest.mark.parametrize("key,value", [
    ("trace", {"rng_state": {}, "rounds_done": 0}),
    ("est", {"beta": 0.9, "window": None, "rounds_seen": 0}),
    ("controls", {"t_star": 1.0, "n_wait": None}),
    ("has_sched", True)])
def test_unpack_refuses_channel_state(key, value):
    """Channel state unpacks since it was ported; a payload whose meta
    declares a channel part without that part's arrays is refused."""
    exp = _port(_spec(t_config))
    arrays, meta = t_rs.pack_state(exp.init_state(4))
    meta[key] = value
    with pytest.raises(ValueError, match="channel state"):
        t_rs.unpack_state(arrays, meta, device="cpu")


def test_checkpoint_requires_batched_engine(tmp_path):
    with pytest.raises(ValueError, match="batched"):
        _spec(t_config, engine="legacy")
    exp = _port(_spec(t_config, engine="legacy", checkpoint_every=0))
    with pytest.raises(ValueError, match="batched"):
        exp.run(4, checkpoint_dir=str(tmp_path))


def test_provenance_mismatch_rejected(tmp_path):
    exp_a = _port(_spec(t_config, "coded"))
    path = exp_a.save_state(_ckpt(tmp_path, 0), exp_a.init_state(4))
    exp_b = _port(_spec(t_config, "greedy"))
    with pytest.raises(ValueError, match="provenance"):
        exp_b.restore_state(path)


def test_mode_mismatch_rejected(tmp_path):
    exp = _port(_spec(t_config))
    exp.save_state(_ckpt(tmp_path, 0), exp.init_state(4, n_realizations=2))
    with pytest.raises(ValueError, match="run_multi"):
        _port(_spec(t_config)).run(4, checkpoint_dir=str(tmp_path),
                                   resume=True)
    exp.save_state(_ckpt(tmp_path, 1), exp.init_state(4))
    with pytest.raises(ValueError, match=r"run\(\)"):
        _port(_spec(t_config)).run_multi(4, 2, checkpoint_dir=str(tmp_path),
                                         resume=True)


def test_state_payload_round_trip_and_meta_required(tmp_path):
    arrays = {"x": np.arange(6.0).reshape(2, 3),
              "nested/y": np.ones(3, bool)}
    meta = {"cursor": 7, "rng": {"state": 2 ** 100 + 3}}
    path = t_ckpt.save_state(str(tmp_path / "s.npz"), arrays, meta)
    got_arrays, got_meta = t_ckpt.restore_state(path)
    assert got_meta == meta
    for key in arrays:
        np.testing.assert_array_equal(got_arrays[key], arrays[key])
    # the reference reads the same file, digest-verified
    ref_arrays, ref_meta = ref_ckpt.restore_state(path)
    assert ref_meta == meta
    with pytest.raises(ValueError, match="reserved"):
        t_ckpt.save_state(str(tmp_path / "bad.npz"),
                          {"__meta__": np.zeros(1)}, {})
    with pytest.raises(ValueError, match="reserved"):
        t_ckpt.save_state(str(tmp_path / "bad.npz"), {},
                          {t_ckpt.DIGEST_KEY: "x"})
    # a plain npz is not a state payload
    np.savez(str(tmp_path / "plain.npz"), a=np.zeros(2))
    with pytest.raises(ValueError, match="__meta__"):
        t_ckpt.restore_state(str(tmp_path / "plain.npz"))


def test_latest_checkpoint_orders_numerically(tmp_path):
    for step in (4, 12, 8):
        t_ckpt.save_state(_ckpt(tmp_path, step), {"x": np.zeros(1)},
                          {"step": step})
    (tmp_path / "notes.txt").write_text("ignore me")
    (tmp_path / f"{t_ckpt.CKPT_PREFIX}abc.npz").write_bytes(b"")
    latest = t_ckpt.latest_checkpoint(str(tmp_path))
    assert latest.endswith(f"{t_ckpt.CKPT_PREFIX}000012.npz")
    assert t_ckpt.latest_checkpoint(str(tmp_path / "empty")) is None


def _tamper_digest(path):
    """Rewrite the npz with one array's bytes changed but the original
    ``__meta__`` (and its digest) kept."""
    with np.load(path) as data:
        raw = {k: data[k] for k in data.files}
    key = next(k for k in raw if not k.startswith("__"))
    raw[key] = np.asarray(raw[key]) + 1
    np.savez(path[:-len(".npz")], **raw)


@pytest.mark.parametrize("corrupt, match", [
    (lambda p: truncate_file(p, frac=0.5), "unreadable"),
    (bitflip_file, "unreadable|digest"),
    (_tamper_digest, "digest"),
], ids=["truncated", "bitflipped", "digest_mismatch"])
def test_restore_state_detects_corruption(tmp_path, corrupt, match):
    path = t_ckpt.save_state(str(tmp_path / "s.npz"),
                             {"x": np.arange(64.0)}, {"cursor": 3})
    t_ckpt.restore_state(path)                    # intact: loads
    corrupt(path)
    with pytest.raises(t_ckpt.CheckpointCorruptError, match=match):
        t_ckpt.restore_state(path)


def test_latest_checkpoint_valid_only_falls_back(tmp_path):
    for step in (4, 8, 12):
        t_ckpt.save_state(_ckpt(tmp_path, step),
                          {"x": np.full(8, float(step))}, {"step": step})
    truncate_file(_ckpt(tmp_path, 12), frac=0.5)
    assert t_ckpt.latest_checkpoint(str(tmp_path)).endswith("000012.npz")
    assert t_ckpt.latest_checkpoint(
        str(tmp_path), valid_only=True).endswith("000008.npz")
    _tamper_digest(_ckpt(tmp_path, 8))
    assert t_ckpt.latest_checkpoint(
        str(tmp_path), valid_only=True).endswith("000004.npz")


def test_stale_tmp_files_swept_and_never_resumed(tmp_path):
    stale = tmp_path / f"{t_ckpt.CKPT_PREFIX}000008.npz.tmp.npz"
    stale.write_bytes(b"half-written garbage")
    assert t_ckpt.latest_checkpoint(str(tmp_path)) is None
    t_ckpt.save_state(_ckpt(tmp_path, 4), {"x": np.zeros(2)}, {})
    assert not stale.exists()
    assert t_ckpt.latest_checkpoint(str(tmp_path)).endswith("000004.npz")


def test_resume_from_empty_dir_starts_fresh(tmp_path):
    control = _port(_spec(t_config)).run(8)
    resumed = _port(_spec(t_config)).run(
        8, checkpoint_dir=str(tmp_path / "nothing_here"), resume=True)
    _same_result(control, resumed)


def test_resume_falls_back_past_corrupt_latest(tmp_path):
    spec = _spec(t_config)
    control = _port(spec).run(ROUNDS)
    exp = _port(spec)
    state = exp.init_state(ROUNDS)
    for _ in range(2):                             # two block boundaries
        state = exp.run_block(state)
        exp.save_state(_ckpt(tmp_path, state.rounds_done), state)
    truncate_file(_ckpt(tmp_path, 8), frac=0.5)
    resumed = _port(spec).run(ROUNDS, checkpoint_dir=str(tmp_path),
                              resume=True)
    _same_result(control, resumed)


# -------------------------------------------------- the vectorized allocator
def _population(n, seed, p_max=0.5):
    rng = np.random.default_rng(seed)
    return [NodeDelayParams(mu=float(rng.uniform(1, 10)),
                            alpha=float(rng.uniform(0.5, 5)),
                            tau=float(rng.uniform(0.01, 0.3)),
                            p=float(rng.uniform(0, p_max)))
            for _ in range(n)]


def _asymmetric(n, seed):
    rng = np.random.default_rng(seed)
    return [NodeDelayParams(
        mu=float(rng.uniform(1, 10)), alpha=float(rng.uniform(0.5, 4)),
        tau=float(rng.uniform(0.01, 0.2)), p=float(rng.uniform(0, 0.3)),
        tau_up=float(rng.uniform(0.05, 0.5)),
        p_up=float(rng.uniform(0, 0.4))) for _ in range(n)]


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
def test_vectorized_step1_matches_scalar(kind):
    if kind == "symmetric":
        clients, cap, tol, times = _population(40, 7), 40.0, 1e-6, \
            (0.5, 2.5, 8.0)
    else:
        clients, cap, tol, times = _asymmetric(8, 17), 30.0, 1e-5, \
            (0.8, 3.0, 9.0)
    caps = [cap] * len(clients)
    for t in times:
        lv, rv = la.vectorized_optimal_loads(clients, t, caps, device="cpu")
        assert lv.dtype == np.float64
        for j, nd in enumerate(clients):
            l_s, r_s = la.optimal_load(nd, t, caps[j])
            assert abs(lv[j] - l_s) < tol * (1.0 + caps[j]), (t, j)
            assert abs(rv[j] - r_s) < tol * (1.0 + r_s), (t, j)


def test_vectorized_step1_matches_lambert_w_at_p0():
    awgn = _population(12, seed=3, p_max=0.0)
    caps = [25.0] * 12
    for t in (0.2, 1.0, 4.0, 15.0):
        lv, rv = la.vectorized_optimal_loads(awgn, t, caps, device="cpu")
        for j, nd in enumerate(awgn):
            assert abs(lv[j] - la.awgn_optimal_load(nd, t, caps[j])) \
                < 1e-6 * (1.0 + caps[j])
            r_c = la.awgn_optimal_return(nd, t, caps[j])
            assert abs(rv[j] - r_c) < 1e-6 * (1.0 + r_c)


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
def test_vectorized_two_step_matches_scalar(kind):
    if kind == "symmetric":
        clients, cap = _population(10, 11), 30.0
    else:
        # three clients: the scalar solver's nested cdf is slow
        rng = np.random.default_rng(23)
        clients, cap = [NodeDelayParams(
            mu=float(rng.uniform(1, 10)), alpha=2.0,
            tau=float(rng.uniform(0.01, 0.2)), p=0.05,
            tau_up=float(rng.uniform(0.1, 0.5)), p_up=0.1)
            for _ in range(3)], 30.0
    n = len(clients)
    m = n * cap
    a_s = la.two_step_allocate(clients, [cap] * n, None, 0.2 * m, m)
    a_v = la.two_step_allocate_vectorized(clients, [cap] * n, None,
                                          0.2 * m, m, device="cpu")
    assert abs(a_v.t_star - a_s.t_star) <= 2e-6 * (1.0 + a_s.t_star)
    np.testing.assert_allclose(a_v.loads, a_s.loads, atol=1e-4, rtol=1e-4)
    assert abs(a_v.total_return - m) < 1e-2 * m
    lv, _ = la.vectorized_optimal_loads(clients, a_v.t_star, [cap] * n,
                                        device="cpu")
    tol = 1e-5 if kind == "asymmetric" else 1e-6
    for j, nd in enumerate(clients):
        l_s, _ = la.optimal_load(nd, a_v.t_star, cap)
        assert abs(lv[j] - l_s) < tol * (1.0 + cap)


def test_vectorized_two_step_with_server_node():
    clients = [NodeDelayParams(mu=5.0, alpha=2.0, tau=0.05, p=0.1)
               for _ in range(4)]
    server = NodeDelayParams(mu=500.0, alpha=20.0, tau=0.001, p=0.01)
    m = 4 * 20.0
    a_s = la.two_step_allocate(clients, [20.0] * 4, server, u_max=0.5 * m,
                               m=m)
    a_v = la.two_step_allocate_vectorized(clients, [20.0] * 4, server,
                                          u_max=0.5 * m, m=m, device="cpu")
    assert abs(a_v.t_star - a_s.t_star) <= 2e-6 * (1.0 + a_s.t_star)
    assert abs(a_v.u_star - a_s.u_star) < 1e-4 * (1.0 + a_s.u_star)
    assert a_v.coded_return > 0
    with pytest.raises(ValueError, match="infeasible"):
        la.two_step_allocate_vectorized(clients[:1], [10.0], None,
                                        u_max=1.0, m=100.0, device="cpu")


@pytest.fixture
def x64_shim():
    """``jax.experimental.enable_x64`` for the reference's vectorized
    allocator, for one test."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


def _ref_nodes(nodes):
    return [RefNode(**vars(nd)) for nd in nodes]


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric"])
def test_vectorized_step1_matches_the_reference(x64_shim, kind):
    """Node for node at fixed deadlines against the reference's
    vectorized step 1, at the allocator's node tolerance."""
    clients = _population(40, 7) if kind == "symmetric" \
        else _asymmetric(8, 17)
    caps = [30.0] * len(clients)
    for t in (0.5, 2.5, 8.0):
        lv, rv = la.vectorized_optimal_loads(clients, t, caps, device="cpu")
        lr, rr = ref_la.vectorized_optimal_loads(_ref_nodes(clients), t,
                                                 caps)
        np.testing.assert_allclose(lv, lr, rtol=0, atol=1e-6 * 31.0)
        np.testing.assert_allclose(rv, rr, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["symmetric", "asymmetric", "server",
                                  "mnist_rff_100"])
def test_vectorized_two_step_matches_the_reference(x64_shim, kind):
    """The port's vectorized allocator against the reference's: t* within
    2e-6 (1 + t*), loads within 1e-4; t* bit-equal at the small sizes,
    where it comes out so.  At n = 100 the total's sum over the nodes is
    associated otherwise (torch.sum against jnp.sum), and t* lands ulps
    apart."""
    server = None
    if kind == "symmetric":
        clients, cap = _population(10, 11), 30.0
    elif kind == "asymmetric":
        clients, cap = _asymmetric(6, 23), 30.0
    elif kind == "server":
        clients, cap = [NodeDelayParams(mu=5.0, alpha=2.0, tau=0.05, p=0.1)
                        for _ in range(4)], 20.0
        server = NodeDelayParams(mu=500.0, alpha=20.0, tau=0.001, p=0.01)
    else:
        # the deployment where auto picks this solver: MNIST-RFF at n = 100
        fl = ref_config.FLConfig(n_clients=100, delta=0.2, seed=0)
        payload = ref_dm.packet_bits(fl, 20000)
        clients = [NodeDelayParams(**vars(ref_dm.scale_tau(nd, payload)))
                   for nd in ref_dm.mec_network(fl, 20000)]
        cap = 120.0
    n = len(clients)
    m = n * cap
    u = (0.5 if server is not None else 0.2) * m
    got = la.two_step_allocate_vectorized(clients, [cap] * n, server, u, m,
                                          device="cpu")
    want = ref_la.two_step_allocate_vectorized(
        _ref_nodes(clients), [cap] * n,
        None if server is None else RefNode(**vars(server)), u, m)
    if kind != "mnist_rff_100":
        assert got.t_star == want.t_star
    assert abs(got.t_star - want.t_star) <= 2e-6 * (1.0 + want.t_star)
    np.testing.assert_allclose(got.loads, want.loads, rtol=0, atol=1e-4)
    assert abs(got.u_star - want.u_star) < 1e-4 * (1.0 + want.u_star)


def test_auto_backend_picks_the_vectorized_solver_at_64_clients():
    n, l, q, c = 64, 6, 8, 2
    xs, ys = _data(n, l, q, c)
    fl = t_config.FLConfig(n_clients=n, delta=0.25, psi=0.3, seed=SEED)
    spec = t_config.ExperimentSpec(fl=fl, scheme="coded")
    exp = t_api.build_experiment(spec, xs, ys, device="cpu")
    assert exp._pick_alloc_backend() == "vectorized"
    want = la.two_step_allocate_vectorized(
        exp.nodes, [float(l)] * n, None, float(exp.u), float(exp.m),
        device="cpu")
    assert exp.t_star == want.t_star
    np.testing.assert_array_equal(
        exp.loads, np.minimum(np.floor(want.loads).astype(int), l))
    res = exp.run(5, eval_fn=_loss_fn, eval_every=1)
    assert torch.isfinite(res.theta).all()
    assert all(0 <= h.returned <= n for h in res.history)


# -------------------------------------------------------------- quickstart
def _reference_quickstart(rounds, realizations):
    """What ``examples/quickstart.py`` computes, with the reference API:
    (omega, delta), {scheme: parity generators}, the table, the bands."""
    fl = ref_config.FLConfig(n_clients=10, delta=0.2, psi=0.2)
    ds = ref_synthetic.synthetic_classification(m_train=2000, m_test=500,
                                                d=64)
    rcfg = ref_config.RFFConfig(q=256, sigma=2.0)
    omega, delta = ref_rff.rff_params(rcfg, d=64)
    xh_tr = np.asarray(ref_rff.rff_transform(ds.x_train, omega, delta))
    xh_te = np.asarray(ref_rff.rff_transform(ds.x_test, omega, delta))
    from repro.core.delay_model import mec_network as ref_mec
    nodes = ref_mec(fl, d_scalars_per_point=rcfg.q * ds.n_classes)
    shards = ref_sharding.sort_and_shard(xh_tr, ds.y_train, fl.n_clients)
    per_client = ref_sharding.assign_shards_by_speed(shards, nodes,
                                                     minibatch=200)
    xs = np.stack([c[0] for c in per_client])
    ys = np.stack([ds.one_hot(c[1]) for c in per_client])
    tcfg = ref_config.TrainConfig(learning_rate=ref_rff.suggest_lr(xh_tr))

    def eval_fn(theta):
        return 0.0, float(((xh_te @ np.asarray(theta)).argmax(1)
                           == ds.y_test).mean())

    base = ref_config.ExperimentSpec(fl=fl, train=tcfg, rff=rcfg)
    table, gens = {}, {}
    for scheme in quickstart.SCHEMES:
        exp = ref_api.build_experiment(
            dataclasses.replace(base, scheme=scheme), xs, ys)
        if exp.scheme_obj.coded:
            gens[scheme] = _reference_generators(fl.seed, fl.n_clients,
                                                 exp.u, xs.shape[1])
        res = exp.run(rounds, eval_fn=eval_fn, eval_every=rounds // 4)
        table[scheme] = res
    bands = {scheme: ref_api.build_experiment(
        dataclasses.replace(base, scheme=scheme), xs, ys).run_multi(
            rounds, realizations).wall_clock_bands()
        for scheme in ("naive", "coded")}
    return (np.asarray(omega), np.asarray(delta)), gens, table, bands


def test_quickstart_matches_reference():
    rounds, realizations = 100, 8          # the reference script's
    draw, gens, table, bands = _reference_quickstart(rounds, realizations)
    lines = []
    got = quickstart.main(rounds, realizations, device="cpu", rff_draw=draw,
                          parity_generators=gens, out=lines.append)
    assert any("bit-identical = True" in ln for ln in lines)
    assert got["resume_identical"] and got["killed_at"] == rounds // 4
    for scheme, want in table.items():
        row = got["table"][scheme]
        assert [h.wall_clock for h in row["history"]] == \
            [h.wall_clock for h in want.history], scheme
        assert [h.returned for h in row["history"]] == \
            [h.returned for h in want.history], scheme
        assert row["t_star"] == want.t_star
        # epsilon reads the embedded features: the port embeds them itself
        # (float32 products summed in another order, last bits apart)
        np.testing.assert_allclose(row["privacy_eps"] or 0.0,
                                   want.privacy_eps or 0.0, rtol=1e-6)
        for hg, hw in zip(row["history"], want.history):
            np.testing.assert_allclose(hg.accuracy, hw.accuracy, atol=1e-4)
    for scheme, (mean, std) in bands.items():
        np.testing.assert_array_equal(got["bands"][scheme][0], mean)
        np.testing.assert_array_equal(got["bands"][scheme][1], std)


def test_new_modules_import_neither_jax_nor_repro():
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "import repro_torch.core.run_state, repro_torch.checkpoint.io\n"
        "import repro_torch.launch.quickstart, repro_torch.api\n"
        "import repro_torch.core.load_allocation\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root, timeout=120)
