"""The port's training path for the recurrent families (rwkv6-1.6b,
jamba-1.5-large-398b) and their two scans under autograd, against the
JAX reference, on the CPU.

Weights come from the reference's ``init_params`` and are carried over
with ``repro_torch.carry.model_params_from_reference``; batches are
``make_batch``'s, activations made with NumPy from a seed.  Smoke-variant
configs in float32.  Tolerances:

  * ``loss_fn``: 1e-5 relative; each gradient leaf of
    ``jax.value_and_grad`` within 1e-5 of its largest |g| (float32 sums
    and cumulative sums in another order through 2 layers and the head);
    ``remat`` changes no bit; ``hidden_states`` 1e-5;
  * ``wkv_chunked`` and ``_ssm_chunked`` under autograd: the output, the
    state and each input's gradient within 1e-5 of the largest magnitude
    against the reference's same form, 1e-4 against the port's
    sequential form (the two forms round differently, in the reference
    too).

Both recurrent families take their chunked forms in training where the
reference's rule does (rwkv6 at S % 64 == 0, jamba at S % 128 == 0) and
the sequential ones elsewhere; each is held at one length of each kind.
jamba's chunked case feeds uniform random tokens: on ``make_batch``'s
tokens at 128 positions the reference's chunked scan overflows float32
even at the smoke width (ROADMAP F4), in both packages, which
`test_jamba_chunked_training_overflows_as_the_reference` holds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm_mamba as ref_mamba
from repro.models import ssm_rwkv as ref_rwkv

from repro_torch.models import ssm_mamba, ssm_rwkv
from torch_zoo import TrainCase, assert_leaves_close, normal

TOL = 1e-5
FORM_TOL = 1e-4
JAMBA = "jamba-1.5-large-398b"
# (arch, S, uniform tokens): the chunked form and the sequential one;
# jamba's chunked case is held apart (test_jamba_chunked_gradient_...)
CASES = [("rwkv6-1.6b", 64, False), ("rwkv6-1.6b", 40, False),
         (JAMBA, 40, False)]
JAMBA_CHUNKED = (JAMBA, 128, True)


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


def _case(cases, arch, S, uniform, chunked=True) -> TrainCase:
    if (arch, S, chunked) not in cases:
        tokens = (np.random.default_rng(0).integers(0, 512, (2, S),
                                                    dtype=np.int32)
                  if uniform else None)
        cases[arch, S, chunked] = TrainCase(arch, S=S, tokens=tokens,
                                            chunked=chunked)
    return cases[arch, S, chunked]


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               rtol=0)


# ------------------------------------------------------------------ loss_fn
@pytest.mark.parametrize("arch,S,uniform", CASES)
def test_loss_and_every_grad_leaf_match(cases, arch, S, uniform):
    case = _case(cases, arch, S, uniform)
    assert np.isfinite(case.loss)
    case.check_loss_and_grads()


@pytest.mark.parametrize("arch,S,uniform", [CASES[0], JAMBA_CHUNKED])
def test_remat_changes_no_bit(cases, arch, S, uniform):
    """The layer recomputed in the backward starts from a zero state of
    its own (and, for jamba, recomputes its checkpointed chunks)."""
    _case(cases, arch, S, uniform).check_remat_changes_no_bit()


@pytest.mark.parametrize("arch,S,uniform", [CASES[0], JAMBA_CHUNKED])
def test_hidden_states_match(cases, arch, S, uniform):
    _case(cases, arch, S, uniform).check_hidden_states()


def test_jamba_chunked_gradient_matches_the_sequential_reference(cases):
    """jamba at 128 positions, the chunked scan under autograd (its chunks
    recomputed in the backward): the loss within 1e-5 of the reference's
    chunked loss, and every gradient leaf within 1e-5 of the reference's
    gradient through its sequential scan (chunked=False), the same
    function.  The reference's own chunked gradient is held to the
    sequential one too and is off it (ROADMAP F5): its float32 backward
    of exp(cum) (h + cumsum(exp(-cum) i)) loses the Mamba leaves
    (A_log, dt_proj) to rounding where cum nears -77, as here (0.18 of
    A_log's largest |g| on this batch; held against a float64 evaluation
    of the same chunk, the port's float32 gradient is within 3e-7 and the
    reference's 1.1e-2), so it is not the port's target."""
    chunked = _case(cases, *JAMBA_CHUNKED)
    seq = _case(cases, *JAMBA_CHUNKED, chunked=False)
    assert np.isfinite(chunked.loss)
    loss, grads = chunked.port_loss_and_grads()
    assert abs(float(loss) - chunked.loss) <= TOL * chunked.loss
    assert abs(seq.loss - chunked.loss) <= TOL * chunked.loss
    assert_leaves_close(grads, seq.grads)
    off = max(float(np.abs(chunked.grads[k] - seq.grads[k]).max())
              / float(np.abs(seq.grads[k]).max()) for k in seq.grads)
    assert off > 1e-2


def test_jamba_chunked_training_overflows_as_the_reference():
    """ROADMAP F4 in training: on make_batch's tokens at 128 positions the
    chunked scan's exp(-cumulative log decay) overflows float32 (the
    cumulative log decay of a chunk reaches about -170 here): the loss is
    NaN in both packages.  The sequential form on the same batch
    (chunked=False) is finite, and the port's equals the reference's."""
    case = TrainCase(JAMBA, S=128)
    assert np.isnan(case.loss)
    loss, _ = case.port_loss_and_grads()
    assert torch.isnan(loss)
    TrainCase(JAMBA, S=128, chunked=False).check_loss_and_grads()


# ------------------------------------------------------------------ the scans
def _rwkv_inputs(B=2, S=128, H=4, hs=16, seed=0):
    r, k, v = (normal((B, S, H, hs), seed + i, 0.5) for i in range(3))
    w = np.exp(-np.exp(normal((B, S, H, hs), seed + 3, 0.5) - 2.0))
    u = normal((H, hs), seed + 4, 0.3)
    state = normal((B, H, hs, hs), seed + 5, 0.1)
    return r, k, v, w.astype(np.float32), u, state


def _ssm_inputs(B=2, S=128, din=24, N=16, seed=0):
    u = normal((B, S, din), seed)
    dt = np.log1p(np.exp(normal((B, S, din), seed + 1) - 4.0)).astype(
        np.float32)
    b_t, c_t = normal((B, S, N), seed + 2), normal((B, S, N), seed + 3)
    A = -np.tile(np.arange(1, N + 1, dtype=np.float32), (din, 1))
    D = normal((din,), seed + 4)
    h0 = normal((B, din, N), seed + 5, 0.1)
    return u, dt, b_t, c_t, A, D, h0


def _weights(shapes, seed):
    """Fixed cotangents: the scalar sum(out * R) + sum(state * Q)."""
    return [normal(s, seed + i) for i, s in enumerate(shapes)]


def _ref_value_and_grads(fn, args, cot):
    def f(*a):
        outs = fn(*a)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), outs
    (_, outs), grads = jax.value_and_grad(
        f, argnums=tuple(range(len(args))), has_aux=True)(
        *map(jnp.asarray, args))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _port_value_and_grads(fn, args, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    outs = fn(*ts)
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot)).backward()
    return ([o.detach().numpy() for o in outs],
            [t.grad.numpy() for t in ts])


@pytest.mark.parametrize("S", [64, 128])
def test_wkv_chunked_under_autograd(S):
    """wkv_chunked's output, state and the gradients of r, k, v, w, u and
    the initial state: against the reference's chunked form, and against
    the port's per-token wkv_naive."""
    args = _rwkv_inputs(S=S)
    cot = _weights([args[0].shape, args[5].shape], 10)
    want_o, want_g = _ref_value_and_grads(ref_rwkv.wkv_chunked, args, cot)
    got_o, got_g = _port_value_and_grads(ssm_rwkv.wkv_chunked, args, cot)
    nai_o, nai_g = _port_value_and_grads(ssm_rwkv.wkv_naive, args, cot)
    for got, want, naive in zip(got_o + got_g, want_o + want_g,
                                nai_o + nai_g):
        _close(got, want)
        _close(got, naive, FORM_TOL)


@pytest.mark.parametrize("S", [128, 256])
def test_ssm_chunked_under_autograd(S):
    """_ssm_chunked (its chunks recomputed in the backward): y, the last
    state and the gradients of u, dt, B, C, A, D and h0, against the
    reference's chunked form and the port's sequential _ssm_scan."""
    args = _ssm_inputs(S=S)
    cot = _weights([args[0].shape, args[6].shape], 20)
    want_o, want_g = _ref_value_and_grads(ref_mamba._ssm_chunked, args, cot)
    got_o, got_g = _port_value_and_grads(ssm_mamba._ssm_chunked, args, cot)
    seq_o, seq_g = _port_value_and_grads(ssm_mamba._ssm_scan, args, cot)
    for got, want, seq in zip(got_o + got_g, want_o + want_g, seq_o + seq_g):
        _close(got, want)
        _close(got, seq, FORM_TOL)


def _saved_bytes(fn, args) -> int:
    """Bytes of the tensors autograd saves for the backward of fn(*args),
    counted where they are packed."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    ts = [torch.tensor(a, requires_grad=True) for a in args]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*ts)
    return total[0]


def test_ssm_chunked_keeps_no_chunk_blocks_for_the_backward():
    """Under autograd _ssm_chunked saves its chunks' inputs, not their
    (B, C, din, N) blocks: at 2 chunks and at 4, at most twice the bytes
    of the (B, S, din) and (B, S, N) projections it is given (u, dt, B,
    C), and under one block a chunk; the same chunks run without the
    recompute save more than two blocks a chunk."""
    C = 128
    for S in (2 * C, 4 * C):
        args = _ssm_inputs(S=S)
        n = S // C
        B, _, din = args[0].shape
        block = B * C * din * args[2].shape[-1] * 4
        proj = sum(a.nbytes for a in args[:4])
        saved = _saved_bytes(ssm_mamba._ssm_chunked, args)
        assert saved <= 2 * proj and saved < n * block, (S, saved, proj)

    def unchecked(u, dt, b, c, A, D, h0):
        h, ys = h0, []
        for c0 in range(0, u.shape[1], C):
            h, y = ssm_mamba._ssm_chunk(h, u[:, c0:c0 + C], dt[:, c0:c0 + C],
                                        b[:, c0:c0 + C], c[:, c0:c0 + C], A)
            ys.append(y)
        return torch.cat(ys, dim=1) + u * D, h

    assert _saved_bytes(unchecked, args) > n * 2 * block
