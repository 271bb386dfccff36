"""The port's kernels: plain versions against the Pallas reference, and the
CUDA kernels against the plain versions on the card.

On the CPU each plain PyTorch version (``repro_torch.kernels.ref``, which
``repro_torch.kernels.ops`` runs for CPU tensors) is held against the
reference's Pallas kernel run as ``tests/test_kernels.py`` runs it: through
``repro.kernels.ops`` with ``use_pallas=True, interpret=True``.  Inputs are
made with NumPy from a seed; shapes are odd so that no dimension is a
multiple of a tile.  Tolerance: rtol = atol = 1e-5, float32 sums of at most
~130 terms taken in another order.

The ``cuda``-marked tests compare each CUDA kernel with its plain version
on the card, at shapes one below, at and one above each tile multiple of
the kernel.  They skip where there is no card.
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops

from repro_torch.kernels import build, ops, ref

RTOL = ATOL = 1e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _rff_inputs(m, d, q, seed=0):
    x = np.random.default_rng(seed).uniform(0, 1, (m, d)).astype(np.float32)
    omega = _np((d, q), seed + 1, 0.3)
    delta = np.random.default_rng(seed + 2).uniform(
        0, 2 * np.pi, q).astype(np.float32)
    return x, omega, delta


def _grad_inputs(n, L, q, c, seed=0):
    x = _np((n, L, q), seed, 0.3)
    theta = _np((q, c), seed + 1, 0.3)
    y = _np((n, L, c), seed + 2)
    mask = np.random.default_rng(seed + 3).uniform(0, 1, (n, L))
    mask = np.where(mask < 0.3, 0.0, mask).astype(np.float32)
    return x, theta, y, mask


def _parity_inputs(n, u, l, q, seed=0):
    g = _np((n, u, l), seed)
    w = np.random.default_rng(seed + 1).uniform(0.2, 1.0, (n, l)).astype(
        np.float32)
    x = _np((n, l, q), seed + 2, 0.5)
    return g, w, x


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("m,d,q", [(37, 19, 45), (130, 70, 129)])
def test_rff_embed_plain_matches_pallas(m, d, q):
    x, omega, delta = _rff_inputs(m, d, q)
    want = ref_ops.rff_embed(x, omega, delta, use_pallas=True,
                             interpret=True)
    got = ops.rff_embed(*_t(x, omega, delta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,L,q,c", [(3, 37, 45, 3), (2, 130, 70, 10)])
def test_linreg_grad_masked_plain_matches_pallas(n, L, q, c):
    x, theta, y, mask = _grad_inputs(n, L, q, c)
    want = ref_ops.linreg_grad_masked(x, theta, y, mask, use_pallas=True,
                                      interpret=True)
    got = ops.linreg_grad_masked(*_t(x, theta, y, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,u,l,q", [(3, 13, 20, 24), (2, 65, 33, 129)])
def test_parity_encode_batched_plain_matches_pallas(n, u, l, q):
    g, w, x = _parity_inputs(n, u, l, q)
    want = ref_ops.parity_encode_batched(g, w, x, use_pallas=True,
                                         interpret=True)
    got = ops.parity_encode_batched(*_t(g, w, x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cpu_calls_take_the_plain_path_and_count_nothing():
    ops.reset_launch_counts()
    x, theta, y, mask = _t(*_grad_inputs(2, 5, 6, 2))
    torch.testing.assert_close(ops.linreg_grad_masked(x, theta, y, mask),
                               ref.linreg_grad_masked(x, theta, y, mask),
                               rtol=0, atol=0)
    assert ops.LAUNCHES == {"rff_embed": 0, "parity_encode_batched": 0,
                            "linreg_grad_masked": 0}


def test_wrapper_refuses_other_devices():
    x, omega, delta = (t.to("meta") for t in _t(*_rff_inputs(4, 3, 5)))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rff_embed(x, omega, delta)
    cpu = _t(*_rff_inputs(4, 3, 5))
    with pytest.raises(ValueError, match="several devices"):
        ops.rff_embed(cpu[0], cpu[1], delta)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _max_rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1.0)


# tile multiples: the GEMM tile is 64 x 64 over K steps of 16; the
# masked-gradient kernel tiles q by 128, L by 64 and c by 16
@pytest.mark.cuda
@pytest.mark.parametrize("m,d,q", [(63, 15, 63), (64, 16, 64), (65, 17, 65),
                                   (129, 784, 127)])
def test_rff_embed_kernel_matches_plain(cuda, m, d, q):
    args = _t(*_rff_inputs(m, d, q), device=cuda)
    got = ops.rff_embed(*args)
    torch.cuda.synchronize()
    assert _max_rel_err(got, ref.rff_embed(*args)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,q,c", [(2, 63, 127, 15), (3, 64, 128, 16),
                                     (2, 65, 129, 17), (31, 130, 200, 10)])
def test_linreg_grad_masked_kernel_matches_plain(cuda, n, L, q, c):
    args = _t(*_grad_inputs(n, L, q, c), device=cuda)
    got = ops.linreg_grad_masked(*args)
    torch.cuda.synchronize()
    assert _max_rel_err(got, ref.linreg_grad_masked(*args)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,u,l,q", [(2, 63, 15, 63), (2, 64, 16, 64),
                                     (3, 65, 17, 65), (4, 200, 40, 10)])
def test_parity_encode_batched_kernel_matches_plain(cuda, n, u, l, q):
    args = _t(*_parity_inputs(n, u, l, q), device=cuda)
    got = ops.parity_encode_batched(*args)
    torch.cuda.synchronize()
    assert _max_rel_err(got, ref.parity_encode_batched(*args)) < 1e-5


@pytest.mark.cuda
def test_kernel_launches_are_counted(cuda):
    ops.reset_launch_counts()
    ops.rff_embed(*_t(*_rff_inputs(8, 4, 8), device=cuda))
    ops.parity_encode_batched(*_t(*_parity_inputs(2, 4, 3, 5), device=cuda))
    ops.linreg_grad_masked(*_t(*_grad_inputs(2, 5, 6, 2), device=cuda))
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"rff_embed": 1, "parity_encode_batched": 1,
                            "linreg_grad_masked": 1}
