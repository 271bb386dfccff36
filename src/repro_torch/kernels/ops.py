"""Public wrappers of the port's kernels: dispatch by device, count launches.

Each wrapper takes the layout of the function of the same name in
``repro.kernels.ops``.  For tensors on the CPU it runs the plain PyTorch
version (``repro_torch.kernels.ref``).  For CUDA tensors it checks device,
dtype, shape and contiguity, allocates the outputs with ``torch.empty``,
launches the hand-written CUDA kernel on the current stream and raises if
the launch fails; there is no fallback.  Any other device raises.

The TPU padding rules of the reference (128-lane padding, block clamping)
do not carry over: the CUDA kernels mask their ragged edges themselves.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched the CUDA
kernel (a ``linreg_grad_masked`` call is one launch of that kernel, though
it runs as two CUDA grids).  CPU calls are not counted.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"rff_embed": 0, "parity_encode_batched": 0,
            "linreg_grad_masked": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _on_cuda(name: str, *tensors) -> bool:
    """False for all-CPU inputs (plain path); True for CUDA inputs that the
    kernel takes; raises for anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    (device,) = devices
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")
    return True


def _check_shape(name: str, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if min(shape) < 1:
        raise ValueError(f"{name}: empty dimension in {tuple(shape)}")


def _launch(name: str, lib: str, device, *args) -> None:
    fn = build.kernel(lib)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES[name] += 1


def rff_embed(x, omega, delta, q_true: int | None = None):
    """sqrt(2/q_true) cos(x @ omega + delta): (m, d), (d, q), (q,) -> (m, q)."""
    if not _on_cuda("rff_embed", x, omega, delta):
        return ref.rff_embed(x, omega, delta, q_true)
    (m, d), q = x.shape, omega.shape[1]
    _check_shape("rff_embed", x, (m, d))
    _check_shape("rff_embed", omega, (d, q))
    _check_shape("rff_embed", delta, (q,))
    q_true = q if q_true is None else int(q_true)
    if q_true <= 0:
        raise ValueError(f"rff_embed: q_true must be positive, got {q_true}")
    out = torch.empty((m, q), dtype=torch.float32, device=x.device)
    _launch("rff_embed", "rff_embed", x.device, x.data_ptr(),
            omega.data_ptr(), delta.data_ptr(), out.data_ptr(), m, d, q,
            q_true)
    return out


def parity_encode_batched(g, w, x):
    """G_b diag(w_b) X_b: (n, u, l), (n, l), (n, l, q) -> (n, u, q)."""
    if not _on_cuda("parity_encode_batched", g, w, x):
        return ref.parity_encode_batched(g, w, x)
    (n, u, l), q = g.shape, x.shape[2]
    _check_shape("parity_encode_batched", g, (n, u, l))
    _check_shape("parity_encode_batched", w, (n, l))
    _check_shape("parity_encode_batched", x, (n, l, q))
    out = torch.empty((n, u, q), dtype=torch.float32, device=g.device)
    _launch("parity_encode_batched", "parity_encode", g.device, g.data_ptr(),
            w.data_ptr(), x.data_ptr(), out.data_ptr(), n, u, l, q)
    return out


def linreg_grad_masked(x, theta, y, mask):
    """X_b^T diag(mask_b) (X_b theta - Y_b):
    (n, L, q), (q, c), (n, L, c), (n, L) -> (n, q, c)."""
    if not _on_cuda("linreg_grad_masked", x, theta, y, mask):
        return ref.linreg_grad_masked(x, theta, y, mask)
    (n, L, q), c = x.shape, theta.shape[1]
    _check_shape("linreg_grad_masked", x, (n, L, q))
    _check_shape("linreg_grad_masked", theta, (q, c))
    _check_shape("linreg_grad_masked", y, (n, L, c))
    _check_shape("linreg_grad_masked", mask, (n, L))
    # the residual warps read theta along q: hand it over as (c, q)
    theta_t = theta.t().contiguous()
    r = torch.empty((n, L, c), dtype=torch.float32, device=x.device)
    g = torch.empty((n, q, c), dtype=torch.float32, device=x.device)
    _launch("linreg_grad_masked", "linreg_grad", x.device, x.data_ptr(),
            theta_t.data_ptr(), y.data_ptr(), mask.data_ptr(), r.data_ptr(),
            g.data_ptr(), n, L, q, c)
    return g
