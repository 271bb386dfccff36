"""Public wrappers of the port's kernels: dispatch by device, count launches.

Each wrapper takes the layout of the function of the same name in
``repro.kernels.ops``.  For tensors on the CPU it runs the plain PyTorch
version (``repro_torch.kernels.ref``), and so does ``gqa_decode`` for
tensors on the ``meta`` device (the compile driver traces decode steps
there).  For CUDA tensors it checks device,
dtype, shape and contiguity, allocates the outputs with ``torch.empty``,
launches the hand-written CUDA kernel on the current stream and raises if
the launch fails; there is no fallback.  Any other device raises.

The TPU padding rules of the reference (128-lane padding, block clamping,
the zero dummy row and zero parity block of ``rff_linreg_grad_masked``, the
KV cache padded to a multiple of ``bt`` in ``gqa_decode``) do not carry
over: the CUDA kernels mask their ragged edges themselves.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched the CUDA
kernel (a ``linreg_grad_masked`` call is one launch of that kernel, though
it runs as two CUDA grids, the second summing its row segments;
``linreg_grad_batched`` is a launch of ``linreg_grad_masked`` without a
mask, ``rff_embed_batched`` one of ``rff_embed``).  ``PREPARES`` counts the
operand copies a kernel keeps, made on the card: ``prepare_rff_operands``'
split X and Omega^T for ``rff_linreg_grad_masked``, once per deployment on
the main path, once per call where the caller passes none.  CPU calls are not
counted.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

LAUNCHES = {"rff_embed": 0, "parity_encode_batched": 0,
            "linreg_grad_masked": 0, "rff_linreg_grad_masked": 0,
            "linreg_grad": 0, "parity_encode": 0, "gqa_decode": 0}
PREPARES = {"rff_linreg_grad_masked": 0}

_FUSED_SYMBOLS = {torch.float32: "rff_linreg_grad_masked_f32",
                  torch.bfloat16: "rff_linreg_grad_masked_bf16"}
_GQA_SYMBOLS = {torch.float32: "gqa_decode_f32",
                torch.bfloat16: "gqa_decode_bf16"}
# the float32 tensor-core tile of rff_embed and parity_encode(_batched)
# (csrc/tc_gemm_f32.cuh): output rows and columns of a block, K a stage
TC_TILE_M = 128
TC_TILE_N = 128
TC_TILE_K = 16
# gqa_decode (csrc/gqa_decode.cu): cache slots a tile (kTile), the widths
# it takes, and the blocks an SM holds at once in bf16 at hd = 128 (its
# 61.1 KB of shared memory), one wave of which its plan fills
GQA_TILE = 32
GQA_MAX_GROUP = 16
GQA_MAX_HEAD_DIM = 256
GQA_BLOCKS_PER_SM = 3

# linreg_grad (csrc/linreg_grad.cu): q columns per block of the X^T r pass,
# the fewest rows one L split walks, and q columns per partial residual
LG_COLS = 128
LG_MIN_ROWS = 32
LG_QB = 512
# linreg_grad_masked (csrc/linreg_grad.cu): threads per block (a q part is
# 4 * MK_THREADS * J columns, J = 1 or 2), rows per slab, and rows per slab
# where 8-row slabs do not fit beside theta
MK_THREADS = 256
MK_ROWS = 8
MK_ROWS_WIDE = 4
# the fused kernel's layout (csrc/rff_linreg_grad.cu): the pieces a CTA's
# columns come in, CTAs of a cluster, slab heights, a stage of the copy ring
# (64 bytes of K of the big and small parts of 128 rows of X and of a
# 128-row tile of Omega^T) and the most stages, the label columns per pass,
# and the shared memory of a block and of an SM
FUSED_PIECE = 256
FUSED_MAX_CLUSTER = 8
FUSED_SLAB_ROWS = (112, 64, 32, 16)
FUSED_STAGE_BYTES = 32768
FUSED_MAX_STAGES = 3
FUSED_CMAX = 16
FUSED_MAX_SMEM = 232448
SM_SMEM = 233472


def reset_launch_counts() -> None:
    """Zero ``LAUNCHES`` and ``PREPARES``."""
    for counts in (LAUNCHES, PREPARES):
        for name in counts:
            counts[name] = 0


def _on_cuda(name: str, *tensors, dtype=torch.float32,
             meta: bool = False) -> bool:
    """False for all-CPU inputs (plain path), and with `meta` for inputs
    on the ``meta`` device (shapes only: the plain path computes the
    output's shape); True for CUDA inputs that the kernel takes; raises for
    anything else.  ``dtype=None`` leaves the dtype check to the caller."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: inputs on several devices {devices}")
    (device,) = devices
    if device.type == "cpu" or (meta and device.type == "meta"):
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    for t in tensors:
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name}: kernel takes {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel takes contiguous tensors")
    return True


def _check_shape(name: str, t, shape) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if min(shape) < 1:
        raise ValueError(f"{name}: empty dimension in {tuple(shape)}")


def _launch(name: str, symbol: str, device, *args) -> None:
    fn = build.kernel(symbol)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES[name] += 1


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _resident_clusters(index: int, bf16: int, slab_rows: int, cluster: int,
                       cols_per_cta: int, stages: int) -> int:
    """Clusters of the fused kernel's shape that device `index` holds at
    once (cudaOccupancyMaxActiveClusters)."""
    with torch.cuda.device(index):
        n = build.kernel("rff_linreg_grad_max_clusters")(
            bf16, slab_rows, cluster, cols_per_cta, stages)
    if n < 0:
        raise RuntimeError("rff_linreg_grad_masked: occupancy query failed "
                           f"with cudaError_t {-n}")
    return n


def linreg_grad_splits(m: int, q: int, n_sm: int) -> int:
    """L splits of ``linreg_grad``'s X^T r pass: enough (q tile, split)
    blocks for four per SM, each split at least LG_MIN_ROWS rows."""
    q_tiles = -(-q // LG_COLS)
    return max(1, min(-(-4 * n_sm // q_tiles), -(-m // LG_MIN_ROWS)))


class FusedPlan(NamedTuple):
    """Launch plan of the fused kernel: rows of phi per slab, CTAs per
    cluster, columns of q per CTA, the groups of slabs (one cluster each)
    of a raw row and of the parity row, and the stages of the copy ring."""
    slab_rows: int
    cluster: int
    cols_per_cta: int
    groups_raw: int
    groups_par: int
    stages: int


def fused_smem_bytes(slab_rows: int, cols_per_cta: int, stages: int) -> int:
    """A CTA's shared memory: the copy ring, the residual (slab_rows, 16),
    its (slab_rows, cols_per_cta + 4) part of phi, all float32, and two
    mbarriers a stage."""
    return (stages * FUSED_STAGE_BYTES + slab_rows * FUSED_CMAX * 4
            + slab_rows * (cols_per_cta + 4) * 4 + 16 * stages)


def fused_stages(slab_rows: int, cols_per_cta: int) -> int:
    """Stages of the copy ring that fit beside phi, at most
    FUSED_MAX_STAGES; 0 where none fits or the ring cannot hold the
    residual's theta piece, quarter sums and partial, which reuse it."""
    room = FUSED_MAX_SMEM - fused_smem_bytes(slab_rows, cols_per_cta, 0)
    stages = min(FUSED_MAX_STAGES, room // (FUSED_STAGE_BYTES + 16))
    need = (FUSED_PIECE + 5 * slab_rows) * FUSED_CMAX * 4
    return stages if stages >= 1 and stages * FUSED_STAGE_BYTES >= need \
        else 0


def fused_max_q() -> int:
    """The widest q the fused kernel takes: 8 CTAs of the most columns
    whose 16-row slab of phi fits a block's shared memory beside a stage."""
    rows, cols = FUSED_SLAB_ROWS[-1], FUSED_PIECE
    while fused_stages(rows, cols + FUSED_PIECE):
        cols += FUSED_PIECE
    return FUSED_MAX_CLUSTER * cols


def fused_plan(q: int, n_real: int, live: tuple, resident) -> FusedPlan:
    """Split q over a cluster of up to 8 CTAs in whole 256-column tiles and
    take the tallest slab whose phi fits a CTA's shared memory beside a
    ring of at least one stage.  Then cut the slabs of every row into
    groups (one cluster each) of at most `chain` slabs: all slabs over the
    clusters the card holds at once, ``resident(slab_rows, cluster,
    cols_per_cta, stages)``.  The parity row's slabs embed nothing, so they
    cost a fraction of a raw slab: they run after the raw clusters, spread
    over as many clusters as the card holds.  ``live`` = (raw,) or (raw,
    parity) live row counts.  Raises ValueError past ``fused_max_q()``."""
    cluster = min(FUSED_MAX_CLUSTER, -(-q // FUSED_PIECE))
    cols = -(-(-(-q // cluster)) // FUSED_PIECE) * FUSED_PIECE
    cluster = -(-q // cols)
    for slab in FUSED_SLAB_ROWS:
        stages = fused_stages(slab, cols)
        if stages:
            break
    else:
        raise ValueError(
            f"rff_linreg_grad_masked: q = {q} is wider than the fused "
            f"kernel takes ({fused_max_q()}: {FUSED_MAX_CLUSTER} CTAs of a "
            f"cluster, each holding a {FUSED_SLAB_ROWS[-1]}-row slab of phi "
            f"in {FUSED_MAX_SMEM} bytes of shared memory)")
    slabs = [max(1, -(-n // slab)) for n in live] + [1]
    total = n_real * slabs[0] + sum(slabs[1:-1])
    at_once = max(1, resident(slab, cluster, cols, stages))
    chain = -(-total // at_once)
    chain_par = -(-slabs[1] // at_once)
    return FusedPlan(slab, cluster, cols, -(-slabs[0] // chain),
                     -(-slabs[1] // chain_par), stages)


def _tma_width(d: int, dtype) -> int:
    """d rounded up to whole 16-byte rows of `dtype`, as TMA copies them."""
    per = 16 // dtype.itemsize
    return -(-d // per) * per


def tf32_round(v):
    """float32 `v` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    the nearest value with 10 fraction bits, ties away from zero (past the
    largest finite value, to infinity); NaN stays NaN."""
    bits = v.contiguous().view(torch.int32)
    nan = torch.isnan(v)
    mag = torch.where(nan, 0, bits & 0x7FFFFFFF)
    out = ((mag + 0x1000) & -0x2000) | (bits & -0x80000000)
    return torch.where(nan, v, out.view(torch.float32))


def tf32_split(v):
    """(big, small) of float32 `v` as ``split_tf32`` in csrc/mma_sm90.cuh
    splits it: big = tf32_round(v), small = tf32_round(v - big)."""
    big = tf32_round(v)
    return big, tf32_round(v - big)


class FusedOperands(NamedTuple):
    """X (n, l, d) and Omega (d, q) prepared for the fused kernel: X and
    Omega^T (q, d), d padded with zero columns to whole 16-byte rows; in
    float32 the big and small TF32 parts of each (``tf32_split``), in
    bfloat16 the values themselves (the small parts None)."""
    x_big: torch.Tensor
    x_small: torch.Tensor | None
    omega_big: torch.Tensor
    omega_small: torch.Tensor | None


def prepare_rff_operands(x_raw, omega) -> FusedOperands:
    """The copies of X and Omega that ``rff_linreg_grad_masked`` reads on
    the card (``FusedOperands``): made once where both are fixed (a
    deployment's ``build_consts``) and passed as ``prepared``.  Counted in
    ``PREPARES`` on the card."""
    (n, l, d), q = x_raw.shape, omega.shape[1]
    width = _tma_width(d, omega.dtype)
    x = torch.zeros((n, l, width), dtype=x_raw.dtype, device=x_raw.device)
    x[..., :d] = x_raw
    om = torch.zeros((q, width), dtype=omega.dtype, device=omega.device)
    om[:, :d] = omega.t()
    if omega.is_cuda:
        PREPARES["rff_linreg_grad_masked"] += 1
    if omega.dtype == torch.bfloat16:
        return FusedOperands(x, None, om, None)
    return FusedOperands(*tf32_split(x), *tf32_split(om))


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
    _launch("rff_embed", "rff_embed_f32", x.device, x.data_ptr(),
            omega.data_ptr(), delta.data_ptr(), out.data_ptr(), m, d, q,
            q_true)
    return out


def rff_embed_batched(x_stack, omega, delta):
    """RFF embedding over a client axis: (n, l, d), (d, q), (q,) ->
    (n, l, q), one ``rff_embed`` launch over the flattened client axis."""
    n, l, d = x_stack.shape
    flat = rff_embed(x_stack.reshape(n * l, d), omega, delta)
    return flat.reshape(n, l, omega.shape[1])


def parity_encode(g, w, x):
    """G diag(w) X of one client: (u, l), (l,), (l, q) -> (u, q)."""
    if not _on_cuda("parity_encode", g, w, x):
        return ref.parity_encode(g, w, x)
    (u, l), q = g.shape, x.shape[1]
    _check_shape("parity_encode", g, (u, l))
    _check_shape("parity_encode", w, (l,))
    _check_shape("parity_encode", x, (l, q))
    out = torch.empty((u, q), dtype=torch.float32, device=g.device)
    _launch("parity_encode", "parity_encode_f32", g.device, g.data_ptr(),
            w.data_ptr(), x.data_ptr(), out.data_ptr(), u, l, q)
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
    _launch("parity_encode_batched", "parity_encode_batched_f32", g.device,
            g.data_ptr(), w.data_ptr(), x.data_ptr(), out.data_ptr(), n, u,
            l, q)
    return out


def linreg_grad(x, theta, y):
    """X^T (X theta - Y): (m, q), (q, c), (m, c) -> (q, c)."""
    if not _on_cuda("linreg_grad", x, theta, y):
        return ref.linreg_grad(x, theta, y)
    (m, q), c = x.shape, theta.shape[1]
    _check_shape("linreg_grad", x, (m, q))
    _check_shape("linreg_grad", theta, (q, c))
    _check_shape("linreg_grad", y, (m, c))
    f32 = dict(dtype=torch.float32, device=x.device)
    splits = linreg_grad_splits(m, q, _sm_count(x.device.index or 0))
    r = torch.empty((-(-q // LG_QB), m, c), **f32)
    part = torch.empty((splits, q, c), **f32) if splits > 1 else None
    g = torch.empty((q, c), **f32)
    _launch("linreg_grad", "linreg_grad_f32", x.device, x.data_ptr(),
            theta.data_ptr(), y.data_ptr(), r.data_ptr(), _ptr(part),
            g.data_ptr(), m, q, c, splits)
    return g


def masked_parts(q: int) -> int:
    """q parts of ``linreg_grad_masked``: one while q <= 2048 (J = 1 up to
    1024 columns, J = 2 up to 2048), each a block of its own past that."""
    j = 1 if q <= 4 * MK_THREADS else 2
    return -(-q // (4 * MK_THREADS * j))


def masked_slab_rows(q: int, c: int) -> int:
    """Rows per slab of ``linreg_grad_masked`` (mk_rows in the source): 8,
    or 4 with 2048-column parts (q > 1024) and more than 10 label columns
    a pass (c rounded up to even, at most 16)."""
    nc = min(c, 16) + min(c, 16) % 2
    return MK_ROWS_WIDE if q > 4 * MK_THREADS and nc > 10 else MK_ROWS


@functools.lru_cache(maxsize=256)
def masked_plan(n: int, q: int, c: int, live: tuple, n_sm: int) -> tuple:
    """(chain, blocks): the slabs of every row in row order (``live[0]``
    live rows for each row b < n - 1, ``live[1]`` for row n - 1) cut into
    chains of equal length, one block each per (q part, 16-wide c chunk),
    as many as fill one wave of one block an SM."""
    places = max(1, n_sm // (masked_parts(q) * -(-c // 16)))
    rows = masked_slab_rows(q, c)
    total = (n - 1) * -(-live[0] // rows) + -(-live[1] // rows)
    chain = -(-total // places)
    return chain, -(-total // chain)


def _masked_live(name: str, L: int, live_rows) -> tuple:
    live = (L, L) if live_rows is None else tuple(int(v) for v in live_rows)
    if len(live) != 2 or not all(1 <= v <= L for v in live):
        raise ValueError(f"{name}: live_rows must be two counts in [1, {L}],"
                         f" got {live_rows}")
    return live


def _masked_gradients(x, theta, y, mask, live):
    """One ``linreg_grad_masked_f32`` launch over the live rows (the kernel
    and a combine of its row segments); ``mask=None`` weighs every row 1
    without a tensor of ones."""
    name = "linreg_grad_masked"
    (n, L, q), c = x.shape, theta.shape[1]
    _check_shape(name, x, (n, L, q))
    _check_shape(name, theta, (q, c))
    _check_shape(name, y, (n, L, c))
    if mask is not None:
        _check_shape(name, mask, (n, L))
    # the kernel reads theta along q: hand it over as (c, q)
    theta_t = theta.t().contiguous()
    chain, blocks = masked_plan(n, q, c, live,
                                _sm_count(x.device.index or 0))
    f32 = dict(dtype=torch.float32, device=x.device)
    # a block's sum for each row its chain meets: at most blocks + n
    part = torch.empty((blocks + n, q, c), **f32)
    g = torch.empty((n, q, c), **f32)
    _launch(name, "linreg_grad_masked_f32", x.device, x.data_ptr(),
            theta_t.data_ptr(), y.data_ptr(), _ptr(mask), part.data_ptr(),
            g.data_ptr(), n, L, q, c, *live, chain)
    return g


def linreg_grad_masked(x, theta, y, mask, *, live_rows=None):
    """X_b^T diag(mask_b) (X_b theta - Y_b):
    (n, L, q), (q, c), (n, L, c), (n, L) -> (n, q, c).

    ``live_rows`` = (clients, last_row) is the number of leading rows that
    may be non-zero: ``clients`` for each row b < n - 1, ``last_row`` for
    row n - 1 (the fused coded round's parity pseudo-row), each in [1, L].
    Default: every row.  The contract is the fused kernel's
    (``rff_linreg_grad_masked``): past its count a row holds x = 0, y = 0
    and mask = 0, as ``aggregation.fused_client_parity_tensors`` writes its
    padding.  The kernel does not read those rows, and the result is the
    same: a padding row's term x^T (mask (x theta - y)) is 0 * (finite) =
    +0 for finite theta.  Where theta is not finite, row 0 of the same row
    b (always live) is already NaN or infinite, so g_b is not finite either
    way.  Rows with mask 0 inside the live range are computed, so a NaN
    feature there propagates as in the reference.
    """
    name = "linreg_grad_masked"
    live = _masked_live(name, x.shape[1], live_rows)
    if not _on_cuda(name, x, theta, y, mask):
        return ref.linreg_grad_masked(x, theta, y, mask, live_rows=live_rows)
    return _masked_gradients(x, theta, y, mask, live)


def linreg_grad_batched(x, theta, y):
    """X_b^T (X_b theta - Y_b): (n, L, q), (q, c), (n, L, c) -> (n, q, c);
    on the card one ``linreg_grad_masked`` launch with no mask, every row
    live."""
    if not _on_cuda("linreg_grad_batched", x, theta, y):
        return ref.linreg_grad_batched(x, theta, y)
    return _masked_gradients(x, theta, y, None, (x.shape[1],) * 2)


def rff_linreg_grad_masked(x_raw, omega, delta, theta, y_stack, mask, *,
                           parity_phi=None, live_rows=None, prepared=None):
    """Fused RFF embedding -> per-client masked gradients from RAW features.

    x_raw: (n, l, d), omega: (d, q), delta: (q,), theta: (q, c),
    y_stack: (rows, l, c), mask: (rows, l), parity_phi: (l, q) or None ->
    (rows, q, c) float32 with rows = n (+ 1 with parity_phi) and
      g_b = phi_b^T diag(mask_b) (phi_b theta - Y_b),
      phi_b = sqrt(2/q) cos(X_b omega + delta) for b < n, parity_phi for
      the parity row b = n.
    x, omega, delta, theta, y and parity_phi are all float32 or all
    bfloat16; the mask is float32 (the parity row's 1/u scale), and so is
    the result.  On the card the (rows, l, q) embedded tensor is never
    allocated: one launch embeds each phi element once, in shared memory.

    ``live_rows`` = (raw, parity) is the number of leading rows that may be
    non-zero: ``raw`` for each of the n raw clients, ``parity`` for the
    parity row (read only with parity_phi), each in [1, l].  Default: every
    row.  Contract: past its count a row holds x = 0, y = 0 and mask = 0
    (parity_phi rows too), as
    ``aggregation.fused_embed_client_parity_tensors`` writes its padding.
    The kernel neither embeds nor reads those rows, and the result is the
    same: a padding row's term phi^T (mask (phi theta - y)) is
    0 * (finite) = +0 for finite theta, Omega and delta.  Where one of them
    is not finite, row 0 of the same client (always live while any row is)
    is already NaN or infinite, so g_b is not finite either way.  Rows with
    mask 0 inside the live range are computed, so a NaN feature there
    propagates as in the reference.

    ``prepared`` is ``prepare_rff_operands(x_raw, omega)``, made once
    where both are fixed; without it the card's call prepares its own.
    The kernel reads X and Omega from it alone (zero columns pad d to whole
    16-byte rows: they add 0 to X Omega).  The plain path ignores it.
    """
    name = "rff_linreg_grad_masked"
    extra = () if parity_phi is None else (parity_phi,)
    inputs = (x_raw, omega, delta, theta, y_stack, *extra)
    n, l, d = x_raw.shape
    live = (l, l) if live_rows is None else tuple(int(v) for v in live_rows)
    if len(live) != 2 or not all(1 <= v <= l for v in live):
        raise ValueError(f"{name}: live_rows must be two counts in [1, {l}],"
                         f" got {live_rows}")
    if not _on_cuda(name, *inputs, mask, dtype=None):
        return ref.rff_linreg_grad_masked(x_raw, omega, delta, theta,
                                          y_stack, mask, parity_phi,
                                          n_real=n, live_rows=live_rows)
    symbol = _FUSED_SYMBOLS.get(x_raw.dtype)
    if symbol is None or any(t.dtype != x_raw.dtype for t in inputs):
        raise TypeError(f"{name}: kernel takes x, omega, delta, theta, y "
                        "and parity_phi all float32 or all bfloat16, got "
                        f"{[t.dtype for t in inputs]}")
    if mask.dtype != torch.float32:
        raise TypeError(f"{name}: the mask is float32, got {mask.dtype}")
    (q, c), rows = (omega.shape[1], theta.shape[1]), n + len(extra)
    _check_shape(name, x_raw, (n, l, d))
    _check_shape(name, omega, (d, q))
    _check_shape(name, delta, (q,))
    _check_shape(name, theta, (q, c))
    _check_shape(name, y_stack, (rows, l, c))
    _check_shape(name, mask, (rows, l))
    if parity_phi is not None:
        _check_shape(name, parity_phi, (l, q))
    width = _tma_width(d, x_raw.dtype)
    if prepared is None:
        prepared = prepare_rff_operands(x_raw, omega)
    split = x_raw.dtype == torch.float32
    xb, ob = prepared.x_big, prepared.omega_big
    xs, os_ = ((prepared.x_small, prepared.omega_small) if split
               else (xb, ob))
    if (xb.shape != (n, l, width) or ob.shape != (q, width)
            or xb.dtype != x_raw.dtype or ob.dtype != x_raw.dtype
            or xb.device != x_raw.device or ob.device != x_raw.device
            or xs is None or os_ is None or xs.shape != xb.shape
            or os_.shape != ob.shape or xs.dtype != xb.dtype
            or os_.dtype != ob.dtype or not all(
                t.is_contiguous() for t in (xb, xs, ob, os_))):
        raise ValueError(f"{name}: prepared is not prepare_rff_operands of "
                         f"a ({n}, {l}, {d}) X and a ({d}, {q}) Omega, "
                         f"{x_raw.dtype} on {x_raw.device}")
    plan = fused_plan(q, n, live[:rows - n + 1], functools.partial(
        _resident_clusters, x_raw.device.index or 0,
        int(x_raw.dtype == torch.bfloat16)))
    f32 = dict(dtype=torch.float32, device=x_raw.device)
    clusters = n * plan.groups_raw + (rows - n) * plan.groups_par
    part = (torch.empty((clusters, q, c), **f32)
            if clusters > rows else None)
    g = torch.empty((rows, q, c), **f32)
    _launch(name, symbol, x_raw.device, xb.data_ptr(), xs.data_ptr(),
            ob.data_ptr(), os_.data_ptr(), delta.data_ptr(), theta.data_ptr(),
            y_stack.data_ptr(), mask.data_ptr(), _ptr(parity_phi), _ptr(part),
            g.data_ptr(), rows, n, l, width, q, c, q, live[0], live[1], *plan)
    return g


def gqa_plan(B: int, K: int, T: int, n_sm: int) -> tuple[int, int]:
    """(n_split, split_tiles) of ``gqa_decode``: the cache's GQA_TILE-slot
    tiles cut into n_split runs of split_tiles (the last may be shorter),
    one block each per (b, KV head), as many as one wave of
    GQA_BLOCKS_PER_SM blocks an SM holds over the B * K pairs (at least
    one)."""
    tiles = -(-T // GQA_TILE)
    want = max(1, GQA_BLOCKS_PER_SM * n_sm // (B * K))
    per = -(-tiles // min(tiles, want))
    return -(-tiles // per), per


def gqa_decode(q, k, v, k_pos, q_pos: int, window: int = 0):
    """One-token GQA attention over a KV cache:
    q (B, H, hd), k (B, T, K, hd), v (B, T, K, hd_v), k_pos (T,) int32 slot
    positions (-1 empty), q_pos int -> (B, H, hd_v) in q's dtype.

    Valid slots have 0 <= k_pos <= q_pos and, with window > 0,
    k_pos > q_pos - window.  q, k and v are all float32 or all bfloat16;
    on the card one launch (a split pass over the runs of ``gqa_plan`` and
    a combine pass, partials in ``torch.empty`` scratch)."""
    name = "gqa_decode"
    q_pos, window = int(q_pos), int(window)
    # meta inputs (the compile driver's trace of a decode step) take the
    # plain version: its ops give the output's shape and the step's counts
    if not _on_cuda(name, q, k, v, k_pos, dtype=None, meta=True):
        return ref.gqa_decode(q, k, v, k_pos, q_pos, window)
    symbol = _GQA_SYMBOLS.get(q.dtype)
    if symbol is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: kernel takes q, k and v all float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k_pos.dtype != torch.int32:
        raise TypeError(f"{name}: k_pos is int32, got {k_pos.dtype}")
    (B, H, hd), (T, K), hd_v = q.shape, k.shape[1:3], v.shape[-1]
    _check_shape(name, q, (B, H, hd))
    _check_shape(name, k, (B, T, K, hd))
    _check_shape(name, v, (B, T, K, hd_v))
    _check_shape(name, k_pos, (T,))
    if H % K:
        raise ValueError(f"{name}: {H} query heads do not group over {K} "
                         "KV heads")
    if H // K > GQA_MAX_GROUP or max(hd, hd_v) > GQA_MAX_HEAD_DIM:
        raise ValueError(f"{name}: kernel takes at most {GQA_MAX_GROUP} "
                         f"query heads per KV head and head dims up to "
                         f"{GQA_MAX_HEAD_DIM}, got G = {H // K}, hd = {hd}, "
                         f"hd_v = {hd_v}")
    n_split, split_tiles = gqa_plan(B, K, T, _sm_count(q.device.index or 0))
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((B, K, n_split, H // K), **f32)
    part_l = torch.empty((B, K, n_split, H // K), **f32)
    part_acc = torch.empty((B, K, n_split, H // K, hd_v), **f32)
    out = torch.empty((B, H, hd_v), dtype=q.dtype, device=q.device)
    _launch(name, symbol, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            k_pos.data_ptr(), out.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), B, T, H, K, hd, hd_v,
            q_pos, window, split_tiles)
    return out
