"""The port's kernels: plain versions against the Pallas reference, and the
CUDA kernels against the plain versions on the card.

On the CPU each plain PyTorch version (``repro_torch.kernels.ref``, which
``repro_torch.kernels.ops`` runs for CPU tensors) is held against the
reference's Pallas kernel run as ``tests/test_kernels.py`` runs it: through
``repro.kernels.ops`` with ``use_pallas=True, interpret=True``.  Inputs are
made with NumPy from a seed; shapes are odd so that no dimension is a
multiple of a tile, or sit one below, at and one above the reference's
128-wide blocks.  Tolerance: rtol = atol = 1e-5, float32 sums of at most
~130 terms taken in another order.  The fused kernel's bfloat16 variant is
held to the same tolerance: both sides take the same bfloat16 values and
compute in float32 (the mask stays float32).

``gqa_decode``'s plain version is held to atol 1e-5 against the Pallas
kernel (``bt=64``) at ``tests/test_kernels.py``'s decode shapes, at a T
that is no multiple of the block, in a rolling cache's slot order, with
whole chunks masked and with no valid slot at all.

The fused kernel's ``live_rows`` (the leading rows that may be non-zero)
is held against the same function over every row, on inputs that are zero
past the live counts, and against the Pallas kernel; its launch plan is
checked to take every q that the Pallas kernel's VMEM check admits.
``linreg_grad_masked``'s ``live_rows`` is held the same way, and its
launch plan (equal chains of slabs over all rows, their segments numbered
without collision) is checked in plain Python, as is ``gqa_decode``'s
(every 32-slot tile of the cache in one split).

The ``cuda``-marked tests compare each CUDA kernel with its plain version
on the card, at shapes one below, at and one above each tile multiple of
the kernel (for the fused kernel also at cluster and slab edges, with live
counts at 1, a slab edge +- 1 and L, and NaN inputs), and check that two
launches give the same bits.  They skip where there is no card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

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


def _fused_inputs(n, L, d, q, c, parity, seed=0):
    """Raw features, (Omega, delta), theta, labels and mask of n clients
    (plus the parity row's labels, 1/u-scaled mask and block)."""
    rows = n + int(parity)
    x = np.random.default_rng(seed).uniform(0, 1, (n, L, d)).astype(
        np.float32)
    omega = _np((d, q), seed + 1, 0.3)
    delta = np.random.default_rng(seed + 2).uniform(
        0, 2 * np.pi, q).astype(np.float32)
    theta = _np((q, c), seed + 3, 0.3)
    y = _np((rows, L, c), seed + 4)
    mask = np.random.default_rng(seed + 5).uniform(0, 1, (rows, L))
    mask = np.where(mask < 0.3, 0.0, 1.0).astype(np.float32)
    pphi = None
    if parity:
        mask[n] = np.float32(1.0 / (3 * L))
        pphi = _np((L, q), seed + 6, 0.05)
    return x, omega, delta, theta, y, mask, pphi


def _as_bf16(arrays):
    """The float32 arrays rounded to bfloat16: (port tensors, JAX arrays)
    holding the same values."""
    t = [None if a is None else torch.from_numpy(a).to(torch.bfloat16)
         for a in arrays]
    j = [None if a is None else jnp.asarray(b.float().numpy()).astype(
        jnp.bfloat16) for a, b in zip(arrays, t)]
    return t, j


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


def _masked_zero_past(arrays, live_c, live_l):
    """The masked-gradient inputs zero past the live counts (x, y, mask),
    as ``aggregation.fused_client_parity_tensors`` pads them: rows b < n - 1
    past live_c, row n - 1 past live_l."""
    x, theta, y, mask = (a.copy() for a in arrays)
    for rows, live in ((slice(None, -1), live_c), (slice(-1, None), live_l)):
        x[rows, live:] = 0.0
        y[rows, live:] = 0.0
        mask[rows, live:] = 0.0
    return x, theta, y, mask


# live counts one below, at and one above the kernel's 4- and 8-row slabs,
# 1 and every row; the last row's count 6x the clients', or less
_MASKED_LIVE = [(1, 1), (3, 18), (4, 24), (5, 30), (7, 41), (8, 40),
                (9, 4), (41, 41)]


@pytest.mark.parametrize("live", _MASKED_LIVE,
                         ids=[f"{a}-{b}" for a, b in _MASKED_LIVE])
def test_linreg_grad_masked_live_rows_change_nothing(live):
    """The plain version with live_rows equals the plain version without
    them, and the Pallas kernel, on inputs zero past the live counts."""
    arrays = _masked_zero_past(_grad_inputs(3, 41, 45, 10), *live)
    args = _t(*arrays)
    every = ops.linreg_grad_masked(*args)
    got = ops.linreg_grad_masked(*args, live_rows=live)
    want = ref_ops.linreg_grad_masked(*arrays, use_pallas=True,
                                      interpret=True)
    np.testing.assert_allclose(got.numpy(), every.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_linreg_grad_masked_live_rows_on_fused_coded_tensors():
    """A small deployment's fused coded tensors (l_max client rows, u > l_max
    parity rows with the 1/u mask): live_rows = (l_max, u) against every row
    and against the Pallas kernel."""
    from repro_torch.core import aggregation as t_agg
    n, l_max, q, c, u = 4, 7, 24, 3, 19
    rng = np.random.default_rng(8)
    valid = (rng.uniform(size=(n, l_max)) < 0.7).astype(np.float32)
    sub_x = _np((n, l_max, q), 9, 0.3) * valid[:, :, None]
    sub_y = _np((n, l_max, c), 10) * valid[:, :, None]
    gx, gy, gmask = t_agg.fused_client_parity_tensors(
        *(torch.from_numpy(a) for a in (sub_x, sub_y, valid,
                                        _np((u, q), 11, 0.3),
                                        _np((u, c), 12))))
    theta = torch.from_numpy(_np((q, c), 13, 0.3))
    got = ops.linreg_grad_masked(gx, theta, gy, gmask, live_rows=(l_max, u))
    every = ops.linreg_grad_masked(gx, theta, gy, gmask)
    want = ref_ops.linreg_grad_masked(gx.numpy(), theta.numpy(), gy.numpy(),
                                      gmask.numpy(), use_pallas=True,
                                      interpret=True)
    assert got.shape == (n + 1, q, c)
    np.testing.assert_allclose(got.numpy(), every.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("live", [(0, 3), (3, 42), (3,), (1, 2, 3)])
def test_linreg_grad_masked_refuses_bad_live_rows(live):
    args = _t(*_grad_inputs(3, 41, 8, 2))
    with pytest.raises(ValueError, match="live_rows"):
        ops.linreg_grad_masked(*args, live_rows=live)


@pytest.mark.parametrize("n,slabs_c,slabs_l,chain", [
    (31, 50, 300, 14), (3, 1, 1, 2), (5, 7, 3, 7), (6, 4, 9, 3),
    (1, 0, 300, 3), (40, 1, 2, 1), (9, 5, 5, 5)])
def test_masked_segments_are_numbered_without_collision(n, slabs_c, slabs_l,
                                                        chain):
    """The kernel's segment (block k, row b) is partial k + b, and the
    combine sums row b's segments k = first_b // chain .. last_b // chain:
    every (block, row) pair that shares a slab gets its own index below
    blocks + n, and the combine reads exactly those of its row."""
    counts = [slabs_c] * (n - 1) + [slabs_l]
    starts = np.cumsum([0] + counts)
    total = starts[-1]
    blocks = -(-total // chain)
    pairs = set()
    for k in range(blocks):
        for g in range(k * chain, min(total, (k + 1) * chain)):
            pairs.add((k, int(np.searchsorted(starts, g, side="right")) - 1))
    index = [k + b for k, b in pairs]
    assert len(set(index)) == len(index) and max(index) < blocks + n
    for b in range(n):
        k0 = starts[b] // chain
        k1 = (starts[b] + counts[b] - 1) // chain
        assert {k for k, bb in pairs if bb == b} == set(range(k0, k1 + 1))


@pytest.mark.parametrize("n,q,c,live,plan", [
    (31, 2000, 10, (400, 2400), (14, 129)),   # the coded round
    (30, 2000, 10, (400, 400), (12, 125)),    # the naive round
    (31, 2000, 10, (2400, 2400), (71, 131)),  # every row
    (1, 2000, 10, (2400, 2400), (3, 100)),    # one row over the card
    (31, 2000, 12, (400, 2400), (28, 129)),   # 4-row slabs (c > 10)
    (2, 5000, 33, (10, 10), (1, 6)),          # 3 q parts x 3 c chunks
    (40, 64, 3, (1, 9), (1, 41))])            # one-slab rows
def test_masked_plan_fills_the_card(n, q, c, live, plan):
    """The slabs of all rows (8 rows; 4 where c > 10 and q > 1024) cut
    into equal chains, at most one block an SM of 132 for each (q part,
    c chunk)."""
    assert ops.masked_plan(n, q, c, live, 132) == plan
    chain, blocks = plan
    rows = ops.masked_slab_rows(q, c)
    total = (n - 1) * -(-live[0] // rows) + -(-live[1] // rows)
    assert (blocks - 1) * chain < total <= blocks * chain
    assert blocks <= 132 // (ops.masked_parts(q) * -(-c // 16))


@pytest.mark.parametrize("n,u,l,q", [(3, 13, 20, 24), (2, 65, 33, 129)])
def test_parity_encode_batched_plain_matches_pallas(n, u, l, q):
    g, w, x = _parity_inputs(n, u, l, q)
    want = ref_ops.parity_encode_batched(g, w, x, use_pallas=True,
                                         interpret=True)
    got = ops.parity_encode_batched(*_t(g, w, x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# the fused kernel: n raw clients, with and without the parity row, f32
# and bf16; shapes around the reference's 128-wide blocks in L, d, q and c
_FUSED_SHAPES = [(3, 37, 19, 45, 3), (2, 64, 127, 129, 10),
                 (2, 129, 128, 128, 17)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parity", [False, True], ids=["clients", "parity"])
@pytest.mark.parametrize("n,L,d,q,c", _FUSED_SHAPES)
def test_rff_linreg_grad_masked_plain_matches_pallas(n, L, d, q, c, parity,
                                                     dtype):
    x, omega, delta, theta, y, mask, pphi = _fused_inputs(n, L, d, q, c,
                                                          parity)
    if dtype == "float32":
        tx, tom, tde, tth, ty, tpp = (
            None if a is None else torch.from_numpy(a)
            for a in (x, omega, delta, theta, y, pphi))
        jx, jom, jde, jth, jy, jpp = x, omega, delta, theta, y, pphi
    else:
        (tx, tom, tde, tth, ty, tpp), (jx, jom, jde, jth, jy, jpp) = \
            _as_bf16((x, omega, delta, theta, y, pphi))
    want = ref_ops.rff_linreg_grad_masked(
        jx, jom, jde, jth, jy, mask, parity_phi=jpp, use_pallas=True,
        interpret=True)
    got = ops.rff_linreg_grad_masked(tx, tom, tde, tth, ty,
                                     torch.from_numpy(mask), parity_phi=tpp)
    assert got.dtype == torch.float32 and got.shape == (n + parity, q, c)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_rff_linreg_grad_masked_nan_in_masked_row_propagates():
    """Zero-mask rows are not skipped: a NaN feature in a masked row
    poisons that client's gradient, in the reference and in the port."""
    x, omega, delta, theta, y, mask, _ = _fused_inputs(2, 9, 5, 7, 2, False)
    mask[1, 3] = 0.0
    x[1, 3, 2] = np.nan
    want = np.asarray(ref_ops.rff_linreg_grad_masked(
        x, omega, delta, theta, y, mask, use_pallas=True, interpret=True))
    got = ops.rff_linreg_grad_masked(*_t(x, omega, delta, theta, y, mask))
    assert np.isnan(want[1]).all() and torch.isnan(got[1]).all()
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL, atol=ATOL)


def _zero_past(arrays, n, live_raw, live_par):
    """The fused inputs with every row past the live counts zeroed (x, y,
    mask and the parity block), as the fused round pads them."""
    x, omega, delta, theta, y, mask, pphi = (None if a is None else a.copy()
                                             for a in arrays)
    x[:, live_raw:] = 0.0
    y[:n, live_raw:] = 0.0
    mask[:n, live_raw:] = 0.0
    if pphi is not None:
        y[n:, live_par:] = 0.0
        mask[n:, live_par:] = 0.0
        pphi[live_par:] = 0.0
    return x, omega, delta, theta, y, mask, pphi


# live counts of 1, one below, at and one above a 64- and a 112-row slab,
# and every row; the parity row's count differs from the clients'
_LIVE = [(1, 1), (63, 130), (64, 65), (65, 64), (130, 1), (111, 113),
         (113, 112)]


@pytest.mark.parametrize("parity", [False, True], ids=["clients", "parity"])
@pytest.mark.parametrize("live", _LIVE, ids=[f"{a}-{b}" for a, b in _LIVE])
def test_rff_linreg_grad_masked_live_rows_change_nothing(live, parity):
    """The plain version with live_rows equals the plain version without
    them, and the Pallas kernel, on inputs zero past the live counts."""
    n = 2
    arrays = _zero_past(_fused_inputs(n, 130, 19, 45, 3, parity), n, *live)
    x, omega, delta, theta, y, mask, pphi = arrays
    tpp = None if pphi is None else torch.from_numpy(pphi)
    args = (*_t(x, omega, delta, theta, y, mask),)
    every = ops.rff_linreg_grad_masked(*args, parity_phi=tpp)
    got = ops.rff_linreg_grad_masked(*args, parity_phi=tpp, live_rows=live)
    want = ref_ops.rff_linreg_grad_masked(
        x, omega, delta, theta, y, mask, parity_phi=pphi, use_pallas=True,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), every.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("live", [None, (5, 3)], ids=["every", "live"])
def test_rff_linreg_grad_masked_nan_theta_poisons_every_row(live):
    """A NaN in theta makes every g_b NaN with and without live rows (row
    0 is always live), as in the reference."""
    n = 2
    arrays = _zero_past(_fused_inputs(n, 9, 5, 7, 2, True), n, 5, 3)
    x, omega, delta, theta, y, mask, pphi = arrays
    theta[3, 1] = np.nan
    want = np.asarray(ref_ops.rff_linreg_grad_masked(
        x, omega, delta, theta, y, mask, parity_phi=pphi, use_pallas=True,
        interpret=True))
    got = ops.rff_linreg_grad_masked(*_t(x, omega, delta, theta, y, mask),
                                     parity_phi=torch.from_numpy(pphi),
                                     live_rows=live)
    assert np.isnan(want[:, :, 1]).all()
    np.testing.assert_array_equal(torch.isnan(got).numpy(), np.isnan(want))


def test_rff_linreg_grad_masked_nan_in_masked_live_row_propagates():
    """A NaN feature in a masked row inside the live range still poisons
    that client's gradient with live rows."""
    n = 2
    arrays = _zero_past(_fused_inputs(n, 9, 5, 7, 2, False), n, 6, 6)
    x, omega, delta, theta, y, mask, _ = arrays
    mask[1, 4] = 0.0
    x[1, 4, 2] = np.nan
    want = np.asarray(ref_ops.rff_linreg_grad_masked(
        x, omega, delta, theta, y, mask, use_pallas=True, interpret=True))
    got = ops.rff_linreg_grad_masked(*_t(x, omega, delta, theta, y, mask),
                                     live_rows=(6, 6))
    assert np.isnan(want[1]).all() and torch.isnan(got[1]).all()
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("live", [(0, 3), (3, 10), (3,), (1, 2, 3)])
def test_rff_linreg_grad_masked_refuses_bad_live_rows(live):
    fused = _t(*_fused_inputs(2, 9, 5, 7, 2, False)[:6])
    with pytest.raises(ValueError, match="live_rows"):
        ops.rff_linreg_grad_masked(*fused, live_rows=live)


def _H100(slab_rows, cluster, cols_per_cta, stages):
    """Clusters at once on 132 SMs of 233472 bytes of shared memory each,
    counting SMs only (no GPC boundaries)."""
    per_sm = ops.SM_SMEM // (ops.fused_smem_bytes(slab_rows, cols_per_cta,
                                                  stages) + 1024)
    return per_sm * 132 // cluster


def _jax_max_q(d, c, dtype):
    """The widest q that the Pallas kernel's VMEM check admits at its
    default blocks (bm = bq = 128)."""
    from repro.kernels.rff_linreg_grad import _check_fused_vmem
    lo, hi = 128, 1 << 16
    while hi - lo > 1:
        mid = (lo + hi) // 2
        try:
            _check_fused_vmem(d, mid, c, 128, 128, dtype)
            lo = mid
        except ValueError:
            hi = mid
    return lo


@pytest.mark.parametrize("d,c,dtype", [(784, 10, "float32"),
                                       (784, 10, "bfloat16"),
                                       (1, 1, "float32"), (1, 1, "bfloat16"),
                                       (16, 40, "bfloat16")])
def test_fused_plan_takes_every_q_the_pallas_kernel_takes(d, c, dtype):
    """The fused kernel's limit on q is no lower than the reference's at
    its defaults; past its own limit the plan raises a clear ValueError."""
    jax_q = _jax_max_q(d, c, jnp.dtype(dtype))
    assert ops.fused_max_q() >= jax_q
    for q in (1, 255, 256, 257, 2000, 2049, jax_q, ops.fused_max_q()):
        plan = ops.fused_plan(q, 30, (400, 2400), _H100)
        assert plan.cluster <= ops.FUSED_MAX_CLUSTER
        assert (plan.cluster - 1) * plan.cols_per_cta < q \
            <= plan.cluster * plan.cols_per_cta
        assert ops.fused_smem_bytes(plan.slab_rows, plan.cols_per_cta,
                                    plan.stages) <= ops.FUSED_MAX_SMEM
        assert 1 <= plan.stages <= ops.FUSED_MAX_STAGES
        assert plan.stages == ops.fused_stages(plan.slab_rows,
                                               plan.cols_per_cta)
    with pytest.raises(ValueError, match="wider than the fused kernel"):
        ops.fused_plan(ops.fused_max_q() + 1, 30, (400, 2400), _H100)


def test_fused_plan_at_the_main_shape():
    """q = 2000 over a cluster of 8 CTAs, 112-row slabs beside a ring of 3
    stages, one CTA an SM.  Live rows (400, 2400): 4 slabs a client and 22
    on the parity row, 142 in all.  At most 9 of them a cluster fill 16
    clusters at once (132 SMs), 10 at 15 (what the H100 reported): one
    group a client; the parity row's slabs, which embed nothing, two a
    cluster over the clusters the card holds."""
    assert ops.fused_smem_bytes(112, 256, 3) == 222000
    assert ops.SM_SMEM // (ops.fused_smem_bytes(112, 256, 3) + 1024) == 1
    assert ops.fused_plan(2000, 30, (400, 2400), _H100) == \
        ops.FusedPlan(112, 8, 256, 1, 11, 3)
    assert ops.fused_plan(2000, 30, (400, 2400), lambda *a: 15)[3:5] == \
        (1, 11)
    # every row live: 22 slabs a row, 682 in all: chains of 43 at 16
    # clusters at once, of 46 at 15; the parity row's 22 slabs two a cluster
    assert ops.fused_plan(2000, 30, (2400, 2400), _H100)[3:5] == (1, 11)
    assert ops.fused_plan(2000, 30, (2400, 2400), lambda *a: 15)[3:5] == \
        (1, 11)
    # no parity row; few rows: a group per slab
    assert ops.fused_plan(2000, 30, (400,), _H100)[3:5] == (1, 1)
    assert ops.fused_plan(200, 3, (130,), _H100).groups_raw == 2


@pytest.mark.parametrize("n_real,live,resident",
                         [(30, (400, 2400), 30), (30, (2400, 2400), 30),
                          (1, (64, 64), 1), (3, (2560,), 8),
                          (31, (100,), 264)])
def test_fused_groups_spread_the_slabs(n_real, live, resident):
    """Every group has a slab, no group is longer than the chain the card
    needs at its occupancy, and the clusters stay within one a slab."""
    plan = ops.fused_plan(2000, n_real, live, lambda *a: resident)
    slabs = [-(-n // plan.slab_rows) for n in live]
    total = n_real * slabs[0] + sum(slabs[1:])
    chain = -(-total // resident)
    groups = (plan.groups_raw, plan.groups_par)[:len(live)]
    for n, g in zip(slabs, groups):
        assert 1 <= g <= n and -(-n // g) <= chain


def _np_tf32_round(a):
    """cvt.rna.tf32.f32 in float64 arithmetic: the nearest value with 11
    significant bits (10 past a normal float32's point, never finer than a
    float32 denormal's 13 dropped bits), ties away from zero; infinities and
    NaN as they are."""
    x = a.astype(np.float64)
    out = x.copy()
    fin = np.isfinite(x) & (x != 0)
    _, e = np.frexp(np.abs(x[fin]))
    quantum = np.ldexp(1.0, np.maximum(e - 11, -136))
    out[fin] = np.sign(x[fin]) * np.floor(np.abs(x[fin]) / quantum + 0.5) \
        * quantum
    with np.errstate(over="ignore"):
        return out.astype(np.float32)


def test_tf32_split_matches_a_numpy_emulation_of_cvt_rna():
    """ops.tf32_round / tf32_split (what prepare_rff_operands stores for the
    kernel) give the bits of cvt.rna.tf32.f32, emulated in float64: random
    values over 60 decades, ties, denormals, the largest float32 (rounds to
    infinity), zeros, infinities; NaN stays NaN."""
    rng = np.random.default_rng(0)
    f32 = np.finfo(np.float32)
    v = np.concatenate([
        (rng.normal(size=20000) * 10.0 ** rng.integers(-30, 30, 20000)),
        [0.0, -0.0, 1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
         1 + 2 ** -12, f32.max, -f32.max, 1e-40, -3e-42, 1.4e-45, np.inf,
         -np.inf]]).astype(np.float32)
    got = ops.tf32_round(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _np_tf32_round(v).view(np.uint32))
    big, small = ops.tf32_split(torch.from_numpy(v[:20000]))
    want_big = _np_tf32_round(v[:20000])
    np.testing.assert_array_equal(big.numpy().view(np.uint32),
                                  want_big.view(np.uint32))
    np.testing.assert_array_equal(
        small.numpy().view(np.uint32),
        _np_tf32_round(v[:20000] - want_big).view(np.uint32))
    assert torch.isnan(ops.tf32_round(torch.tensor([np.nan]))).all()


@pytest.mark.parametrize("d,width", [(8, 8), (15, 16), (784, 784), (3, 4)])
def test_prepare_rff_operands_layout(d, width):
    """X padded and Omega transposed and padded to whole 16-byte rows with
    zeros; in float32 big + small is each value to about 2^-22, in
    bfloat16 the values themselves; on the CPU PREPARES counts nothing."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2, 5, d)).astype(np.float32))
    om = torch.from_numpy(rng.normal(size=(d, 7)).astype(np.float32))
    ops.reset_launch_counts()
    p = ops.prepare_rff_operands(x, om)
    assert ops.PREPARES["rff_linreg_grad_masked"] == 0
    assert p.x_big.shape == (2, 5, width) and p.omega_big.shape == (7, width)
    for big, small, want in ((p.x_big, p.x_small, x),
                             (p.omega_big, p.omega_small, om.t())):
        assert big.is_contiguous() and small.is_contiguous()
        assert not big[..., d:].any() and not small[..., d:].any()
        torch.testing.assert_close(big[..., :d] + small[..., :d], want,
                                   rtol=2 ** -21, atol=0)
        assert torch.equal(big, ops.tf32_round(big))
    pb = ops.prepare_rff_operands(x.to(torch.bfloat16),
                                  om.to(torch.bfloat16))
    assert pb.x_small is None and pb.omega_small is None
    assert pb.omega_big.shape == (7, -(-d // 8) * 8)
    assert torch.equal(pb.omega_big[:, :d], om.to(torch.bfloat16).t())
    assert torch.equal(pb.x_big[..., :d], x.to(torch.bfloat16))


@pytest.mark.parametrize("m,q,splits", [(2400, 2000, 33), (400, 2000, 13),
                                        (31, 129, 1), (33, 129, 2)])
def test_linreg_grad_splits_fill_the_card(m, q, splits):
    """linreg_grad's X^T r pass splits L so that the parity set (2400,
    2000) and a legacy client (400, 2000) each launch >= 132 blocks."""
    got = ops.linreg_grad_splits(m, q, 132)
    assert got == splits
    if m >= 400:
        assert -(-q // ops.LG_COLS) * got >= 132


@pytest.mark.parametrize("m,q,c", [(37, 45, 3), (129, 127, 10),
                                   (128, 129, 17)])
def test_linreg_grad_plain_matches_pallas(m, q, c):
    x, theta, y, _ = _grad_inputs(1, m, q, c)
    want = ref_ops.linreg_grad(x[0], theta, y[0], use_pallas=True,
                               interpret=True)
    got = ops.linreg_grad(*_t(x[0], theta, y[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,L,q,c", [(3, 37, 45, 3), (2, 129, 128, 10)])
def test_linreg_grad_batched_plain_matches_pallas(n, L, q, c):
    x, theta, y, _ = _grad_inputs(n, L, q, c)
    want = ref_ops.linreg_grad_batched(x, theta, y, use_pallas=True,
                                       interpret=True)
    got = ops.linreg_grad_batched(*_t(x, theta, y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("u,l,q", [(13, 20, 24), (129, 127, 128),
                                   (128, 129, 127)])
def test_parity_encode_plain_matches_pallas(u, l, q):
    g, w, x = _parity_inputs(1, u, l, q)
    want = ref_ops.parity_encode(g[0], w[0], x[0], use_pallas=True,
                                 interpret=True)
    got = ops.parity_encode(*_t(g[0], w[0], x[0]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,l,d,q", [(3, 11, 19, 45), (2, 65, 129, 127)])
def test_rff_embed_batched_plain_matches_pallas(n, l, d, q):
    x, omega, delta = _rff_inputs(n * l, d, q)
    x = x.reshape(n, l, d)
    want = ref_ops.rff_embed_batched(x, omega, delta, use_pallas=True,
                                     interpret=True)
    got = ops.rff_embed_batched(*_t(x, omega, delta))
    assert got.shape == (n, l, q)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _gqa_inputs(B, H, K, hd, hdv, T, seed=0, empty=0.1, k_pos=None):
    """q, k, v and the slot positions: position t at slot t, a share
    `empty` of the slots empty (-1), unless `k_pos` is given."""
    rng = np.random.default_rng(seed)
    q = _np((B, H, hd), seed)
    k = _np((B, T, K, hd), seed + 1, 0.3)
    v = _np((B, T, K, hdv), seed + 2)
    if k_pos is None:
        k_pos = np.where(rng.uniform(size=T) < empty, -1, np.arange(T))
    return q, k, v, np.asarray(k_pos, np.int32)


def _rolling_positions(T, last):
    """A rolling cache of T slots after position `last`: slot p % T holds
    position p for the T latest positions (slot order is not position
    order)."""
    k_pos = np.empty(T, np.int32)
    for p in range(last - T + 1, last + 1):
        k_pos[p % T] = p
    return k_pos


# (name, B, H, K, hd, hd_v, T, window, k_pos or None, q_pos)
GQA_CASES = [
    # tests/test_kernels.py DECODE_SHAPES, q_pos = T - 1
    ("gqa", 2, 8, 2, 64, 64, 256, 0, None, 255),
    ("mha_ragged", 2, 8, 8, 64, 64, 300, 0, None, 299),
    ("window", 1, 16, 4, 32, 32, 128, 48, None, 127),
    ("mla_hdv", 2, 4, 4, 16, 8, 64, 0, None, 63),
    ("t500", 2, 8, 2, 32, 32, 500, 0, None, 499),
    ("rolling", 2, 8, 2, 32, 32, 96, 96, _rolling_positions(96, 245), 245),
    ("rolling_short", 1, 4, 1, 32, 32, 96, 40, _rolling_positions(96, 300),
     300),
    # chunks 0 and 1 outside the window, chunk 3 all empty
    ("masked_chunks", 2, 8, 2, 32, 32, 256, 100,
     np.r_[np.arange(192), -np.ones(64)], 191),
    ("no_valid_slot", 1, 4, 2, 16, 16, 128, 0, -np.ones(128), 127),
    # the model zoo's other decode shapes: internvl2's G = 14 / 2 = 7 and
    # deepseek's MLA (G = 1, hd 192 = 128 + 64, hd_v 128)
    ("g7_internvl2", 2, 14, 2, 64, 64, 100, 0, None, 99),
    ("mla_hd192", 2, 16, 16, 192, 128, 70, 0, None, 69),
]


@pytest.mark.parametrize("name,B,H,K,hd,hdv,T,window,k_pos,q_pos", GQA_CASES,
                         ids=[c[0] for c in GQA_CASES])
def test_gqa_decode_plain_matches_pallas(name, B, H, K, hd, hdv, T, window,
                                         k_pos, q_pos):
    q, k, v, kp = _gqa_inputs(B, H, K, hd, hdv, T, k_pos=k_pos)
    want = ref_ops.gqa_decode(q, k, v, kp, jnp.int32(q_pos), window=window,
                              use_pallas=True, bt=64, interpret=True)
    got = ops.gqa_decode(*_t(q, k, v, kp), q_pos, window)
    assert got.shape == (B, H, hdv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


# (B, K, T, SMs) -> (n_split, split_tiles): the serving shape, T one
# below, at and one above the 32-slot tile, a split length one below, at and
# one above a multiple of 2 tiles, the rolling cache of serve_check, one
# (b, KV head) pair on a small card, and one slot
_GQA_PLANS = [
    ((8, 8, 4160, 132), (6, 22)),
    ((2, 8, 31, 132), (1, 1)), ((2, 8, 32, 132), (1, 1)),
    ((2, 8, 33, 132), (2, 1)),
    ((8, 8, 383, 132), (6, 2)), ((8, 8, 384, 132), (6, 2)),
    ((8, 8, 385, 132), (5, 3)),
    ((8, 8, 1024, 132), (6, 6)),
    ((1, 1, 4160, 16), (44, 3)),
    ((64, 8, 4160, 132), (1, 130)),
    ((1, 1, 1, 132), (1, 1)),
]


@pytest.mark.parametrize("shape,plan", _GQA_PLANS,
                         ids=["x".join(map(str, s)) for s, _ in _GQA_PLANS])
def test_gqa_plan_covers_every_tile_once(shape, plan):
    """The cache's 32-slot tiles cut into runs of equal length, one wave of
    three blocks an SM over the (b, KV head) pairs (one run each where the
    pairs alone fill it); every tile in one run."""
    B, K, T, n_sm = shape
    assert ops.gqa_plan(B, K, T, n_sm) == plan
    n_split, per = plan
    tiles = -(-T // ops.GQA_TILE)
    assert (n_split - 1) * per < tiles <= n_split * per
    assert B * K * n_split <= max(B * K, ops.GQA_BLOCKS_PER_SM * n_sm)


def test_cpu_calls_take_the_plain_path_and_count_nothing():
    ops.reset_launch_counts()
    x, theta, y, mask = _t(*_grad_inputs(2, 5, 6, 2))
    torch.testing.assert_close(ops.linreg_grad_masked(x, theta, y, mask),
                               ref.linreg_grad_masked(x, theta, y, mask),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.linreg_grad_batched(x, theta, y),
                               ref.linreg_grad_batched(x, theta, y),
                               rtol=0, atol=0)
    torch.testing.assert_close(ops.linreg_grad(x[0], theta, y[0]),
                               ref.linreg_grad(x[0], theta, y[0]),
                               rtol=0, atol=0)
    g, w, xp = _t(*_parity_inputs(2, 4, 3, 5))
    torch.testing.assert_close(ops.parity_encode(g[0], w[0], xp[0]),
                               ref.parity_encode(g[0], w[0], xp[0]),
                               rtol=0, atol=0)
    fused = _t(*_fused_inputs(2, 5, 3, 6, 2, False)[:6])
    torch.testing.assert_close(
        ops.rff_linreg_grad_masked(*fused),
        ref.rff_linreg_grad_masked(*fused, n_real=2), rtol=0, atol=0)
    gqa = _t(*_gqa_inputs(2, 4, 2, 8, 8, 20))
    torch.testing.assert_close(ops.gqa_decode(*gqa, 19, 5),
                               ref.gqa_decode(*gqa, 19, 5), rtol=0, atol=0)
    assert ops.LAUNCHES == dict.fromkeys(
        ("rff_embed", "parity_encode_batched", "linreg_grad_masked",
         "rff_linreg_grad_masked", "linreg_grad", "parity_encode",
         "gqa_decode"), 0)


def test_fused_wrapper_checks_rows_against_parity():
    x, omega, delta, theta, y, mask, pphi = _fused_inputs(2, 5, 3, 6, 2,
                                                          True)
    with pytest.raises(ValueError, match="pphi"):
        ops.rff_linreg_grad_masked(*_t(x, omega, delta, theta, y, mask))


def test_wrapper_refuses_other_devices():
    x, omega, delta = (t.to("meta") for t in _t(*_rff_inputs(4, 3, 5)))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rff_embed(x, omega, delta)
    cpu = _t(*_rff_inputs(4, 3, 5))
    with pytest.raises(ValueError, match="several devices"):
        ops.rff_embed(cpu[0], cpu[1], delta)


def _c_entry_points():
    """{symbol: [parameter declarations]} of every extern "C" function in
    the kernel sources."""
    import re
    found = {}
    for src in build.CSRC.glob("*.cu"):
        for name, params in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{',
                                       src.read_text(), re.S):
            found[name] = [p.strip() for p in params.split(",")]
    return found


def test_c_signatures_match_the_sources():
    """Each ctypes signature has the arity and the pointer/int kinds of the
    C function it binds (a missing int would pass the stream truncated)."""
    entry = _c_entry_points()
    assert set(build.SIGNATURES) <= set(entry)
    for symbol, (_, argtypes) in build.SIGNATURES.items():
        params = entry[symbol]
        assert len(params) == len(argtypes), symbol
        for decl, kind in zip(params, argtypes):
            pointer = "*" in decl or decl.startswith("cudaStream_t")
            assert pointer == (kind is build._P), (symbol, decl)


def test_fused_layout_constants_match_the_source():
    src = (build.CSRC / "rff_linreg_grad.cu").read_text()
    for c_name, value in (("PIECE", ops.FUSED_PIECE),
                          ("CMAX", ops.FUSED_CMAX),
                          ("MAX_CLUSTER", ops.FUSED_MAX_CLUSTER),
                          ("STAGE_BYTES", ops.FUSED_STAGE_BYTES),
                          ("MAX_STAGES", ops.FUSED_MAX_STAGES),
                          ("MAX_SLAB", 128),
                          ("MAX_SMEM", ops.FUSED_MAX_SMEM)):
        assert f"constexpr int {c_name} = {value};" in src, c_name
    assert "PHI_PAD = 4;" in src
    # the ring's size, and what step 2 keeps in it, as fused_stages counts
    assert "stages * STAGE_BYTES >= (PIECE + 5 * R) * CMAX * 4" in src
    assert max(ops.FUSED_SLAB_ROWS) <= 128
    assert all(r % 16 == 0 for r in ops.FUSED_SLAB_ROWS)
    lg = (build.CSRC / "linreg_grad.cu").read_text()
    assert f"constexpr int XTR_THREADS = {ops.LG_COLS};" in lg
    assert f"constexpr int MK_ROWS = {ops.MK_ROWS};" in lg
    assert f"constexpr int MK_ROWS_WIDE = {ops.MK_ROWS_WIDE};" in lg
    assert "return J == 2 && NC > 10 ? MK_ROWS_WIDE : MK_ROWS;" in lg
    assert f"constexpr int MK_THREADS = {ops.MK_THREADS};" in lg
    assert f"constexpr int LG_QB = {ops.LG_QB};" in lg


def test_tile_and_gqa_constants_match_the_sources():
    """ops' copies of the shared float32 tensor-core tile
    (tc_gemm_f32.cuh, the edges the tests take) and of gqa_decode.cu's
    tile and widths (the plan and the wrapper's checks) match the
    sources; no kernel includes the removed FFMA tile."""
    tc = (build.CSRC / "tc_gemm_f32.cuh").read_text()
    for c_name, value in (("BM", ops.TC_TILE_M), ("BN", ops.TC_TILE_N),
                          ("BK", ops.TC_TILE_K)):
        assert f"constexpr int {c_name} = {value};" in tc, c_name
    gqa = (build.CSRC / "gqa_decode.cu").read_text()
    for c_name, value in (("kTile", ops.GQA_TILE),
                          ("kMaxG", ops.GQA_MAX_GROUP),
                          ("kMaxHd", ops.GQA_MAX_HEAD_DIM)):
        assert f"constexpr int {c_name} = {value};" in gqa, c_name
    for name in ("rff_embed.cu", "parity_encode.cu"):
        assert '#include "tc_gemm_f32.cuh"' in (build.CSRC / name).read_text()
    assert not (build.CSRC / "tiled_gemm.cuh").exists()


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


# tile multiples: rff_embed and the parity encode run the 128 x 128 tile
# of tc_gemm_f32.cuh over K steps of 16 (d = 15 and 17: 4-byte copies);
# the masked-gradient kernel cuts L into 4-row slabs and c into chunks of
# 16
@pytest.mark.cuda
@pytest.mark.parametrize("m,d,q", [(63, 15, 63), (64, 16, 64), (65, 17, 65),
                                   (129, 784, 127), (127, 15, 127),
                                   (128, 16, 128), (129, 17, 129),
                                   (257, 255, 256), (300, 784, 2000)])
def test_rff_embed_kernel_matches_plain(cuda, m, d, q):
    args = _t(*_rff_inputs(m, d, q), device=cuda)
    got = ops.rff_embed(*args)
    again = ops.rff_embed(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _max_rel_err(got, ref.rff_embed(*args)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 17, 784])
def test_rff_embed_kernel_propagates_nan(cuda, d):
    """A NaN feature poisons its row of the embedding, on the 16-byte copy
    path (d = 16, 784) and the 4-byte one (d = 17); NaN in Omega and delta
    poison their column."""
    x, omega, delta = _rff_inputs(140, d, 130)
    x[5, d // 2] = np.nan
    omega[d - 1, 7] = np.nan
    delta[100] = np.nan
    args = _t(x, omega, delta, device=cuda)
    got = ops.rff_embed(*args)
    torch.cuda.synchronize()
    want = ref.rff_embed(*args)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[5]).all() and torch.isnan(got[:, 7]).all()
    keep = torch.ones(130, dtype=torch.bool, device=cuda)
    keep[[7, 100]] = False
    assert _max_rel_err(got[:5][:, keep], want[:5][:, keep]) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 784])
def test_rff_embed_kernel_takes_an_unaligned_base(cuda, d):
    """x at a 4-byte offset from a 16-byte boundary takes the 4-byte copies
    though d is a multiple of 4."""
    x, omega, delta = _t(*_rff_inputs(130, d, 129), device=cuda)
    buf = torch.empty(x.numel() + 1, device=cuda)
    x_off = buf[1:].view(x.shape)
    x_off.copy_(x)
    assert x_off.data_ptr() % 16 != 0 and x_off.is_contiguous()
    got = ops.rff_embed(x_off, omega, delta)
    torch.cuda.synchronize()
    assert _max_rel_err(got, ref.rff_embed(x, omega, delta)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,q,c", [(2, 63, 127, 15), (3, 64, 128, 16),
                                     (2, 65, 129, 17), (31, 130, 200, 10)])
def test_linreg_grad_masked_kernel_matches_plain(cuda, n, L, q, c):
    args = _t(*_grad_inputs(n, L, q, c), device=cuda)
    got = ops.linreg_grad_masked(*args)
    torch.cuda.synchronize()
    assert _max_rel_err(got, ref.linreg_grad_masked(*args)) < 1e-5


# linreg_grad_masked: 8-row slabs (4-row where c > 10 and q > 1024: c =
# 17), groups of them, q parts of 1024 (q <= 1024) or 2048 columns (q =
# 2049: two parts), 16-wide c chunks (c = 17); live counts at the slab
# edges, the last row's 6x the clients', as the coded round's
@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 10, 17])
@pytest.mark.parametrize("q", [129, 1024, 1025, 2000, 2049])
@pytest.mark.parametrize("live", [(1, 6), (3, 18), (4, 24), (5, 30),
                                  (7, 42), (8, 48), (9, 54), (21, 126),
                                  (130, 130)],
                         ids=lambda v: f"{v[0]}-{v[1]}")
def test_linreg_grad_masked_kernel_live_rows(cuda, live, q, c):
    """The kernel with live_rows against the plain version over every row,
    on inputs zero past them; reruns give the same bits."""
    arrays = _masked_zero_past(_grad_inputs(4, 130, q, c), *live)
    args = _t(*arrays, device=cuda)
    got = ops.linreg_grad_masked(*args, live_rows=live)
    again = ops.linreg_grad_masked(*args, live_rows=live)
    torch.cuda.synchronize()
    assert torch.equal(got, again)      # no atomics: reruns give the bits
    assert _max_rel_err(got, ref.linreg_grad_masked(*args)) < 1e-5


@pytest.mark.cuda
def test_linreg_grad_masked_kernel_at_the_coded_round_shape(cuda):
    """(31, 2400, 2000), c = 10, live rows (400, 2400): many groups a row
    and the combine launch."""
    arrays = _masked_zero_past(_grad_inputs(31, 2400, 2000, 10), 400, 2400)
    args = _t(*arrays, device=cuda)
    got = ops.linreg_grad_masked(*args, live_rows=(400, 2400))
    again = ops.linreg_grad_masked(*args, live_rows=(400, 2400))
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _max_rel_err(got, ref.linreg_grad_masked(*args)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("live", [None, (21, 126)], ids=["every", "live"])
def test_linreg_grad_masked_kernel_propagates_nan(cuda, live):
    """A NaN feature in a masked row inside the live range poisons that
    row's g_b; a NaN theta entry poisons that column of every g_b."""
    x, theta, y, mask = _masked_zero_past(_grad_inputs(4, 130, 300, 10),
                                          21, 126)
    mask[1, 7] = 0.0
    x[1, 7, 50] = np.nan
    args = _t(x, theta, y, mask, device=cuda)
    got = ops.linreg_grad_masked(*args, live_rows=live)
    torch.cuda.synchronize()
    want = ref.linreg_grad_masked(*args)
    assert torch.isnan(got[1]).all() and torch.isnan(want[1]).all()
    keep = [0, 2, 3]
    assert _max_rel_err(got[keep], want[keep]) < 1e-5
    args[0][1, 7, 50] = 0.0
    args[1][100, 2] = float("nan")
    got = ops.linreg_grad_masked(*args, live_rows=live)
    torch.cuda.synchronize()
    want = ref.linreg_grad_masked(*args)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[:, :, 2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,live", [(100, (17, 40)), (300, (1, 1)),
                                    (150, (9, 130))])
def test_linreg_grad_masked_kernel_chains_cross_rows(cuda, n, live):
    """More slabs than the card has SMs: each block's chain of slabs meets
    several rows, and the combine sums each row's segments."""
    arrays = _masked_zero_past(_grad_inputs(n, 130, 200, 10), *live)
    args = _t(*arrays, device=cuda)
    assert ops.masked_plan(n, 200, 10, live,
                           ops._sm_count(cuda.index or 0))[0] > 1
    got = ops.linreg_grad_masked(*args, live_rows=live)
    torch.cuda.synchronize()
    assert _max_rel_err(got, ref.linreg_grad_masked(*args)) < 1e-5


# parity_encode_batched: 128 x 128 tiles over K steps of 16 (two of 8) on
# the tensor cores, the narrow path for q <= 16; K not a multiple of 8,
# M and N at a tile edge +- 1, q not a multiple of 4 (4-byte copies), the
# label width q = 10, and a K that crosses the 16-step flush
@pytest.mark.cuda
@pytest.mark.parametrize("n,u,l,q", [
    (2, 127, 15, 127), (2, 128, 16, 128), (3, 129, 17, 129),
    (2, 255, 401, 257), (2, 130, 260, 130), (3, 200, 400, 10),
    (2, 129, 37, 16), (2, 33, 9, 17), (1, 64, 5, 3)])
def test_parity_encode_batched_kernel_edges(cuda, n, u, l, q):
    args = _t(*_parity_inputs(n, u, l, q), device=cuda)
    got = ops.parity_encode_batched(*args)
    again = ops.parity_encode_batched(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _max_rel_err(got, ref.parity_encode_batched(*args)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("q", [10, 130])
def test_parity_encode_batched_kernel_propagates_nan(cuda, q):
    """A NaN in one client's features or weights poisons that client's
    parity set where the plain version's is NaN, on the tensor-core path
    (q = 130) and on the narrow one (q = 10)."""
    g, w, x = _parity_inputs(3, 70, 37, q)
    x[1, 5, 7] = np.nan
    w[2, 11] = np.nan
    args = _t(g, w, x, device=cuda)
    got = ops.parity_encode_batched(*args)
    torch.cuda.synchronize()
    want = ref.parity_encode_batched(*args)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[1, :, 7]).all() and torch.isnan(got[2]).all()
    assert _max_rel_err(got[0], want[0]) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("u,l,q", [(129, 37, 130), (200, 400, 10),
                                   (2400, 400, 2000)])
def test_parity_encode_equals_the_batched_encode(cuda, u, l, q):
    """Each client's parity set is the same bits from the single-client
    entry point as from the batched one: the sum order of an output does
    not depend on n."""
    g, w, x = _t(*_parity_inputs(3, u, l, q), device=cuda)
    batched = ops.parity_encode_batched(g, w, x)
    for j in range(3):
        assert torch.equal(ops.parity_encode(g[j], w[j], x[j]), batched[j])


@pytest.mark.cuda
@pytest.mark.parametrize("n,u,l,q", [(2, 63, 15, 63), (2, 64, 16, 64),
                                     (3, 65, 17, 65), (4, 200, 40, 10)])
def test_parity_encode_batched_kernel_matches_plain(cuda, n, u, l, q):
    args = _t(*_parity_inputs(n, u, l, q), device=cuda)
    got = ops.parity_encode_batched(*args)
    torch.cuda.synchronize()
    assert _max_rel_err(got, ref.parity_encode_batched(*args)) < 1e-5


# the fused kernel: 112-row slabs (64, 32 or 16 where q is wide), 128-column
# embedding tiles, clusters of up to 8 CTAs of 256 or more columns, stages
# of 16 (f32) or 32 (bf16) of K, d padded to 16-byte rows by the wrapper
# where it is not one (d % 4 or, in bf16, d % 8), c chunks of 16.  Edges:
# tile and K edges, d % 16 and d % 32 != 0; clusters of 2 and 3 CTAs
# (q = 511, 512, 513), of 8 (q = 2000) and of 5 CTAs of 512 columns whose
# last tile lies past q (q = 2049); 32-row (q = 6200) and 16-row
# (q = 20000) slabs; c = 33 (three chunks); L = 1 and L one below, at and
# one above a slab (111, 112, 113)
_FUSED_EDGES = [(1, 63, 15, 63, 15), (1, 64, 16, 64, 16),
                (2, 65, 17, 65, 17), (3, 130, 784, 200, 10),
                (2, 130, 64, 511, 10), (2, 129, 48, 512, 17),
                (1, 65, 33, 513, 3), (2, 200, 784, 2000, 10),
                (1, 70, 24, 2049, 5), (1, 70, 16, 6200, 3),
                (1, 40, 8, 20000, 2), (2, 66, 40, 300, 33),
                (2, 1, 9, 300, 4), (2, 111, 40, 300, 5), (1, 112, 33, 257, 3),
                (2, 113, 31, 300, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parity", [False, True], ids=["clients", "parity"])
@pytest.mark.parametrize("n,L,d,q,c", _FUSED_EDGES)
def test_rff_linreg_grad_masked_kernel_matches_plain(cuda, n, L, d, q, c,
                                                     parity, dtype):
    arrays = _fused_inputs(n, L, d, q, c, parity)
    *args, pphi = [None if a is None else torch.from_numpy(a).to(cuda)
                   for a in arrays]
    if dtype == "bfloat16":
        args = [a if i == 5 else a.to(torch.bfloat16)
                for i, a in enumerate(args)]
        pphi = None if pphi is None else pphi.to(torch.bfloat16)
    got = ops.rff_linreg_grad_masked(*args, parity_phi=pphi)
    again = ops.rff_linreg_grad_masked(*args, parity_phi=pphi)
    torch.cuda.synchronize()
    assert torch.equal(got, again)      # no atomics: reruns give the bits
    want = ref.rff_linreg_grad_masked(*args, pphi, n_real=n)
    assert _max_rel_err(got, want) < 1e-4


def _fused_on(cuda, arrays, dtype):
    """The fused inputs on the card: x, omega, delta, theta, y in `dtype`,
    the mask float32, and the parity block."""
    *args, pphi = [None if a is None else torch.from_numpy(a).to(cuda)
                   for a in arrays]
    if dtype == "bfloat16":
        args = [a if i == 5 else a.to(torch.bfloat16)
                for i, a in enumerate(args)]
        pphi = None if pphi is None else pphi.to(torch.bfloat16)
    return args, pphi


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("parity", [False, True], ids=["clients", "parity"])
@pytest.mark.parametrize("live", _LIVE, ids=[f"{a}-{b}" for a, b in _LIVE])
@pytest.mark.parametrize("q", [200, 513])
def test_rff_linreg_grad_masked_kernel_live_rows(cuda, q, live, parity,
                                                 dtype):
    """Live counts of 1, a slab edge +- 1 and L: the kernel with live_rows
    against the plain version over every row, on inputs zero past them."""
    n = 2
    arrays = _zero_past(_fused_inputs(n, 130, 48, q, 17, parity), n, *live)
    args, pphi = _fused_on(cuda, arrays, dtype)
    got = ops.rff_linreg_grad_masked(*args, parity_phi=pphi, live_rows=live)
    again = ops.rff_linreg_grad_masked(*args, parity_phi=pphi,
                                       live_rows=live)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ref.rff_linreg_grad_masked(*args, pphi, n_real=n)
    assert _max_rel_err(got, want) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("live", [None, (70, 40)], ids=["every", "live"])
def test_rff_linreg_grad_masked_kernel_propagates_nan(cuda, live, dtype):
    """On the card, as in the plain version: a NaN feature in a masked live
    row poisons that client's g_b, and a NaN theta column poisons that
    column of every g_b."""
    n = 3
    arrays = _zero_past(_fused_inputs(n, 130, 48, 513, 5, True), n, 70, 40)
    arrays[5][1, 30] = 0.0
    arrays[0][1, 30, 7] = np.nan
    args, pphi = _fused_on(cuda, arrays, dtype)
    got = ops.rff_linreg_grad_masked(*args, parity_phi=pphi, live_rows=live)
    torch.cuda.synchronize()
    want = ref.rff_linreg_grad_masked(*args, pphi, n_real=n)
    assert torch.isnan(got[1]).all() and torch.isnan(want[1]).all()
    keep = [0, 2, 3]
    assert _max_rel_err(got[keep], want[keep]) < 1e-4
    args[3][100, 2] = float("nan")
    got = ops.rff_linreg_grad_masked(*args, parity_phi=pphi, live_rows=live)
    torch.cuda.synchronize()
    want = ref.rff_linreg_grad_masked(*args, pphi, n_real=n)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[:, :, 2]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("parity", [False, True], ids=["naive", "coded"])
def test_rff_linreg_grad_masked_kernel_at_the_round_shape(cuda, parity):
    """The coded round's shape, 30 clients' raw rows (30, 2400, 784) with
    q = 2000, c = 10, live rows (400, 2400) and the parity row; the naive
    round's, the same clients' 400 rows without it: against the plain
    version, and two launches give the same bits."""
    n = 30
    L = 2400 if parity else 400
    live = (400, L)
    arrays = _zero_past(_fused_inputs(n, L, 784, 2000, 10, parity), n, *live)
    args, pphi = _fused_on(cuda, arrays, "float32")
    prepared = ops.prepare_rff_operands(args[0], args[1])
    got = ops.rff_linreg_grad_masked(*args, parity_phi=pphi, live_rows=live,
                                     prepared=prepared)
    again = ops.rff_linreg_grad_masked(*args, parity_phi=pphi,
                                       live_rows=live, prepared=prepared)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = ref.rff_linreg_grad_masked(*args, pphi, n_real=n, live_rows=live)
    assert _max_rel_err(got, want) < 1e-4


@pytest.mark.cuda
def test_fused_round_prepares_once_and_launches_once_a_round(cuda):
    """A fused coded deployment on the card prepares X and Omega once, when
    it is built, and launches the fused kernel once a round: 10 rounds read
    PREPARES 1 and LAUNCHES 10."""
    from repro_torch import api, config
    rng = np.random.default_rng(0)
    n, l, d, c = 6, 16, 8, 3
    xs = (rng.normal(size=(n, l, d)) * 0.5).astype(np.float32)
    ys = rng.normal(size=(n, l, c)).astype(np.float32)
    spec = config.ExperimentSpec(
        fl=config.FLConfig(n_clients=n, delta=0.25, psi=0.3, seed=3),
        train=config.TrainConfig(learning_rate=0.5, l2_reg=1e-4,
                                 lr_decay_epochs=(5, 9)),
        scheme="coded", rff=config.RFFConfig(q=24, sigma=1.5, seed=7),
        fused_embed=True)
    ops.reset_launch_counts()
    exp = api.build_experiment(spec, xs, ys, device=cuda)
    exp.run(10)
    torch.cuda.synchronize()
    assert ops.PREPARES["rff_linreg_grad_masked"] == 1
    assert ops.LAUNCHES["rff_linreg_grad_masked"] == 10


# linreg_grad splits L over 32-row-or-longer splits: one split (m < 33),
# two, a ragged last split, the legacy client (400, 2000) and the parity set
# (2400, 2000); q one below, at and one above the 128-column tile, and q
# not a multiple of 4 (scalar residual loads)
@pytest.mark.cuda
@pytest.mark.parametrize("m,q,c", [(63, 127, 15), (64, 128, 16),
                                   (65, 129, 17), (2400, 200, 10),
                                   (31, 129, 10), (33, 130, 10),
                                   (1001, 64, 3), (70, 1025, 33),
                                   (400, 2000, 10), (2400, 2000, 10)])
def test_linreg_grad_kernel_matches_plain(cuda, m, q, c):
    x, theta, y, _ = _grad_inputs(1, m, q, c)
    args = _t(x[0], theta, y[0], device=cuda)
    got = ops.linreg_grad(*args)
    again = ops.linreg_grad(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)      # no atomics: reruns give the bits
    assert _max_rel_err(got, ref.linreg_grad(*args)) < 1e-5
    xs, th, ys = _t(x, theta, y, device=cuda)
    got = ops.linreg_grad_batched(xs, th, ys)
    torch.cuda.synchronize()
    assert _max_rel_err(got, ref.linreg_grad_batched(xs, th, ys)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("u,l,q", [(63, 15, 63), (64, 16, 64), (65, 17, 65),
                                   (200, 40, 10)])
def test_parity_encode_kernel_matches_plain(cuda, u, l, q):
    g, w, x = _parity_inputs(1, u, l, q)
    args = _t(g[0], w[0], x[0], device=cuda)
    got = ops.parity_encode(*args)
    torch.cuda.synchronize()
    assert _max_rel_err(got, ref.parity_encode(*args)) < 1e-5


@pytest.mark.cuda
def test_kernel_launches_are_counted(cuda):
    ops.reset_launch_counts()
    ops.rff_embed(*_t(*_rff_inputs(8, 4, 8), device=cuda))
    ops.parity_encode_batched(*_t(*_parity_inputs(2, 4, 3, 5), device=cuda))
    ops.linreg_grad_masked(*_t(*_grad_inputs(2, 5, 6, 2), device=cuda))
    x, theta, y, _ = _t(*_grad_inputs(2, 5, 6, 2), device=cuda)
    ops.linreg_grad_batched(x, theta, y)
    ops.linreg_grad(x[0], theta, y[0])
    g, w, xp = _t(*_parity_inputs(1, 4, 3, 5), device=cuda)
    ops.parity_encode(g[0], w[0], xp[0])
    ops.rff_linreg_grad_masked(*_t(*_fused_inputs(2, 5, 3, 6, 2, False)[:6],
                                   device=cuda))
    ops.gqa_decode(*_t(*_gqa_inputs(2, 4, 2, 8, 8, 20), device=cuda), 19)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"rff_embed": 1, "parity_encode_batched": 1,
                            "linreg_grad_masked": 2,
                            "rff_linreg_grad_masked": 1, "linreg_grad": 1,
                            "parity_encode": 1, "gqa_decode": 1}


# gqa_decode cuts T into 32-slot tiles and the tiles into runs
# (gqa_plan): T one below, at and one above a tile and a 128-slot multiple,
# a window, empty slots, a rolling cache, G = 1, 4, 8 and 16, hd_v != hd,
# the head dims at the kernel's limit, and head dims off the bf16 score
# mma (hd % 16 != 0) and off the 16-byte copies (hd or hd_v not a multiple
# of 16 bytes)
_GQA_EDGES = [
    (2, 8, 2, 64, 64, 31, 0, None, 30),
    (2, 8, 2, 64, 64, 32, 0, None, 31),
    (2, 8, 2, 64, 64, 33, 0, None, 32),
    (2, 8, 2, 64, 64, 127, 0, None, 126),
    (2, 8, 2, 64, 64, 128, 0, None, 127),
    (2, 8, 2, 64, 64, 129, 0, None, 128),
    (2, 12, 2, 24, 24, 65, 0, None, 64),                # hd % 16 = 8
    (1, 4, 2, 20, 15, 70, 0, None, 69),                 # 40- and 30-byte rows
    (1, 16, 4, 32, 32, 300, 48, None, 299),
    (2, 4, 4, 128, 128, 257, 0, None, 256),             # G = 1
    (2, 32, 4, 128, 128, 385, 0, None, 384),            # G = 8 (yi-6b)
    (2, 4, 4, 48, 32, 129, 0, None, 128),               # hd_v != hd
    (1, 16, 1, 256, 256, 200, 0, None, 199),            # G = 16, hd = 256
    (2, 8, 2, 32, 32, 96, 96, _rolling_positions(96, 245), 245),
    (2, 8, 2, 32, 32, 256, 100, np.r_[np.arange(192), -np.ones(64)], 191),
    (1, 4, 2, 16, 16, 130, 0, -np.ones(130), 129),     # no valid slot
    # the model zoo's other decode shapes at the tile edges: G = 7, hd 64
    # (internvl2); G = 1, hd 192, hd_v 128 (MLA); G = 1, hd 64 (whisper)
    (2, 14, 2, 64, 64, 31, 0, None, 30),
    (2, 14, 2, 64, 64, 32, 0, None, 31),
    (2, 14, 2, 64, 64, 33, 0, None, 32),
    (2, 14, 2, 64, 64, 129, 0, None, 128),
    (2, 16, 16, 192, 128, 31, 0, None, 30),
    (2, 16, 16, 192, 128, 32, 0, None, 31),
    (2, 16, 16, 192, 128, 33, 0, None, 32),
    (2, 16, 16, 192, 128, 129, 0, None, 128),
    (2, 8, 8, 64, 64, 33, 0, None, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,hd,hdv,T,window,k_pos,q_pos", _GQA_EDGES)
def test_gqa_decode_kernel_matches_plain(cuda, B, H, K, hd, hdv, T, window,
                                         k_pos, q_pos, dtype):
    q, k, v, kp = _t(*_gqa_inputs(B, H, K, hd, hdv, T, k_pos=k_pos),
                     device=cuda)
    if dtype == "bfloat16":
        q, k, v = (a.to(torch.bfloat16) for a in (q, k, v))
    got = ops.gqa_decode(q, k, v, kp, q_pos, window)
    again = ops.gqa_decode(q, k, v, kp, q_pos, window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and torch.equal(got, again)
    want = ref.gqa_decode(q, k, v, kp, q_pos, window)
    # float32: sums in another order; bfloat16: both sides round the same
    # float32 result to bf16, at most one ulp (2^-8 relative) apart
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert _max_rel_err(got.float(), want.float()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_gqa_decode_kernel_at_split_edges(cuda, delta, dtype):
    """T one below, at and one above 2 tiles times the plan's splits at the
    serving batch and KV heads (B = K = 8), on this card's SM count."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    want = ops.GQA_BLOCKS_PER_SM * n_sm // 64
    T = 2 * want * ops.GQA_TILE + delta
    assert ops.gqa_plan(8, 8, T, n_sm)[1] == (2 if delta <= 0 else 3)
    q, k, v, kp = _t(*_gqa_inputs(8, 32, 8, 128, 128, T), device=cuda)
    if dtype == "bfloat16":
        q, k, v = (a.to(torch.bfloat16) for a in (q, k, v))
    got = ops.gqa_decode(q, k, v, kp, T - 1)
    again = ops.gqa_decode(q, k, v, kp, T - 1)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    want_out = ref.gqa_decode(q, k, v, kp, T - 1)
    assert _max_rel_err(got.float(), want_out.float()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_kernel_nan_in_masked_slots(cuda, dtype):
    """A NaN in a masked slot's V row poisons its KV head's outputs (0 *
    NaN, as in the plain version); a NaN in a masked slot's K row does not
    (its score is -1e30 whatever it holds)."""
    q, k, v, kp = _gqa_inputs(2, 8, 2, 128, 128, 300, empty=0.0)
    kp[40] = -1
    kp[200] = -1
    v[0, 40, 1, 3] = np.nan
    k[1, 200, 0, 5] = np.nan
    q, k, v, kp = _t(q, k, v, kp, device=cuda)
    if dtype == "bfloat16":
        q, k, v = (a.to(torch.bfloat16) for a in (q, k, v))
    got = ops.gqa_decode(q, k, v, kp, 299)
    torch.cuda.synchronize()
    want = ref.gqa_decode(q, k, v, kp, 299)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[0, 4:, 3]).all() and not torch.isnan(got[1]).any()
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert _max_rel_err(got[1].float(), want[1].float()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_kernel_takes_an_unaligned_cache(cuda, dtype):
    """K and V one element past a 16-byte boundary take the element copies
    (and, in bf16, the FFMA scores) through the same ring."""
    q, k, v, kp = _t(*_gqa_inputs(2, 8, 2, 64, 64, 100), device=cuda)
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    q, k, v = (a.to(dt) for a in (q, k, v))
    k_off, v_off = (torch.empty(a.numel() + 1, dtype=dt, device=cuda)[1:]
                    .view(a.shape) for a in (k, v))
    k_off.copy_(k)
    v_off.copy_(v)
    assert k_off.data_ptr() % 16 != 0 and v_off.data_ptr() % 16 != 0
    got = ops.gqa_decode(q, k_off, v_off, kp, 99)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    want = ref.gqa_decode(q, k, v, kp, 99)
    assert _max_rel_err(got.float(), want.float()) < tol


@pytest.mark.cuda
def test_gqa_decode_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v, kp = _t(*_gqa_inputs(1, 34, 2, 16, 16, 8), device=cuda)
    with pytest.raises(ValueError, match="at most 16"):
        ops.gqa_decode(q, k, v, kp, 7)
    with pytest.raises(TypeError, match="int32"):
        ops.gqa_decode(q, k, v, kp.long(), 7)


# ------------------------------------- the hierarchical tier's shard shapes
# (n_s, u_s, l, q, c) of the tier's deployments: MNIST-RFF over 3 shards,
# launch.hier_scale's example (l = 8) and launch.scale.run_scale (l = 4):
# l = 4 and 8 against the 16-step K stage of the parity encode and the
# 8-row slabs of the masked gradient
_HIER_SHAPES = {"mnist_rff": (10, 800, 400, 2000, 10),
                "example": (1000, 1600, 8, 16, 3),
                "scale": (1000, 800, 4, 8, 2)}


def _prefix_mask(n, l, seed):
    """The tier's load-prefix masks: the first l*_j rows of each client."""
    loads = np.random.default_rng(seed).integers(0, l + 1, (n, 1))
    return (np.arange(l)[None, :] < loads).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(_HIER_SHAPES))
def test_parity_encode_batched_kernel_at_hier_shapes(cuda, shape):
    """The streamed shard encode: features and labels, reruns bit-equal."""
    n, u, l, q, c = _HIER_SHAPES[shape]
    g, w, x = _t(*_parity_inputs(n, u, l, q), device=cuda)
    (y,) = _t(_np((n, l, c), 5), device=cuda)
    for feat in (x, y):
        got = ops.parity_encode_batched(g, w, feat)
        again = ops.parity_encode_batched(g, w, feat)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        assert _max_rel_err(got, ref.parity_encode_batched(g, w, feat)) \
            < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(_HIER_SHAPES))
def test_linreg_grad_masked_kernel_at_hier_shapes(cuda, shape):
    """A shard's round: every row of (n_s, l, q) under the prefix mask."""
    n, _, l, q, c = _HIER_SHAPES[shape]
    x, theta, y, _ = _grad_inputs(n, l, q, c)
    args = _t(x, theta, y, _prefix_mask(n, l, 7), device=cuda)
    got = ops.linreg_grad_masked(*args)
    again = ops.linreg_grad_masked(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _max_rel_err(got, ref.linreg_grad_masked(*args)) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(_HIER_SHAPES))
def test_linreg_grad_kernel_at_hier_shapes(cuda, shape):
    """A shard's coded gradient over its (u_s, q) parity set."""
    _, u, _, q, c = _HIER_SHAPES[shape]
    args = _t(_np((u, q), 1, 0.3), _np((q, c), 2, 0.3), _np((u, c), 3),
              device=cuda)
    got = ops.linreg_grad(*args)
    again = ops.linreg_grad(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _max_rel_err(got, ref.linreg_grad(*args)) < 1e-5
