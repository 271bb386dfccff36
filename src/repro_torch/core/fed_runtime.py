"""Federated-learning runtime of the port: the flat engine.

The counterpart of ``repro.core.fed_runtime`` (the hierarchical tier is
`repro_torch.hier`).  The batched engine
(``engine="batched"``) runs the fused coded round (``fused_coded=True``:
the parity set is one more row of the round's single gradient launch) or
the unfused one (``fused_coded=False``: a separate ``linreg_grad``
launch over the parity set, guarded), over embedded client features or,
with ``fused_embed=True``, over RAW ones that the
``rff_linreg_grad_masked`` kernel embeds tile by tile every round:

  * the scheme's setup runs on the host (allocation, subsets, weights) and
    on the device (parity encode, dense client tensors);
  * runs are block-structured, as in the reference: ``run(iterations)`` is
    ``init_state`` then ``run_block`` calls over an explicit
    `repro_torch.core.run_state.RunState`, then ``finish``.  A block is
    ``spec.checkpoint_every`` rounds (0: the whole horizon in one block).
    Each block draws its delays with one vectorized ``sample_round_times``
    call on a generator restored from the state, so ``save_state`` /
    ``restore_state`` (`repro_torch.checkpoint.io`, the reference's file
    format) give a kill/resume at any block boundary that is bit-identical
    to the uninterrupted blocked run;
  * the reference's ``lax.scan`` becomes a Python loop over a block's
    rounds.  Each round is one ``linreg_grad_masked`` launch over the
    dense (rows, L, q) tensor (``rff_linreg_grad_masked`` over the raw
    (n, L, d) one with ``fused_embed``), the returned-mask sum and the
    guarded SGD update, all on the device; the host reads the per-round
    records back once a block;
  * ``run_multi(iterations, R)`` draws R * K delay rows a block, as the
    reference's vmapped scan takes them, and runs the realizations one
    after another through the same step (``MultiFedResult``, the Fig. 4/5
    confidence bands).

Client mesh (``spec.mesh = k``, or the ``mesh`` override of
``build_experiment``: an int or a `repro_torch.launch.mesh.ClientMesh`):
the batched engine's client axis is sharded over the first k ranks of a
``torch.distributed`` group, SPMD.  Every rank builds the same deployment
(the host work is deterministic from the seeds, so delays, allocation,
returned counts and the wall clock are the same bits on every rank), pads
the client rows to a multiple of k with zero rows (returned-mask entry
0.0, so they add nothing) and keeps rows ``[r s, (r + 1) s)``.  A round
launches the masked gradient on those rows, guards and sums them, and one
``all_reduce`` of the (sum, count) pair, packed in one float32 buffer,
replaces the reference's psum; every rank then applies the same update,
so theta is the same bits on every rank.  The unfused coded parity
gradient stays replicated, outside the reduction.  Adaptive schemes,
return faults and ``fused_embed`` are refused with a mesh, as in the
reference; the legacy engine ignores it (every rank runs the whole
per-client loop), and a sweep replays the spec's mesh.  Under a mesh only
rank 0 writes checkpoints and journals, and every rank learns each
checkpoint write's outcome (so every rank can restore the same file, and
a failed write raises on every rank).

Network dynamics (``spec.channel_profile``, ``repro_torch.net``): a block's
delays are drawn *through* a deterministic per-seed channel trace
(Gilbert–Elliott erasure bursts, shadowing and MCS rate hopping, compute
drift, churn), chained across blocks by the state's `TraceState`, and the
round takes a per-round availability row.  The static profile reproduces
the stationary run bit for bit.  The adaptive schemes (``adaptive_coded``,
``adaptive_greedy``) plan each block on the host first
(`repro_torch.net.estimator.plan_segment`: online (mu, tau, p) estimation
from round telemetry, the allocation re-solved every ``adapt_every``
rounds); the plan's per-round arrays go to the device once a block, and
adaptive_coded's per-sub-block load masks are one stacked tensor that the
round indexes, so no round syncs with the host.  ``run_multi`` under a
channel runs one whole realization a block, each with its own trace.

``engine="legacy"`` is the reference's per-client oracle: a host loop with
no guards and no run state, one ``linreg_grad`` launch per returned loaded
client plus one for the coded gradient (coded), or one mask-free
``linreg_grad_batched`` launch (naive, greedy, ideal), on delays drawn by
the same ``sample_round_times`` call from the same generator as the batched
run.

Delays go to float32 before the step and deadlines are compared in float32,
as in the reference, so returned counts and the wall clock
(``setup_time + cumsum`` in float64 of the float32 round times) are
bit-identical to it.

The non-finite guard (``spec.nonfinite_guard``) zeroes non-finite gradient
rows out of the weighted sum and counts them; the always-on divergence
guard never commits a non-finite iterate (the round is skipped and the lr
backs off by `LR_BACKOFF`).  Both are no-ops on clean rounds.

Return faults (``spec.fault_profile``, `repro_torch.faults`): NaN/inf
uploads, stale-update replay and a corrupted parity contribution enter the
round as two more per-round inputs, drawn a block at a time from a stream
of their own (``fl.seed + 7717``, kept in the `RunState`), so they never
shift the delays; a block's fault codes go to the device once, as
tensors.  Under stale replay every round takes a second masked sum at the
previous iterate over the stale rows, whatever the codes say, so no round
reads the codes on the host.

Telemetry (`repro_torch.obs`): with spans enabled, the setup, the solver,
the parity encode, trace generation, each block of the step
(``scan/compile`` for the first, ``scan/execute`` after: the port has no
compiled scan, see `repro_torch.obs.spans`), checkpoint saves and
restores are timed; a block's span syncs the device once before its
clock stops.  The host delay arrays a block already drew are kept for
`Experiment.attribution`, and ``run(journal_dir=...)`` journals each
block's rounds after its checkpoint.  None of it draws or reads a value
back, so a run is the same bits with telemetry on or off.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.config import ExperimentSpec
from repro_torch.core import aggregation, rff, schemes
from repro_torch.core.delay_model import (mec_network, packet_bits,
                                          sample_round_times, scale_tau)
from repro_torch.core.load_allocation import vectorized_grid_width
from repro_torch.core.run_state import RunState, pack_state, unpack_state
from repro_torch.device import resolve_device
from repro_torch.faults import inject as finject
from repro_torch.kernels import ops
from repro_torch.net.channel import CHANNEL_PROFILES
from repro_torch.net.estimator import (AdaptiveSchedule,
                                       OnlineChannelEstimator, plan_segment)
from repro_torch.net.trace import (TraceState, generate_trace_block,
                                   sample_round_times_traced)
from repro_torch.obs import spans as obs_spans

#: divergence-guard learning-rate backoff per skipped round
LR_BACKOFF = 0.5


@dataclasses.dataclass
class RoundLog:
    iteration: int
    wall_clock: float          # cumulative simulated seconds
    returned: int              # clients that made the deadline
    loss: float
    accuracy: float
    n_masked: int = 0          # contributions masked by the finite guard
    skipped: int = 0           # 1 if the divergence guard skipped the round


@dataclasses.dataclass
class RunHealth:
    """Degradation counters of a completed run (see the reference's
    ``RunHealth``): rounds with a masked contribution, masked
    contributions in all, divergence-guard skips, final lr multiplier."""
    rounds_degraded: int
    returns_masked: int
    rounds_skipped: int
    lr_scale: float


@dataclasses.dataclass
class FedResult:
    theta: torch.Tensor        # (q, c), on the experiment's device
    history: list[RoundLog]
    t_star: float | None = None
    loads: np.ndarray | None = None
    setup_time: float = 0.0    # parity upload overhead (coded only)
    privacy_eps: float | None = None
    health: RunHealth | None = None


@dataclasses.dataclass
class MultiFedResult:
    """One deployment, R independent delay realizations.

    theta: (R, q, c) final iterates; wall_clock / returned: (R, iterations)
    cumulative simulated seconds (incl. setup) and per-round return counts.
    """
    theta: torch.Tensor
    wall_clock: np.ndarray
    returned: np.ndarray
    t_star: float | None = None
    loads: np.ndarray | None = None
    setup_time: float = 0.0
    accuracy: np.ndarray | None = None   # (R,) if an eval_fn was supplied
    privacy_eps: float | None = None
    health: RunHealth | None = None      # over all realizations

    def wall_clock_bands(self) -> tuple[np.ndarray, np.ndarray]:
        """(mean, std) over realizations, each (iterations,): the Fig. 4/5
        curve with its confidence band."""
        return (self.wall_clock.mean(axis=0), self.wall_clock.std(axis=0))


def guard_and_sum(g, ret, guard: bool, bad=None):
    """((q, c) returned-masked sum of the (rows, q, c) gradients `g`,
    int32 count of masked contributions).

    `bad` (rows,) carries injected fault values: a non-finite entry
    replaces the whole gradient row of a client that returned (a client
    past the deadline uploads nothing, corrupt or not); finite entries
    leave rows untouched (a `where`, never an add, so -0.0 survives).
    With `guard` every non-finite gradient row is zeroed out of the sum and
    counted when its client returned; on an all-finite round this is a
    no-op (``where(True, g, 0) == g``).
    """
    if bad is not None:
        live_bad = torch.where(ret > 0.0, bad, 0.0)
        g = torch.where(torch.isfinite(live_bad)[:, None, None], g,
                        live_bad[:, None, None])
    if not guard:
        return (aggregation.masked_gradient_sum(g, ret),
                torch.zeros((), dtype=torch.int32, device=g.device))
    finite = torch.isfinite(g).flatten(1).all(dim=1)
    n_masked = ((ret > 0.0) & ~finite).sum().to(torch.int32)
    g = torch.where(finite[:, None, None], g, 0.0)
    return aggregation.masked_gradient_sum(g, ret), n_masked


def reduce_pair(mesh, g_sum, n_masked):
    """The reference's psum of the (sum, count) pair over the client mesh:
    one all-reduce of a float32 buffer holding the (q, c) sum and the
    count (exact below 2**24)."""
    buf = torch.cat([g_sum.reshape(-1),
                     n_masked.to(torch.float32).reshape(1)])
    mesh.all_reduce_(buf)
    return buf[:-1].view(g_sum.shape), buf[-1].to(torch.int32)


def _kth_present(t_row, active, k, n: int):
    """The k-th fastest delay among the clients present (0 when none is):
    the channel greedy deadline, k clipped to [1, min(k, present)].  The
    count and the index stay on the device (a gather, no host sync)."""
    srt = torch.sort(torch.where(active > 0, t_row, math.inf)).values
    n_act = active.sum().to(torch.int32)
    k_eff = torch.clamp(torch.clamp(n_act, max=k), 1, n)
    kth = srt.gather(0, (k_eff - 1).to(torch.int64).reshape(1))[0]
    return torch.where(n_act > 0, kth, 0.0)


def _shard_live_rows(live, parity_row, lo: int, hi: int) -> tuple:
    """The masked kernel's ``live_rows`` for rows [lo, hi) of a padded
    client axis.  The kernel reads ``live[1]`` rows of its last row and
    ``live[0]`` of the others; unsharded, the last row is the fused coded
    parity row (``parity_row``, None without one).  A shard whose last
    row is the parity row keeps the pair, one without it reads
    ``live[0]`` everywhere (zero padding rows need nothing), and one that
    holds it elsewhere reads the larger count everywhere."""
    lc, lp = live
    if parity_row is None or not lo <= parity_row < hi:
        return (lc, lc)
    if parity_row == hi - 1:
        return (lc, lp)
    return (max(lc, lp),) * 2


def build_step(static: dict):
    """One round ``step(consts, carry, inp) -> (carry, out)``.

    `static`: scheme (step kind), n, n_wait, l2, m, l, guard, fused,
    fused_embed, channel, faults, stale, mesh.
    `consts`: gx (rows, L, q), gy (rows, L, c), gmask (rows, L), ret_tail
    (rows - n,); coded adds t_star () and active (n,) and, when unfused,
    par_x (u, q) / par_y (u, c), and when fused live_rows (l_max, u), the
    rows of the client rows and of the parity row that are not zero
    padding; ideal adds t_ideal ().  adaptive_coded adds gmask_blocks
    (B, rows, L), one mask a sub-block of the plan, and its live_rows are
    (l, u): its client rows hold every point in priority order.  With
    fused_embed gx is the raw (n, L, d) tensor, and omega (d, q), delta
    (q,) and, on the fused coded round, pphi (L, q) come along.
    ``carry`` is ``(theta, lr_scale)``; ``inp`` is ``(t_row, lr)``, the
    round's float32 delays (n,) and learning rate.  With ``channel`` (a
    network trace drives the run) it grows the round's float32
    availability row: ``(t_row, lr, active)``; churned-out clients never
    count as returned, and the naive/greedy deadlines range over the
    clients present.  adaptive_coded takes ``(t_row, lr, active, t_star_r,
    block)``: the sub-block's float32 deadline and the host int that picks
    its mask; adaptive_greedy ``(t_row, lr, active, n_wait_r)``, the
    sub-block's wait count as a host int.  Under the static profile
    `active` is all ones and every extra operation is an IEEE no-op, so
    the trajectory is the stationary one bit for bit.
    With ``faults`` (`repro_torch.faults`) two fault inputs ride at the END
    of ``inp``, for every step kind: ``(..., fcode, fpar)``, the round's
    (n,) int32 fault codes and its () float32 corrupted-parity flag.  The
    fused coded parity row (the first pseudo-row) and the unfused coded
    parity gradient corrupt on ``fpar``.  With ``stale`` (stale-update
    replay) the carry grows the iterate the round started from,
    ``(theta, lr_scale, theta_prev)``, and the round takes a second masked
    sum at theta_prev over the stale rows (a second gradient launch).
    With a ``mesh`` (`repro_torch.launch.mesh.ClientMesh`) the consts'
    gx, gy and gmask are this rank's s rows of the padded client axis,
    ret_tail runs to the padded length, and each masked sum covers the
    rank's rows only, then `reduce_pair` sums the shards.
    ``out`` is ``(t_round, n_ret, n_masked, skipped)``, 0-dim tensors.
    """
    scheme = static["scheme"]
    n = static["n"]
    n_wait = static["n_wait"]
    l2 = static["l2"]
    m = static["m"]
    l = static["l"]
    guard = static["guard"]
    fused = static["fused"]
    fused_embed = static["fused_embed"]
    channel = static["channel"]
    faults = static["faults"]
    stale = static["stale"]
    mesh = static["mesh"]

    def step(consts, carry, inp):
        if stale:
            theta, lr_scale, theta_prev = carry
        else:
            theta, lr_scale = carry
        if faults:
            *inp, fcode, fpar = inp
        gmask = consts["gmask"]
        if scheme == "adaptive_coded":
            t_row, lr, active, t_star_r, block = inp
        elif scheme == "adaptive_greedy":
            t_row, lr, active, n_wait_r = inp
        elif channel:
            t_row, lr, active = inp
        else:
            t_row, lr = inp
        if scheme == "naive":
            if channel:
                ret_real = active
                n_ret = active.sum().to(torch.int32)
                t_round = torch.where(active > 0, t_row, 0.0).max()
            else:
                n_ret = torch.full((), n, dtype=torch.int32,
                                   device=t_row.device)
                t_round = t_row.max()
                ret_real = torch.ones_like(t_row)
            denom = m
        elif scheme in ("greedy", "adaptive_greedy"):
            if scheme == "adaptive_greedy":
                t_round = _kth_present(t_row, active, n_wait_r, n)
            elif channel:
                t_round = _kth_present(t_row, active, n_wait, n)
            else:
                t_round = torch.sort(t_row).values[n_wait - 1]
            ret_real = (t_row <= t_round).to(t_row.dtype)
            if channel:
                ret_real = ret_real * active
            n_ret = ret_real.sum().to(torch.int32)
            denom = n_ret.clamp(min=1).to(torch.float32) * l
        elif scheme == "coded":
            t_round = consts["t_star"]
            by_deadline = (t_row <= t_round).to(t_row.dtype)
            ret_real = by_deadline * consts["active"]
            if channel:
                by_deadline = by_deadline * active
                ret_real = ret_real * active
            n_ret = by_deadline.sum().to(torch.int32)
            denom = m
        elif scheme == "ideal":
            # deterministic no-straggler floor: all clients, full load,
            # fixed round clock (the sampled t_row is ignored)
            t_round = consts["t_ideal"]
            ret_real = active if channel else torch.ones_like(t_row)
            n_ret = ret_real.sum().to(torch.int32)
            denom = m
        elif scheme == "adaptive_coded":
            t_round = t_star_r
            ret_real = (t_row <= t_star_r).to(t_row.dtype) * active
            n_ret = ret_real.sum().to(torch.int32)
            gmask = consts["gmask_blocks"][block]
            denom = m
        else:
            raise ValueError(scheme)
        # ret_tail covers the pseudo-client rows: the always-active parity
        # row of the fused coded tensor
        ret = torch.cat([ret_real.to(torch.float32), consts["ret_tail"]])
        tail = consts["ret_tail"]
        bad = None
        if faults:
            # the injected value of each row: NaN/inf garbage where the
            # code says so, 0.0 (the row untouched) where clean; the fused
            # coded parity pseudo-row corrupts on the round's flag
            nan = torch.full_like(fpar, math.nan)
            bad_client = torch.where(
                fcode == finject.CODE_NAN, nan,
                torch.where(fcode == finject.CODE_INF,
                            torch.full_like(fpar, math.inf), 0.0))
            tail_bad = torch.zeros_like(tail)
            if fused and scheme in ("coded", "adaptive_coded") \
                    and len(tail):
                tail_bad = torch.cat([torch.where(fpar > 0, nan, 0.0)[None],
                                      tail_bad[1:]])
            bad = torch.cat([bad_client, tail_bad])

        def sum_at(th, ret_v, bad_v=bad):
            if mesh is not None:
                # this rank's rows of the padded client axis
                s = consts["gx"].shape[0]
                lo = mesh.rank * s
                ret_v = ret_v[lo:lo + s]
                bad_v = None if bad_v is None else bad_v[lo:lo + s]
            if fused_embed:
                g = aggregation.fused_embed_client_gradients(
                    consts["gx"], consts["gy"], consts["omega"],
                    consts["delta"], th, mask=gmask,
                    parity_phi=consts.get("pphi"),
                    live_rows=consts.get("live_rows"))
            else:
                g = aggregation.batched_client_gradients(
                    consts["gx"], consts["gy"], th, mask=gmask,
                    live_rows=consts.get("live_rows"))
            g_sum, n_masked = guard_and_sum(g, ret_v, guard, bad_v)
            if mesh is not None and mesh.size > 1:
                g_sum, n_masked = reduce_pair(mesh, g_sum, n_masked)
            return g_sum, n_masked

        if stale:
            # stale-replay clients return their gradient at the PREVIOUS
            # iterate: the returned mask splits into fresh and stale rows,
            # and a second masked sum runs at theta_prev (the parity row is
            # server-side and always fresh)
            stale_f = (fcode == finject.CODE_STALE).to(torch.float32)
            stale_full = torch.cat([stale_f, torch.zeros_like(tail)])
            g_fresh, m_fresh = sum_at(theta, ret * (1.0 - stale_full))
            g_stale, m_stale = sum_at(theta_prev, ret * stale_full)
            g_sum = g_fresh + g_stale
            n_masked = m_fresh + m_stale
        else:
            g_sum, n_masked = sum_at(theta, ret)
        if scheme == "coded" and not fused:
            g_par = aggregation.coded_gradient(consts["par_x"],
                                               consts["par_y"], theta)
            if faults:
                par_bad = torch.where(fpar > 0, math.nan, 0.0)
                g_par = torch.where(torch.isfinite(par_bad), g_par, par_bad)
            if guard:
                par_ok = torch.isfinite(g_par).all()
                n_masked = n_masked + (~par_ok).to(torch.int32)
                g_par = torch.where(par_ok, g_par, 0.0)
            g_sum = g_sum + g_par
        theta_upd = theta - (lr * lr_scale) * (g_sum / denom + l2 * theta)
        # always-on divergence guard: a non-finite iterate is never
        # committed — the round is skipped (model held), the lr backs off
        ok = torch.isfinite(theta_upd).all()
        theta_new = torch.where(ok, theta_upd, theta)
        lr_scale_new = torch.where(ok, lr_scale, lr_scale * LR_BACKOFF)
        skipped = (~ok).to(torch.int32)
        carry_new = ((theta_new, lr_scale_new, theta) if stale
                     else (theta_new, lr_scale_new))
        return carry_new, (t_round, n_ret, n_masked, skipped)

    return step


def run_rounds(step, consts, carry, xs, eval_at=None):
    """The reference's ``lax.scan`` as a Python loop: one `build_step` step
    a round from `carry`, on the device.  `xs` holds the step's per-round
    inputs (see `build_step`), each a (K, ...) tensor on the device or a
    host list: round k's ``inp`` is ``tuple(col[k] for col in xs)``.
    ``eval_at(k, theta)`` sees each round's new iterate.  Returns the final
    carry and the (K,) per-round columns (t_round, n_ret, n_masked,
    skipped), still on the device."""
    outs = []
    for k in range(len(xs[0])):
        carry, out = step(consts, carry, tuple(col[k] for col in xs))
        outs.append(out)
        if eval_at is not None:
            eval_at(k, carry[0])
    return carry, [torch.stack(col) for col in zip(*outs)]


def _empty_sched(n: int) -> dict:
    """Zero-length adaptive-schedule record (the keys of
    `repro_torch.core.run_state.SCHED_KEYS`); blocks append to it with
    `_append_sched`, `Experiment._assemble_schedule` turns the finished
    record into an `AdaptiveSchedule`."""
    return {
        "times": np.zeros((0, n), np.float64),
        "active": np.zeros((0, n), np.float32),
        "block_idx": np.zeros(0, np.int32),
        "t_star_r": np.zeros(0, np.float32),
        "n_wait_r": np.zeros(0, np.int32),
        "loads_blocks": np.zeros((0, n), np.float64),
        "est_mu": np.zeros((0, n), np.float64),
        "est_tau": np.zeros((0, n), np.float64),
        "est_p": np.zeros((0, n), np.float64),
        "est_avail": np.zeros((0, n), np.float64),
        "est_rounds_seen": np.zeros(0, np.int64),
    }


def _append_sched(sched: dict, seg) -> dict:
    """Append one `SegmentPlan`'s record to a schedule dict, offsetting
    the segment-local block indices onto the run-global block axis."""
    b0 = sched["loads_blocks"].shape[0]
    est = seg.estimates
    out = {
        "times": seg.times, "active": seg.active,
        "block_idx": (seg.block_idx + b0).astype(np.int32),
        "t_star_r": seg.t_star_r, "n_wait_r": seg.n_wait_r,
        "loads_blocks": seg.loads_blocks,
        "est_rounds_seen": np.array([e["rounds_seen"] for e in est],
                                    np.int64),
    }
    for key in ("mu", "tau", "p", "avail"):
        out[f"est_{key}"] = np.stack([e[key] for e in est])
    return {key: np.concatenate([sched[key], val])
            for key, val in out.items()}


class Experiment:
    """One runnable FL deployment, built from a frozen `ExperimentSpec`.

    Clients hold equally sized local minibatches of RFF-embedded data
    (x_stack: (n, l, q), y_stack: (n, l, c)) or, with ``spec.fused_embed``,
    of RAW features (x_stack: (n, l, d)), q then coming from ``spec.rff``;
    the delay network follows paper §V-A.  The spec names a registered
    scheme (``repro_torch.core.schemes``) that owns the deployment setup.

    ``device`` defaults to the GPU; pass ``"cpu"`` to run the plain
    versions of the kernels.  ``parity_generators`` (n, u, l) replaces the
    coded family's own generator draw, ``rff_draw`` = (omega (d, q),
    delta (q,)) the fused_embed path's own draw from ``spec.rff``, and
    ``secure_masks`` = (x masks (P, u, q), y masks (P, u, c)), one a
    client pair, the secure-aggregation setup's own mask draws (see
    ``repro_torch.carry``).  ``mesh`` (an int or a
    `repro_torch.launch.mesh.ClientMesh`) overrides ``spec.mesh`` and
    shards the batched engine's client axis over ranks (see the module
    docstring); its device (``cuda:{rank % device_count}``) is the
    default one.

    Prefer the entrypoint ``repro_torch.api.build_experiment``.
    """

    def __init__(self, spec: ExperimentSpec, x_stack, y_stack, *,
                 nodes: Optional[list] = None,
                 rng: Optional[np.random.Generator] = None,
                 device=None, parity_generators=None, rff_draw=None,
                 secure_masks=None, mesh=None):
        if not isinstance(spec, ExperimentSpec):
            raise TypeError(
                f"spec must be an ExperimentSpec, got {type(spec).__name__}"
                " (build one with repro_torch.config.ExperimentSpec)")
        if spec.hier_active:
            raise ValueError(
                f"spec requests the hierarchical tier (hier_shards="
                f"{spec.hier_shards}, sample_fraction="
                f"{spec.sample_fraction}) but was passed to the flat "
                "engine; build it with repro_torch.api.build_experiment, "
                "which routes hier-active specs to "
                "repro_torch.hier.HierExperiment")
        self.spec = spec
        fl_cfg = spec.resolved_fl()      # delay-profile knobs applied
        self.mesh = self._resolve_mesh(spec.mesh if mesh is None else mesh)
        if self.mesh is not None and not self.mesh.member:
            raise ValueError(
                f"rank {self.mesh.rank} is not one of the {self.mesh.size} "
                "ranks of the client mesh; build the experiment on ranks "
                f"0..{self.mesh.size - 1} only")
        self.device = resolve_device(
            self.mesh.device if device is None and self.mesh is not None
            else device)
        self.alloc_backend = spec.alloc_backend
        self.engine = spec.engine
        self.fused_coded = spec.fused_coded
        self.fused_embed = spec.fused_embed
        self.nonfinite_guard = bool(spec.nonfinite_guard)
        # return faults (repro_torch.faults) enter the step through a
        # stream of their own; the service-level knobs act in
        # repro_torch.launch.service
        self.faults = spec.resolved_faults()
        self.return_faults = (self.faults is not None
                              and self.faults.has_return_faults)
        self.stale_faults = (self.faults is not None
                             and self.faults.stale_prob > 0.0)
        self._fault_seed = fl_cfg.seed + 7717
        self.secure_aggregation = spec.secure_aggregation
        self.checkpoint_every = spec.checkpoint_every
        self.scheme = spec.resolved_scheme
        self.scheme_obj = schemes.get_scheme(self.scheme)
        self.step_kind = self.scheme_obj.step_kind
        self.scheme_params = spec.scheme_params_dict
        # network dynamics (repro_torch.net): channel trace + adaptation
        self.channel = spec.resolved_channel()
        self.adapt_every = spec.adapt_every
        self.adaptive = self.step_kind.startswith("adaptive")
        if self.adaptive:
            if self.engine == "legacy":
                raise ValueError(
                    f"scheme {self.scheme!r} needs the batched engine "
                    "(the legacy oracle has no adaptive schedule path)")
            if self.mesh is not None:
                raise NotImplementedError(
                    "adaptive schemes do not support client-mesh "
                    "sharding yet")
            if self.adapt_every < 1:
                raise ValueError(
                    f"scheme {self.scheme!r} requires "
                    "ExperimentSpec.adapt_every >= 1 (the re-allocation "
                    "period in rounds)")
            if self.channel is None:
                # adaptation without declared dynamics runs on the exact
                # static profile
                self.channel = CHANNEL_PROFILES["static"]
        if self.return_faults and self.mesh is not None:
            # the spec refuses spec.mesh with return faults; this catches
            # the build_experiment(..., mesh=...) override too
            raise NotImplementedError(
                "return-fault injection does not support client-mesh "
                "sharding yet (crash/checkpoint faults are fine)")
        if (self.checkpoint_every > 0 and self.adaptive
                and self.checkpoint_every % self.adapt_every != 0):
            raise ValueError(
                f"checkpoint_every={self.checkpoint_every} must be a "
                f"multiple of adapt_every={self.adapt_every} so checkpoint "
                "boundaries align with re-allocation blocks")
        if self.fused_embed and self.adaptive:
            raise NotImplementedError(
                f"scheme {self.scheme!r} does not support fused_embed yet "
                "(adaptive re-allocation assumes embedded tensors)")
        if self.fused_embed and self.mesh is not None:
            raise NotImplementedError(
                "fused_embed does not support client-mesh sharding yet")
        self._trace_seed = fl_cfg.seed + 9973
        # trace-stream reservation cursor: a single run reserves one stream
        # index, a traced run_multi one per realization.  The reserved
        # index lives in the run's RunState, so replaying a restored state
        # is hermetic; this counter only hands fresh streams to NEW runs
        self._trace_calls = 0
        self.last_schedule = None     # AdaptiveSchedule of the latest run
        self.fl = fl_cfg
        self.train = spec.train
        self.x = torch.as_tensor(x_stack, dtype=torch.float32,
                                 device=self.device).contiguous()
        self.y = torch.as_tensor(y_stack, dtype=torch.float32,
                                 device=self.device).contiguous()
        self.parity_generators = (
            None if parity_generators is None else torch.as_tensor(
                parity_generators, dtype=torch.float32,
                device=self.device).contiguous())
        if secure_masks is not None and not self.secure_aggregation:
            raise ValueError("secure_masks replaces the secure-aggregation "
                             "setup's mask draws; the spec has "
                             "secure_aggregation=False")
        self.secure_masks = (None if secure_masks is None else tuple(
            torch.as_tensor(m, dtype=torch.float32,
                            device=self.device).contiguous()
            for m in secure_masks))
        if self.fused_embed:
            self.n, self.l, self.d = self.x.shape
            self.q = spec.rff.q
            self.omega, self.delta = self._rff_params(spec, rff_draw)
        else:
            if rff_draw is not None:
                raise ValueError("rff_draw replaces the fused_embed path's "
                                 "(Omega, delta); the spec has "
                                 "fused_embed=False")
            self.n, self.l, self.q = self.x.shape
            self.d = None
            self.omega = self.delta = None
        self.c = self.y.shape[-1]
        self.m = self.n * self.l
        self.steps_per_epoch = spec.steps_per_epoch
        self.rng = rng or np.random.default_rng(fl_cfg.seed + 17)

        # delay network (tau scaled to the actual gradient/model packet)
        base_nodes = nodes or mec_network(fl_cfg,
                                          d_scalars_per_point=self.q * self.c)
        payload = packet_bits(fl_cfg, self.q * self.c)   # model == gradient
        self.nodes = [scale_tau(nd, payload) for nd in base_nodes[:self.n]]

        self.t_star = None
        self.t_ideal = None
        self.loads = np.full(self.n, self.l, dtype=np.float64)
        self.parity = None
        self.setup_time = 0.0
        self.processed_idx = [np.arange(self.l) for _ in range(self.n)]
        # telemetry capture (repro_torch.obs): per-block host delay arrays
        # kept only while spans are enabled, feeding `attribution()`
        self._attr_blocks: "list[dict]" = []
        with obs_spans.span("setup/experiment", sync=self.device):
            self.scheme_obj.setup(self)
        self.privacy_eps = self.scheme_obj.privacy_budget(self)
        self._consts = None     # built lazily on the first run
        self._step = None
        self._step_warm = False   # a block of the cached step has run

    @staticmethod
    def _resolve_mesh(mesh):
        """None, or the `ClientMesh` of `mesh` (a rank count, through
        `repro_torch.launch.mesh.make_client_mesh`, or a mesh object),
        which must have the one axis ``"clients"``."""
        if mesh is None:
            return None
        from repro_torch.launch.mesh import CLIENT_AXIS, make_client_mesh
        if isinstance(mesh, int):
            mesh = make_client_mesh(mesh)
        if tuple(mesh.axis_names) != (CLIENT_AXIS,):
            raise ValueError(
                f"mesh must have exactly one axis named {CLIENT_AXIS!r}, "
                f"got {mesh.axis_names}")
        return mesh

    @property
    def _writes(self) -> bool:
        """Whether this process writes checkpoints and journals: always,
        and under a mesh on rank 0 only."""
        return self.mesh is None or self.mesh.rank == 0

    def _rff_params(self, spec: ExperimentSpec, rff_draw):
        """(Omega (d, q), delta (q,)) of the fused_embed path: `rff_draw`
        where given, else the port's own draw from ``spec.rff``."""
        if rff_draw is None:
            return rff.rff_params(spec.rff, self.d, device=self.device)
        omega, delta = (torch.as_tensor(t, dtype=torch.float32,
                                        device=self.device).contiguous()
                        for t in rff_draw)
        if (tuple(omega.shape) != (self.d, self.q)
                or tuple(delta.shape) != (self.q,)):
            raise ValueError(
                f"rff_draw has shapes {tuple(omega.shape)} and "
                f"{tuple(delta.shape)}; the deployment needs (d, q) = "
                f"{(self.d, self.q)} and (q,) = {(self.q,)}")
        return omega, delta

    @property
    def n_wait(self) -> int:
        """Greedy wait count: the fastest (1 - psi) * n clients."""
        return max(1, int(math.ceil((1.0 - self.fl.psi) * self.n)))

    def embedded_x(self) -> torch.Tensor:
        """Transient (n, l, q) embedded stack for setup only (parity
        encoding, privacy accounting): one ``rff_embed`` launch.  The
        fused_embed round never makes it: phi is computed tile by tile
        inside the gradient kernel every round."""
        if not self.fused_embed:
            raise ValueError("embedded_x() is only meaningful with "
                             "fused_embed=True (x is already embedded)")
        return ops.rff_embed_batched(self.x, self.omega, self.delta)

    def _pick_alloc_backend(self) -> str:
        """Resolve alloc_backend="auto" exactly as the reference does."""
        if self.alloc_backend != "auto":
            return self.alloc_backend
        return "vectorized" if (self.n >= 64 and
                                vectorized_grid_width(self.nodes) <= 4096) \
            else "scalar"

    # ------------------------------------------------------------- step consts
    def consts_point_len(self) -> int:
        """Point-axis length of `build_consts()["gx"]`: shape arithmetic
        only, so a sweep computes its grid-wide `l_target` without
        building the tensors."""
        return self.scheme_obj.consts_point_len(self)

    def build_consts(self, l_target: Optional[int] = None) -> dict:
        """Per-deployment tensors consumed by `build_step`'s step.
        `l_target` pads the point axis to a common length, so that
        deployments with other per-client loads run through one step
        (`repro_torch.launch.sweep`); the padding is zero rows past the
        live ones, which the round does not read.  With a mesh the client
        axis is zero-row padded to a multiple of its size and this rank
        keeps its own rows (`_shard_rows`)."""
        gx, gy, gmask, tail = self.scheme_obj.grad_tensors(self, l_target)
        pseudo = len(tail)
        if self.mesh is not None:
            gx, gy, gmask, tail, lo = self._shard_rows(gx, gy, gmask, tail)
        consts = {
            "gx": gx, "gy": gy, "gmask": gmask,
            "ret_tail": torch.tensor(tail, dtype=torch.float32,
                                     device=self.device),
        }
        if self.fused_embed:
            consts["omega"] = self.omega
            consts["delta"] = self.delta
        consts.update(self.scheme_obj.extra_consts(self))
        if self.mesh is not None and "live_rows" in consts:
            consts["live_rows"] = _shard_live_rows(
                consts["live_rows"], self.n if pseudo else None, lo,
                lo + gx.shape[0])
        return consts

    def _shard_rows(self, gx, gy, gmask, tail):
        """This rank's rows of the client tensors, zero-padded (as the
        reference's ``_pad_rows``) to a multiple of the mesh size: ``(gx,
        gy, gmask, padded ret_tail, first row)``.  The rows are a copy, so
        the full tensors are freed when the caller drops them."""
        k = self.mesh.size
        rows = gx.shape[0]
        s = -(-rows // k)
        tail = list(tail) + [0.0] * (s * k - rows)
        lo = self.mesh.rank * s
        live = max(0, min(rows - lo, s))

        def take(t):
            part = t.new_zeros((s,) + tuple(t.shape[1:]))
            part[:live] = t[lo:lo + live]
            return part
        return take(gx), take(gy), take(gmask), tail, lo

    def step_static(self) -> dict:
        """Python-static step parameters matching `build_consts`."""
        return {
            "scheme": self.step_kind,
            "n": self.n,
            "n_wait": self.n_wait,
            "l2": self.train.l2_reg,
            "m": float(self.m),
            "l": float(self.l),
            "guard": self.nonfinite_guard,
            "fused": self.fused_coded,
            "fused_embed": self.fused_embed,
            "channel": self.channel is not None,
            "faults": self.return_faults,
            "stale": self.stale_faults,
            "mesh": self.mesh,
        }

    def scheme_params_estimator_kwargs(self) -> dict:
        """Estimator knobs riding in `scheme_params` (adaptive family)."""
        kw = {}
        if "est_beta" in self.scheme_params:
            kw["beta"] = float(self.scheme_params["est_beta"])
        if "est_window" in self.scheme_params:
            kw["window"] = int(self.scheme_params["est_window"])
        return kw

    def _estimator(self) -> OnlineChannelEstimator:
        """A fresh estimator at the nominal network, with the spec's knobs."""
        return OnlineChannelEstimator(
            self.nodes, **self.scheme_params_estimator_kwargs())

    def _reserve_trace_streams(self, k: int) -> int:
        """Reserve `k` consecutive trace-stream indices for a new run and
        return the base index (kept in the run's `RunState`)."""
        base = self._trace_calls
        self._trace_calls += k
        return base

    def _trace_rng(self, index: int) -> np.random.Generator:
        """Dedicated per-run trace generator, deterministic per (seed,
        stream index) and independent of `self.rng`, so turning the
        channel on never shifts the delay draws."""
        return np.random.default_rng((self._trace_seed, int(index)))

    def _lr(self, epoch: int) -> float:
        lr = self.train.learning_rate
        for e in self.train.lr_decay_epochs:
            if epoch >= e:
                lr *= self.train.lr_decay
        return lr

    def _lr_schedule_range(self, r0: int, r1: int) -> np.ndarray:
        """Per-round learning rates for global rounds [r0, r1): blocks
        read their position from the global cursor, so the schedule does
        not depend on how the run is cut into blocks."""
        return np.array([self._lr(it // self.steps_per_epoch)
                         for it in range(r0, r1)], np.float32)

    def _lr_schedule(self, iterations: int) -> np.ndarray:
        return self._lr_schedule_range(0, iterations)

    # ------------------------------------------------- block-structured runs
    def _get_consts(self) -> dict:
        if self._consts is None:
            self._consts = self.build_consts()
        return self._consts

    def _get_step(self):
        if self._step is None:
            self._step = build_step(self.step_static())
        return self._step

    def _block_span(self) -> "obs_spans.span":
        """The span of one block of the cached step, the reference's
        `_timed_scan`: ``scan/compile`` for the first block the step runs,
        ``scan/execute`` for every later one.  It syncs the device before
        its clock stops (once a block), so the time covers the block's
        device work."""
        name = "scan/execute" if self._step_warm else "scan/compile"
        self._step_warm = True
        return obs_spans.span(name, sync=self.device)

    def _capture(self, times, active, seg=None) -> None:
        """Keep one block's host delay arrays for `attribution` while
        spans are on: the arrays the block already drew (no second draw,
        no device read), with the adaptive plan's per-round deadlines or
        wait counts."""
        if not obs_spans.enabled():
            return
        block = {"times": np.asarray(times),
                 "active": None if active is None else np.asarray(active)}
        if seg is not None:
            coded = self.step_kind == "adaptive_coded"
            block["t_star_r"] = np.asarray(seg.t_star_r) if coded else None
            block["n_wait_r"] = None if coded else np.asarray(seg.n_wait_r)
        self._attr_blocks.append(block)

    def _carry0(self, theta, lr_scale, theta_prev=None) -> tuple:
        """The step's carry: (theta, lr_scale), and theta_prev (theta where
        none is given) under stale replay."""
        carry = (theta, torch.tensor(float(lr_scale), dtype=torch.float32,
                                     device=self.device))
        if self.stale_faults:
            carry = carry + (theta if theta_prev is None else theta_prev,)
        return carry

    def _rounds(self, theta, lr_scale, xs, eval_at=None, consts=None,
                theta_prev=None):
        """`run_rounds` of this deployment's step from the carry (theta,
        lr_scale[, theta_prev]); `consts` defaults to the deployment's.
        Returns the final carry and the (K,) per-round columns (t_round,
        n_ret, n_masked, skipped), still on the device."""
        if consts is None:
            consts = self._get_consts()
        return run_rounds(self._get_step(), consts,
                          self._carry0(theta, lr_scale, theta_prev), xs,
                          eval_at)

    def _fault_rows(self, state: RunState, rounds: int):
        """`rounds` rows of fault inputs from the state's fault stream, as
        device tensors: ``(xs_extra, new_stream_state)``, ``((), the
        state's)`` when return faults are off.  The stream is seeded from
        ``fl.seed + 7717``, apart from the delay and channel-trace streams,
        so turning faults on never shifts the network a run faces."""
        if not self.return_faults:
            return (), state.fault_rng_state
        frng = np.random.default_rng()
        frng.bit_generator.state = state.fault_rng_state
        fcodes, fpar = finject.sample_fault_rows(self.faults, frng, rounds,
                                                 self.n)
        return ((torch.from_numpy(fcodes).to(self.device),
                 self._device(fpar)), frng.bit_generator.state)

    def init_state(self, iterations: int, *,
                   n_realizations: Optional[int] = None,
                   collect: bool = False) -> RunState:
        """Fresh `RunState` for a run of `iterations` rounds.

        ``n_realizations=None`` starts a "single" run; otherwise a "multi"
        run (stationary: blocks advance all realizations' cursors together)
        or a "multi_channel" one (traced: a block is one whole realization,
        each with its own trace stream).  The state is seeded from this
        experiment's live RNG and the run's trace streams are reserved
        here, so runs launched back to back consume disjoint draws.
        """
        iterations = int(iterations)
        if iterations < 1:
            raise ValueError(f"iterations={iterations} must be >= 1")
        self._attr_blocks = []   # attribution covers the new run only
        if n_realizations is None:
            mode, R, lead, lr_scale = "single", None, (), 1.0
        else:
            R = int(n_realizations)
            if R < 1:
                raise ValueError(f"n_realizations={R} must be >= 1")
            mode = "multi_channel" if self.channel is not None else "multi"
            lead, lr_scale = (R,), np.ones(R, np.float64)
            collect = False
        trace_call = -1
        trace = est = controls = sched = None
        if self.channel is not None:
            if mode == "single":
                trace_call = self._reserve_trace_streams(1)
                trace = TraceState.init(self.n, self._trace_rng(trace_call))
                if self.adaptive:
                    est = self._estimator().state_dict()
                    controls = self.scheme_obj.initial_controls(self)
                    sched = _empty_sched(self.n)
            else:
                # one stream per realization; a block IS one realization,
                # so its estimator and controls never live in the state
                trace_call = self._reserve_trace_streams(R)
        # a multi_channel run's accumulators grow a row a realization
        acc = (0, iterations) if mode == "multi_channel" else lead + (0,)
        losses = accs = None
        if collect:
            losses = np.zeros(0, np.float64)
            accs = np.zeros(0, np.float64)
        theta = torch.zeros(lead + (self.q, self.c), dtype=torch.float32,
                            device=self.device)
        # stale replay needs the previous iterate in the carry; a
        # multi_channel block is a whole realization, so its theta_prev is
        # block-local and never lives in the state
        theta_prev = (theta.clone() if self.stale_faults
                      and mode != "multi_channel" else None)
        fault_rng_state = None
        if self.return_faults:
            fault_rng_state = np.random.default_rng(
                (self._fault_seed,)).bit_generator.state
        return RunState(
            mode=mode, iterations=iterations, rounds_done=0,
            realizations_done=0, n_realizations=R, collect=bool(collect),
            theta=theta,
            rng_state=self.rng.bit_generator.state, trace_call=trace_call,
            trace=trace, est=est, controls=controls,
            t_rounds=np.zeros(acc, np.float64),
            n_ret=np.zeros(acc, np.int32), losses=losses, accs=accs,
            sched=sched, lr_scale=lr_scale,
            n_masked=np.zeros(acc, np.int64),
            skipped=np.zeros(acc, np.int64), theta_prev=theta_prev,
            fault_rng_state=fault_rng_state)

    def run_block(self, state: RunState, n_rounds: Optional[int] = None, *,
                  eval_fn: Optional[Callable] = None,
                  eval_every: int = 10) -> RunState:
        """Advance a run by one block and return the NEW `RunState` (the
        input is never mutated, so replaying a block from a saved state is
        always safe).

        ``n_rounds`` defaults to ``spec.checkpoint_every``, or the whole
        remaining horizon when that is 0.  "multi_channel" runs advance
        exactly one full realization per block regardless of ``n_rounds``.
        A "single" run initialized with ``collect=True`` must be given its
        ``eval_fn`` on every block.
        """
        if state.mode == "hier":
            # the reference's flat run_block would run such a state as a
            # single trajectory; its rounds belong to the hierarchical tier
            raise ValueError(
                "a 'hier' run belongs to the hierarchical tier "
                "(repro_torch.hier.HierExperiment.run_block); the flat "
                "engine does not run it")
        if state.done:
            raise ValueError(
                "run is already complete "
                f"({state.rounds_done}/{state.iterations} rounds)")
        if (state.mode == "multi_channel") != (
                state.mode != "single" and self.channel is not None):
            raise ValueError(
                f"a {state.mode!r} run does not belong to this experiment "
                f"(channel {'on' if self.channel is not None else 'off'})")
        if state.mode == "single":
            if state.collect and eval_fn is None:
                raise ValueError("state was initialized with collect=True; "
                                 "run_block needs its eval_fn")
            if not state.collect and eval_fn is not None:
                raise ValueError(
                    "state was initialized with collect=False; re-init "
                    "with collect=True to evaluate during the run")
        # detached generator: the stream position lives in the state, not
        # in this Experiment, so replaying a restored block is hermetic
        rng = np.random.default_rng()
        rng.bit_generator.state = state.rng_state
        if state.mode == "multi_channel":
            return self._block_multi_channel(state, rng)
        r0 = state.rounds_done
        K = int(n_rounds) if n_rounds is not None else (
            self.checkpoint_every or state.iterations)
        if K < 1:
            raise ValueError(f"n_rounds={K} must be >= 1")
        K = min(K, state.iterations - r0)
        lrs = self._device(self._lr_schedule_range(r0, r0 + K))
        if state.mode == "multi":
            return self._block_multi(state, rng, K, lrs)
        return self._block_single(state, rng, K, lrs, eval_fn, eval_every)

    def _device(self, arr) -> torch.Tensor:
        """A NumPy block input as a float32 tensor on the device: one copy
        a block, never one a round."""
        return torch.from_numpy(np.asarray(arr, np.float32)).to(self.device)

    def _draw_delays(self, rng, rounds: int) -> np.ndarray:
        """(rounds, n) float64 delays on the host, one vectorized draw."""
        return sample_round_times(self.nodes, np.asarray(self.loads, float),
                                  rng, rounds)

    def _delays(self, rng, rounds: int) -> torch.Tensor:
        """(rounds, n) float32 delays on the device, one vectorized draw."""
        return self._device(self._draw_delays(rng, rounds))

    def _traced_xs(self, trace, rng, lrs, r0: int, est=None,
                   controls=None):
        """The step inputs of the rounds a trace block covers, from `rng`.

        Traced delays and the availability rows; with an adaptive scheme
        the plan of those rounds first (`plan_segment`, advancing the
        estimator `est` from `controls`), whose deadlines and mask indices
        (adaptive_coded) or wait counts (adaptive_greedy) join the inputs.
        Returns ``(xs, consts, seg, times)``: the deployment's consts with
        the plan's mask stack, the `SegmentPlan` (None when not adaptive),
        and the host array of the delays uploaded.
        """
        consts = self._get_consts()
        if not self.adaptive:
            times = sample_round_times_traced(
                self.nodes, np.asarray(self.loads, float), rng, trace)
            return ((self._device(times), lrs, self._device(trace.active)),
                    consts, None, times)
        seg = plan_segment(self, est, trace, r0, r0 + trace.rounds,
                           controls, rng)
        xs = (self._device(seg.times), lrs, self._device(seg.active))
        if self.step_kind == "adaptive_coded":
            consts = dict(consts, gmask_blocks=seg.gmask_blocks)
            xs = xs + (self._device(seg.t_star_r), seg.block_idx.tolist())
        else:
            xs = xs + (seg.n_wait_r.tolist(),)
        return xs, consts, seg, seg.times

    def _block_single(self, state: RunState, rng, K: int, lrs, eval_fn,
                      eval_every: int) -> RunState:
        """K rounds of a single trajectory: stationary pre-sampled delays,
        or the traced-channel (and adaptive) path chained through the
        state's `TraceState`, estimator statistics and control values."""
        r0 = state.rounds_done
        trace_new, est_new = state.trace, state.est
        controls_new, sched_new = state.controls, state.sched
        consts = None
        if self.channel is None:
            times = self._draw_delays(rng, K)
            xs = (self._device(times), lrs)
            self._capture(times, None)
        else:
            with obs_spans.span("trace/generate"):
                trace_block, trace_new = generate_trace_block(
                    self.nodes, self.channel, K, state.trace)
            est = None
            if self.adaptive:
                est = self._estimator()
                est.load_state_dict(state.est)
            xs, consts, seg, times = self._traced_xs(
                trace_block, rng, lrs, r0, est, state.controls)
            self._capture(times, trace_block.active if seg is None
                          else seg.active, seg)
            if seg is not None:
                est_new = est.state_dict()
                controls_new = seg.controls
                sched_new = _append_sched(state.sched, seg)
        eval_at = None
        losses, accs = state.losses, state.accs
        if state.collect:
            loss_b = np.full(K, np.nan)
            acc_b = np.full(K, np.nan)

            def eval_at(k, theta):
                it = r0 + k
                if it % eval_every == 0 or it == state.iterations - 1:
                    loss, acc = eval_fn(theta)
                    loss_b[k], acc_b[k] = float(loss), float(acc)
        fault_xs, fault_rng_new = self._fault_rows(state, K)
        with self._block_span():
            carry, cols = self._rounds(state.theta, state.lr_scale,
                                       xs + fault_xs, eval_at, consts,
                                       state.theta_prev)
        t_rounds, n_ret, n_masked, skipped = (c.cpu().numpy() for c in cols)
        if state.collect:
            losses = np.concatenate([state.losses, loss_b])
            accs = np.concatenate([state.accs, acc_b])
        return dataclasses.replace(
            state, rounds_done=r0 + K, theta=carry[0],
            rng_state=rng.bit_generator.state, trace=trace_new,
            est=est_new, controls=controls_new, sched=sched_new,
            t_rounds=np.concatenate(
                [state.t_rounds, t_rounds.astype(np.float64)]),
            n_ret=np.concatenate([state.n_ret, n_ret]),
            losses=losses, accs=accs, lr_scale=float(carry[1]),
            n_masked=np.concatenate(
                [state.n_masked, n_masked.astype(np.int64)]),
            skipped=np.concatenate(
                [state.skipped, skipped.astype(np.int64)]),
            theta_prev=carry[2] if self.stale_faults else None,
            fault_rng_state=fault_rng_new)

    def _block_multi(self, state: RunState, rng, K: int, lrs) -> RunState:
        """K rounds of every stationary realization: one draw of R * K
        delay rows, as the reference's vmapped scan takes them, then the
        realizations one after another through the same step (one
        gradient launch a realization a round)."""
        R = int(state.n_realizations)
        times = self._delays(rng, R * K).reshape(R, K, self.n)
        # R * K fault rows, as the reference's vmapped scan takes them
        fault_xs, fault_rng_new = self._fault_rows(state, R * K)
        fault_xs = tuple(col.reshape((R, K) + col.shape[1:])
                         for col in fault_xs)
        thetas, scales, prevs, cols = [], [], [], []
        with self._block_span():
            for r in range(R):
                carry, cols_r = self._rounds(
                    state.theta[r], state.lr_scale[r],
                    (times[r], lrs) + tuple(col[r] for col in fault_xs),
                    theta_prev=(None if state.theta_prev is None
                                else state.theta_prev[r]))
                thetas.append(carry[0])
                scales.append(carry[1])
                if self.stale_faults:
                    prevs.append(carry[2])
                cols.append(cols_r)
        t_rounds, n_ret, n_masked, skipped = (
            torch.stack(col).cpu().numpy() for col in zip(*cols))
        return dataclasses.replace(
            state, rounds_done=state.rounds_done + K,
            theta=torch.stack(thetas), rng_state=rng.bit_generator.state,
            t_rounds=np.concatenate(
                [state.t_rounds, t_rounds.astype(np.float64)], axis=1),
            n_ret=np.concatenate([state.n_ret, n_ret], axis=1),
            lr_scale=torch.stack(scales).cpu().numpy().astype(np.float64),
            n_masked=np.concatenate(
                [state.n_masked, n_masked.astype(np.int64)], axis=1),
            skipped=np.concatenate(
                [state.skipped, skipped.astype(np.int64)], axis=1),
            theta_prev=torch.stack(prevs) if self.stale_faults else None,
            fault_rng_state=fault_rng_new)

    def _block_multi_channel(self, state: RunState, rng) -> RunState:
        """One full traced realization per block: a fresh trace stream at
        index ``trace_call + r`` and (adaptive family) a fresh estimator
        and controls, as in the reference."""
        r = state.realizations_done
        T = state.iterations
        tstate = TraceState.init(self.n,
                                 self._trace_rng(state.trace_call + r))
        with obs_spans.span("trace/generate"):
            trace, _ = generate_trace_block(self.nodes, self.channel, T,
                                            tstate)
        est = controls = None
        if self.adaptive:
            est = self._estimator()
            controls = self.scheme_obj.initial_controls(self)
        xs, consts, seg, _ = self._traced_xs(
            trace, rng, self._device(self._lr_schedule(T)), 0, est, controls)
        # the record kept is the LAST realization's plan, as the
        # reference's `last_schedule`
        sched_new = (state.sched if seg is None
                     else _append_sched(_empty_sched(self.n), seg))
        fault_xs, fault_rng_new = self._fault_rows(state, T)
        with self._block_span():
            carry, cols = self._rounds(
                torch.zeros((self.q, self.c), dtype=torch.float32,
                            device=self.device), 1.0, xs + fault_xs,
                consts=consts)
        t_rounds, n_ret, n_masked, skipped = (c.cpu().numpy() for c in cols)
        theta = state.theta.clone()
        theta[r] = carry[0]
        lr_scale = np.asarray(state.lr_scale, np.float64).copy()
        lr_scale[r] = float(carry[1])
        return dataclasses.replace(
            state, realizations_done=r + 1, rounds_done=(r + 1) * T,
            theta=theta, rng_state=rng.bit_generator.state, sched=sched_new,
            t_rounds=np.concatenate(
                [state.t_rounds, t_rounds.astype(np.float64)[None]]),
            n_ret=np.concatenate([state.n_ret, n_ret[None]]),
            lr_scale=lr_scale,
            n_masked=np.concatenate(
                [state.n_masked, n_masked.astype(np.int64)[None]]),
            skipped=np.concatenate(
                [state.skipped, skipped.astype(np.int64)[None]]),
            fault_rng_state=fault_rng_new)

    # ---------------------------------------------------- checkpoint/restore
    def save_state(self, path: str, state: RunState) -> str:
        """Checkpoint `state` atomically (`repro_torch.checkpoint.io`),
        with this experiment's `ExperimentSpec` as JSON provenance.
        Under a mesh only rank 0 writes, and every rank then learns the
        write's outcome (`ClientMesh.any_`, which also waits for it, so
        each can restore the file): when it failed, every rank raises, so
        the ranks stay in step through a caller's retry."""
        failed = None
        if self._writes:
            try:
                arrays, meta = pack_state(state)
                meta["spec"] = self.spec.to_dict()
                with obs_spans.span("checkpoint/save"):
                    path = ckpt_io.save_state(path, arrays, meta)
            except Exception as exc:       # raised below, on every rank
                failed = exc
        if self.mesh is not None and self.mesh.any_(failed is not None):
            if failed is None:
                raise RuntimeError(
                    f"rank 0 of the client mesh failed to write checkpoint "
                    f"{path!r}")
        if failed is not None:
            raise failed
        return path

    def restore_state(self, path: str) -> RunState:
        """Load a `RunState` checkpoint (digest verified) onto this
        experiment's device, refusing one saved by another spec."""
        self._attr_blocks = []   # attribution covers post-restore rounds
        with obs_spans.span("checkpoint/restore"):
            arrays, meta = ckpt_io.restore_state(path)
        spec_dict = meta.get("spec")
        if spec_dict is not None:
            saved = ExperimentSpec.from_dict(spec_dict)
            if saved != self.spec:
                raise ValueError(
                    f"checkpoint provenance mismatch: {path!r} was saved "
                    "by a run of a different ExperimentSpec than this "
                    "experiment's; refusing to resume across specs")
        state = unpack_state(arrays, meta, device=self.device)
        # bump the trace-stream cursor past the restored run's reservation
        # so new runs on this experiment stay disjoint from it
        if state.trace_call >= 0:
            reserved = (int(state.n_realizations)
                        if state.mode == "multi_channel" else 1)
            self._trace_calls = max(self._trace_calls,
                                    state.trace_call + reserved)
        return state

    # ------------------------------------------------------------ finalizing
    def finish(self, state: RunState,
               eval_fn: Optional[Callable] = None):
        """Turn a completed `RunState` into a `FedResult` (single) or a
        `MultiFedResult` (multi), and sync this experiment's RNG to the
        run's end, so back-to-back runs consume disjoint draws."""
        if not state.done:
            raise ValueError(
                f"run is not complete ({state.rounds_done}/"
                f"{state.iterations} rounds); call run_block until "
                "state.done")
        self.rng.bit_generator.state = state.rng_state
        if state.sched is not None:
            self.last_schedule = self._assemble_schedule(state.sched)
        if state.mode == "single":
            return self._finish_single(state)
        return self._finish_multi(state, eval_fn)

    def _assemble_schedule(self, sched: dict) -> AdaptiveSchedule:
        """The run's `AdaptiveSchedule` from the state's record (the masks
        re-derived from the per-block loads: `gmask_for_loads` is a pure
        function of them)."""
        estimates = [
            {"mu": sched["est_mu"][b], "tau": sched["est_tau"][b],
             "p": sched["est_p"][b], "avail": sched["est_avail"][b],
             "rounds_seen": int(sched["est_rounds_seen"][b])}
            for b in range(sched["loads_blocks"].shape[0])]
        out = AdaptiveSchedule(
            times=sched["times"], active=sched["active"],
            block_idx=sched["block_idx"],
            loads_blocks=sched["loads_blocks"], estimates=estimates)
        if self.step_kind == "adaptive_coded":
            out.t_star = sched["t_star_r"]
            out.gmask_blocks = torch.stack(
                [self.scheme_obj.gmask_for_loads(self, loads)
                 for loads in sched["loads_blocks"]])
        else:
            out.n_wait = sched["n_wait_r"]
        return out

    @staticmethod
    def _run_health(state: RunState) -> "RunHealth | None":
        if state.n_masked is None:
            return None
        ls = np.asarray(state.lr_scale, np.float64)
        return RunHealth(
            rounds_degraded=int(np.sum(np.asarray(state.n_masked) > 0)),
            returns_masked=int(np.sum(state.n_masked)),
            rounds_skipped=int(np.sum(state.skipped)),
            lr_scale=float(ls.min() if ls.ndim else ls))

    def _finish_single(self, state: RunState) -> FedResult:
        wall = self.setup_time + np.cumsum(state.t_rounds)
        # a format-1 checkpoint of the reference has no guard counters
        have_guards = state.n_masked is not None
        history = []
        for it in range(state.iterations):
            loss = float(state.losses[it]) if state.collect else float("nan")
            acc = float(state.accs[it]) if state.collect else float("nan")
            history.append(RoundLog(
                it, float(wall[it]), int(state.n_ret[it]), loss, acc,
                n_masked=int(state.n_masked[it]) if have_guards else 0,
                skipped=int(state.skipped[it]) if have_guards else 0))
        return FedResult(theta=state.theta, history=history,
                         t_star=self.t_star, loads=self.loads,
                         setup_time=self.setup_time,
                         privacy_eps=self.privacy_eps,
                         health=self._run_health(state))

    def _finish_multi(self, state: RunState, eval_fn) -> MultiFedResult:
        """`eval_fn` sees the realizations' final iterates one by one."""
        wall = self.setup_time + np.cumsum(state.t_rounds, axis=1)
        theta = state.theta
        acc = None
        if eval_fn is not None:
            acc = np.array([eval_fn(theta[r])[1]
                            for r in range(theta.shape[0])])
        return MultiFedResult(theta=theta, wall_clock=wall,
                              returned=np.asarray(state.n_ret),
                              t_star=self.t_star, loads=self.loads,
                              setup_time=self.setup_time, accuracy=acc,
                              privacy_eps=self.privacy_eps,
                              health=self._run_health(state))

    # ------------------------------------------------------------ telemetry
    def attribution(self, k: int = 3):
        """Post-hoc straggler attribution (`repro_torch.obs.attribution`)
        over the delay blocks this experiment drew while telemetry was
        enabled (`repro_torch.obs.spans.enable`): per-client deadline-miss
        rate, slowest-`k` contribution counts, and the coded-compensation
        data share per round.  Covers single-trajectory rounds computed
        in this process since the last `init_state`/`restore_state`.
        Raises `RuntimeError` when nothing was captured."""
        from repro_torch.obs.attribution import attribution_from_blocks
        return attribution_from_blocks(
            self._attr_blocks, self.step_kind, t_star=self.t_star,
            t_ideal=self.t_ideal, n_wait=self.n_wait,
            loads=self.loads, m=self.m, k=k)

    def _drive(self, state: RunState, checkpoint_dir: Optional[str],
               eval_fn=None, eval_every: int = 10,
               journal=None) -> RunState:
        """Advance `state` to completion block by block, checkpointing each
        block boundary when a directory is given and journaling each
        block's rounds when a `RunJournal` is given (after the checkpoint,
        so the journal never runs ahead of durable state)."""
        while not state.done:
            state = self.run_block(state, eval_fn=eval_fn,
                                   eval_every=eval_every)
            if checkpoint_dir is not None:
                self.save_state(
                    os.path.join(
                        checkpoint_dir,
                        f"{ckpt_io.CKPT_PREFIX}{state.rounds_done:06d}.npz"),
                    state)
            if journal is not None:
                journal.sync(self, state)
        return state

    def _latest_state(self, checkpoint_dir: Optional[str]):
        """(path, state) of the newest intact checkpoint in the
        directory, or (None, None)."""
        if checkpoint_dir is None:
            raise ValueError("resume=True requires checkpoint_dir")
        latest = ckpt_io.latest_checkpoint(checkpoint_dir, valid_only=True)
        if latest is None:
            return None, None
        return latest, self.restore_state(latest)

    # ------------------------------------------------------------------- runs
    def run(self, iterations: int,
            eval_fn: Optional[Callable[[torch.Tensor],
                                       tuple[float, float]]] = None,
            eval_every: int = 10, *, checkpoint_dir: Optional[str] = None,
            resume: bool = False,
            journal_dir: Optional[str] = None) -> FedResult:
        """Run `iterations` rounds from theta = 0 as a chain of
        `run_block` calls: a block is ``spec.checkpoint_every`` rounds, or
        the whole horizon when that is 0.

        `eval_fn(theta) -> (loss, accuracy)` is called on the round's new
        iterate at every `eval_every`-th round and at the last one; the
        other rounds log NaN.  ``checkpoint_dir`` writes an atomic
        `RunState` checkpoint at every block boundary; ``resume=True``
        restores the newest intact one there (if any) and continues,
        bit-identical to the uninterrupted blocked run.  ``journal_dir``
        appends one `repro_torch.obs` event per round to
        ``<journal_dir>/events.jsonl`` at the same boundaries — on resume
        the journal is trimmed/regrown to match the restored state, so an
        interrupted run's journal is always extended, never corrupted.
        Under a mesh only rank 0 writes the checkpoints and the journal.
        """
        if self.engine == "legacy":
            if checkpoint_dir is not None or resume:
                raise ValueError(
                    "checkpointing requires the batched engine; the legacy "
                    "per-client oracle has no block-structured run state")
            if journal_dir is not None:
                raise ValueError(
                    "journal_dir requires the batched engine; the legacy "
                    "per-client oracle has no RunState to journal from")
            iterations = int(iterations)
            if iterations < 1:
                raise ValueError(f"iterations={iterations} must be >= 1")
            times = sample_round_times(self.nodes,
                                       np.asarray(self.loads, float),
                                       self.rng, iterations)
            return self._run_legacy(iterations, times,
                                    self._lr_schedule(iterations), eval_fn,
                                    eval_every)
        state = None
        if resume:
            latest, state = self._latest_state(checkpoint_dir)
            if state is not None:
                if state.mode != "single":
                    raise ValueError(
                        f"checkpoint {latest!r} holds a {state.mode!r} "
                        "run; resume it with run_multi")
                if state.iterations != int(iterations):
                    raise ValueError(
                        f"checkpoint {latest!r} is a {state.iterations}-"
                        f"round run; this run asked for {iterations}")
                if state.collect != (eval_fn is not None):
                    raise ValueError(
                        f"checkpoint {latest!r} was saved with collect="
                        f"{state.collect}; pass a matching eval_fn")
        if state is None:
            state = self.init_state(iterations, collect=eval_fn is not None)
        journal = None
        if journal_dir is not None and self._writes:
            from repro_torch.obs.events import RunJournal
            journal = RunJournal(journal_dir)
            # trim past the restored state (a journal ahead of a rolled-
            # back checkpoint replays from authoritative state), then
            # regrow whatever prefix the state already carries
            journal.reset_to(state.rounds_done)
            journal.sync(self, state)
        state = self._drive(state, checkpoint_dir, eval_fn, eval_every,
                            journal=journal)
        return self.finish(state)

    def run_multi(self, iterations: int, n_realizations: int,
                  eval_fn: Optional[Callable[[torch.Tensor],
                                             tuple[float, float]]] = None,
                  *, checkpoint_dir: Optional[str] = None,
                  resume: bool = False) -> MultiFedResult:
        """R independent delay realizations of the same deployment.

        The (R, iterations) wall-clock / return-count surface: mean and
        std over axis 0 are the Fig. 4/5 curve with its confidence band
        (`MultiFedResult.wall_clock_bands`).  Always runs the batched
        step, whatever ``spec.engine``; `eval_fn` is called on each
        realization's final iterate.  ``checkpoint_dir``/``resume`` work
        at block boundaries exactly as in `run`.
        """
        state = None
        if resume:
            latest, state = self._latest_state(checkpoint_dir)
            if state is not None:
                if state.mode == "single":
                    raise ValueError(
                        f"checkpoint {latest!r} holds a single run; "
                        "resume it with run()")
                if (state.iterations != int(iterations)
                        or int(state.n_realizations)
                        != int(n_realizations)):
                    raise ValueError(
                        f"checkpoint {latest!r} is a {state.iterations}-"
                        f"round x {state.n_realizations}-realization run; "
                        f"this run asked for {iterations} x "
                        f"{n_realizations}")
        if state is None:
            state = self.init_state(iterations,
                                    n_realizations=n_realizations)
        state = self._drive(state, checkpoint_dir)
        return self.finish(state, eval_fn)

    # ------------------------------------------------------------------ sweep
    def sweep(self, *, profiles: dict, iterations: int, realizations: int,
              schemes: Optional[tuple] = None):
        """Sweep this experiment's data over heterogeneity profiles: the
        front end of `repro_torch.launch.sweep.run_sweep`, replaying this
        spec (scheme, training config, options) across `profiles`
        ({name: FLConfig-override dict}) through one step a scheme, on
        this experiment's device.  `schemes` defaults to this experiment's
        scheme alone."""
        from repro_torch.launch import sweep as sweep_mod
        return sweep_mod.run_sweep(
            self.x, self.y, profiles=profiles, train_cfg=self.train,
            iterations=iterations, realizations=realizations,
            schemes=schemes or (self.scheme,), base_spec=self.spec,
            device=self.device)

    # ---------------------------------------------------------- legacy engine
    def _run_legacy(self, iterations: int, times_all: np.ndarray,
                    lrs: np.ndarray, eval_fn, eval_every: int) -> FedResult:
        """The reference's per-client loop, the oracle the batched engine
        is tested against: deadlines on the host in float64, no guards
        (``RoundLog``'s zero counters, no ``health``)."""
        theta = torch.zeros((self.q, self.c), dtype=torch.float32,
                            device=self.device)
        wall = self.setup_time
        history: list[RoundLog] = []
        for it in range(iterations):
            times = times_all[it]
            if self.step_kind == "naive":
                returned = np.ones(self.n, dtype=bool)
                t_round = float(np.max(times))
                denom = self.m
            elif self.step_kind == "greedy":
                order = np.argsort(times)
                returned = np.zeros(self.n, dtype=bool)
                returned[order[:self.n_wait]] = True
                t_round = float(times[order[self.n_wait - 1]])
                denom = int(returned.sum()) * self.l
            elif self.step_kind == "coded":
                returned = times <= self.t_star
                t_round = float(self.t_star)
                denom = self.m
            elif self.step_kind == "ideal":
                returned = np.ones(self.n, dtype=bool)
                t_round = float(self.t_ideal)
                denom = self.m
            else:
                raise ValueError(self.step_kind)

            if self.step_kind == "coded":
                total = aggregation.coded_gradient(
                    self.parity.x, self.parity.y, theta, pnr_c=0.0)
                for j in range(self.n):
                    if returned[j] and self.loads[j] > 0:
                        total = total + aggregation.client_gradient(
                            self._sub_x[j], self._sub_y[j], theta)
                g_m = total / denom + self.train.l2_reg * theta
            else:
                g_all = aggregation.batched_client_gradients(self.x, self.y,
                                                             theta)
                g_m = (aggregation.masked_gradient_sum(g_all, returned)
                       / denom + self.train.l2_reg * theta)
            theta = theta - float(lrs[it]) * g_m
            wall += t_round
            loss = acc = float("nan")
            if eval_fn is not None and (it % eval_every == 0
                                        or it == iterations - 1):
                loss, acc = (float(v) for v in eval_fn(theta))
            history.append(RoundLog(it, wall, int(returned.sum()), loss, acc))
        return FedResult(theta=theta, history=history, t_star=self.t_star,
                         loads=self.loads, setup_time=self.setup_time,
                         privacy_eps=self.privacy_eps)
