"""Federated-learning runtime of the port: the flat batched engine's main path.

The counterpart of ``repro.core.fed_runtime`` for stationary delays, one
device and the fused coded round (``fused_coded=True``):

  * the scheme's setup runs on the host (allocation, subsets, weights) and
    on the device (parity encode, dense client tensors);
  * the whole run's delays are pre-sampled with one vectorized
    ``sample_round_times`` call on the experiment's host generator, after
    the setup has drawn its subsets from it, exactly as the reference
    orders its draws;
  * the reference's ``lax.scan`` becomes a Python loop over the rounds,
    one block for the whole horizon (the reference's
    ``checkpoint_every=0``).  Each round is one ``linreg_grad_masked``
    launch over the dense (rows, L, q) tensor, the returned-mask sum and
    the guarded SGD update, all on the device; the host reads the
    per-round records back once, after the loop.

Delays go to float32 before the step and deadlines are compared in float32,
as in the reference, so returned counts and the wall clock
(``setup_time + cumsum`` in float64 of the float32 round times) are
bit-identical to it.

The non-finite guard (``spec.nonfinite_guard``) zeroes non-finite gradient
rows out of the weighted sum and counts them; the always-on divergence
guard never commits a non-finite iterate (the round is skipped and the lr
backs off by `LR_BACKOFF`).  Both are no-ops on clean rounds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.config import ExperimentSpec, unsupported_features
from repro_torch.core import aggregation, schemes
from repro_torch.core.delay_model import (mec_network, packet_bits,
                                          sample_round_times, scale_tau)
from repro_torch.core.load_allocation import vectorized_grid_width
from repro_torch.device import resolve_device

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


def guard_and_sum(g, ret, guard: bool):
    """((q, c) returned-masked sum of the (rows, q, c) gradients `g`,
    int32 count of masked contributions).

    With `guard` every non-finite gradient row is zeroed out of the sum and
    counted when its client returned; on an all-finite round this is a
    no-op (``where(True, g, 0) == g``).
    """
    if not guard:
        return (aggregation.masked_gradient_sum(g, ret),
                torch.zeros((), dtype=torch.int32, device=g.device))
    finite = torch.isfinite(g).flatten(1).all(dim=1)
    n_masked = ((ret > 0.0) & ~finite).sum().to(torch.int32)
    g = torch.where(finite[:, None, None], g, 0.0)
    return aggregation.masked_gradient_sum(g, ret), n_masked


def build_step(static: dict):
    """One round ``step(consts, carry, inp) -> (carry, out)``.

    `static`: scheme (step kind), n, n_wait, l2, m, l, guard.
    `consts`: gx (rows, L, q), gy (rows, L, c), gmask (rows, L), ret_tail
    (rows - n,); coded adds t_star () and active (n,), ideal t_ideal ().
    ``carry`` is ``(theta, lr_scale)``; ``inp`` is ``(t_row, lr)``, the
    round's float32 delays (n,) and learning rate.  ``out`` is
    ``(t_round, n_ret, n_masked, skipped)``, 0-dim tensors.
    """
    scheme = static["scheme"]
    n = static["n"]
    n_wait = static["n_wait"]
    l2 = static["l2"]
    m = static["m"]
    l = static["l"]
    guard = static["guard"]

    def step(consts, carry, inp):
        theta, lr_scale = carry
        t_row, lr = inp
        if scheme == "naive":
            n_ret = torch.full((), n, dtype=torch.int32, device=t_row.device)
            t_round = t_row.max()
            ret_real = torch.ones_like(t_row)
            denom = m
        elif scheme == "greedy":
            t_round = torch.sort(t_row).values[n_wait - 1]
            ret_real = (t_row <= t_round).to(t_row.dtype)
            n_ret = ret_real.sum().to(torch.int32)
            denom = n_ret.clamp(min=1).to(torch.float32) * l
        elif scheme == "coded":
            t_round = consts["t_star"]
            by_deadline = (t_row <= t_round).to(t_row.dtype)
            ret_real = by_deadline * consts["active"]
            n_ret = by_deadline.sum().to(torch.int32)
            denom = m
        elif scheme == "ideal":
            # deterministic no-straggler floor: all clients, full load,
            # fixed round clock (the sampled t_row is ignored)
            t_round = consts["t_ideal"]
            ret_real = torch.ones_like(t_row)
            n_ret = ret_real.sum().to(torch.int32)
            denom = m
        else:
            raise ValueError(scheme)
        # ret_tail covers the pseudo-client rows: the always-active parity
        # row of the fused coded tensor
        ret = torch.cat([ret_real.to(torch.float32), consts["ret_tail"]])
        g = aggregation.batched_client_gradients(
            consts["gx"], consts["gy"], theta, mask=consts["gmask"])
        g_sum, n_masked = guard_and_sum(g, ret, guard)
        theta_upd = theta - (lr * lr_scale) * (g_sum / denom + l2 * theta)
        # always-on divergence guard: a non-finite iterate is never
        # committed — the round is skipped (model held), the lr backs off
        ok = torch.isfinite(theta_upd).all()
        theta_new = torch.where(ok, theta_upd, theta)
        lr_scale_new = torch.where(ok, lr_scale, lr_scale * LR_BACKOFF)
        skipped = (~ok).to(torch.int32)
        return (theta_new, lr_scale_new), (t_round, n_ret, n_masked, skipped)

    return step


class Experiment:
    """One runnable FL deployment, built from a frozen `ExperimentSpec`.

    Clients hold equally sized local minibatches of RFF-embedded data
    (x_stack: (n, l, q), y_stack: (n, l, c)); the delay network follows
    paper §V-A.  The spec names a registered scheme
    (``repro_torch.core.schemes``) that owns the deployment setup.

    ``device`` defaults to the GPU; pass ``"cpu"`` to run the plain
    versions of the kernels.  ``parity_generators`` (n, u, l) replaces the
    coded family's own generator draw (see ``repro_torch.carry``).

    Prefer the entrypoint ``repro_torch.api.build_experiment``.
    """

    def __init__(self, spec: ExperimentSpec, x_stack, y_stack, *,
                 nodes: Optional[list] = None,
                 rng: Optional[np.random.Generator] = None,
                 device=None, parity_generators=None):
        if not isinstance(spec, ExperimentSpec):
            raise TypeError(
                f"spec must be an ExperimentSpec, got {type(spec).__name__}"
                " (build one with repro_torch.config.ExperimentSpec)")
        missing = unsupported_features(spec)
        if missing:
            raise NotImplementedError(
                "the PyTorch port does not support "
                + "; ".join(missing) + " yet")
        self.spec = spec
        fl_cfg = spec.resolved_fl()      # delay-profile knobs applied
        self.device = resolve_device(device)
        self.alloc_backend = spec.alloc_backend
        self.nonfinite_guard = bool(spec.nonfinite_guard)
        self.scheme = spec.resolved_scheme
        self.scheme_obj = schemes.get_scheme(self.scheme)
        self.step_kind = self.scheme_obj.step_kind
        self.scheme_params = spec.scheme_params_dict
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
        self.n, self.l, self.q = self.x.shape
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
        self.scheme_obj.setup(self)
        self.privacy_eps = self.scheme_obj.privacy_budget(self)
        self._consts = None     # built lazily on the first run

    @property
    def n_wait(self) -> int:
        """Greedy wait count: the fastest (1 - psi) * n clients."""
        return max(1, int(math.ceil((1.0 - self.fl.psi) * self.n)))

    def _pick_alloc_backend(self) -> str:
        """Resolve alloc_backend="auto" exactly as the reference does."""
        if self.alloc_backend != "auto":
            return self.alloc_backend
        return "vectorized" if (self.n >= 64 and
                                vectorized_grid_width(self.nodes) <= 4096) \
            else "scalar"

    # ------------------------------------------------------------- step consts
    def build_consts(self) -> dict:
        """Per-deployment tensors consumed by `build_step`'s step."""
        gx, gy, gmask, tail = self.scheme_obj.grad_tensors(self)
        consts = {
            "gx": gx, "gy": gy, "gmask": gmask,
            "ret_tail": torch.tensor(tail, dtype=torch.float32,
                                     device=self.device),
        }
        consts.update(self.scheme_obj.extra_consts(self))
        return consts

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
        }

    def _lr(self, epoch: int) -> float:
        lr = self.train.learning_rate
        for e in self.train.lr_decay_epochs:
            if epoch >= e:
                lr *= self.train.lr_decay
        return lr

    def _lr_schedule(self, iterations: int) -> np.ndarray:
        return np.array([self._lr(it // self.steps_per_epoch)
                         for it in range(iterations)], np.float32)

    # ------------------------------------------------------------------- runs
    def run(self, iterations: int,
            eval_fn: Optional[Callable[[torch.Tensor],
                                       tuple[float, float]]] = None,
            eval_every: int = 10) -> FedResult:
        """Run `iterations` rounds from theta = 0.

        `eval_fn(theta) -> (loss, accuracy)` is called on the round's new
        iterate at every `eval_every`-th round and at the last one; the
        other rounds log NaN.
        """
        iterations = int(iterations)
        if iterations < 1:
            raise ValueError(f"iterations={iterations} must be >= 1")
        if self._consts is None:
            self._consts = self.build_consts()
        consts = self._consts
        step = build_step(self.step_static())
        times = sample_round_times(self.nodes,
                                   np.asarray(self.loads, float),
                                   self.rng, iterations)
        t_dev = torch.from_numpy(times.astype(np.float32)).to(self.device)
        lr_dev = torch.from_numpy(self._lr_schedule(iterations)).to(
            self.device)
        carry = (torch.zeros((self.q, self.c), dtype=torch.float32,
                             device=self.device),
                 torch.ones((), dtype=torch.float32, device=self.device))
        outs = []
        losses = np.full(iterations, np.nan)
        accs = np.full(iterations, np.nan)
        for it in range(iterations):
            carry, out = step(consts, carry, (t_dev[it], lr_dev[it]))
            outs.append(out)
            if eval_fn is not None and (it % eval_every == 0
                                        or it == iterations - 1):
                loss, acc = eval_fn(carry[0])
                losses[it], accs[it] = float(loss), float(acc)
        t_rounds, n_ret, n_masked, skipped = (
            torch.stack(col).cpu().numpy() for col in zip(*outs))
        wall = self.setup_time + np.cumsum(t_rounds.astype(np.float64))
        history = [
            RoundLog(it, float(wall[it]), int(n_ret[it]), float(losses[it]),
                     float(accs[it]), n_masked=int(n_masked[it]),
                     skipped=int(skipped[it]))
            for it in range(iterations)]
        health = RunHealth(
            rounds_degraded=int(np.sum(n_masked > 0)),
            returns_masked=int(np.sum(n_masked)),
            rounds_skipped=int(np.sum(skipped)),
            lr_scale=float(carry[1]))
        return FedResult(theta=carry[0], history=history, t_star=self.t_star,
                         loads=self.loads, setup_time=self.setup_time,
                         privacy_eps=self.privacy_eps, health=health)
