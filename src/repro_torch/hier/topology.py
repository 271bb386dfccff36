"""Two-level hierarchical topology: edge aggregators over client shards
(the port of ``repro.hier.topology``).

`HierExperiment` scales the CodedFedL round from one MEC cell to a
population of n = 1e5-1e6 clients by partitioning the population into
``spec.hier_shards`` contiguous edge-aggregator shards.  Each shard runs
the paper's static coded round over its own cohort — its own two-step
load allocation (the chunked solver, `repro_torch.hier.population`), its
own deadline t*_s, its own global parity set encoded from its clients —
and contributes ONE aggregate gradient row to the server-level combine.
The server round completes when the slowest edge aggregator does
(``t_round = max_s t*_s``) and applies the flat engine's update rule

    theta <- theta - lr * (g_sum / m + l2 * theta),    m = n * l,

in float32 on the device, with ``g_sum`` the sum of the shard rows.

On the device a shard's round is three steps, as the reference's:
``linreg_grad_masked`` over the shard's (n_s, l, q) block with the
prefix mask, the returned-mask sum, and ``w(f) * coded_gradient`` over the
shard's (u_s, q) parity set (one ``linreg_grad`` launch, carrying the
1/u scale); a round is two launches a shard.  The shard's parity set is
encoded in blocks of ``encode_block`` clients through
``encoding.encode_local_batched`` (two ``parity_encode_batched`` launches
a block) and summed into the shard's set.

Per-round client sampling (``spec.sample_fraction`` < 1, Bernoulli(f)
cohorts from the dedicated `repro_torch.hier.sampling` stream) drops
clients from a round without touching the delay stream; every shard's
parity gradient is scaled by the coded-compensation reweight
`sampling.parity_reweight` so the update stays an unbiased SGD step.

Memory contract: nothing O(n * l * q) is ever materialized.  Client
tensors exist one shard at a time: ``data_fn(lo, hi)`` (or the slice of
the dense host stacks) is called, and its block uploaded to the device,
for every shard in every round, so the peak transient is the largest
shard's ``(n_s, l, q)`` feature block plus its ``(n_s, q, c)`` gradient
stack (`peak_client_tensor_bytes`).  Population state is O(n) scalars
only (stacked delay arrays, loads, per-round delay and cohort rows).

Parity generators.  The reference draws shard s's generators from
``fold_in(PRNGKey(fl.seed + 99), s)``, a ``jax.random`` split chain per
encode block.  The port draws them from a CPU ``torch.Generator`` per
shard, client after client, seeded from ``SeedSequence((fl.seed + 99,
s))``: shards draw disjoint streams, and the draw does not depend on
``encode_block``.  The same seed gives other numbers than the reference's
threefry; a run that must follow the reference takes its per-shard
``(n_s, u_s, l)`` stacks over (``parity_generators``, see
``repro_torch.carry.hier_generators_from_reference``).

Two deliberate divergences from the flat engine (the identity
configuration ``hier_shards=1, sample_fraction=1.0`` never sees them —
`repro_torch.api.build_experiment` routes it to the flat `Experiment`):

  * processed subsets are load-PREFIXES of each client's local set instead
    of the flat engine's permuted subsets;
  * per-client return probabilities come from the vectorized
    `population.return_prob`.

Resumability: `RunState` (mode ``"hier"``) carries the delay-stream AND
the sampling-stream RNG positions; both streams are consumed row-major
over rounds, so any block partition of a run — and any kill/resume at a
block boundary — replays bit-identically.
"""
from __future__ import annotations

import dataclasses
import os
import types
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.config import ExperimentSpec
from repro_torch.core import aggregation, encoding
from repro_torch.core import schemes as schemes_registry
from repro_torch.core.delay_model import (packet_bits,
                                          sample_round_times_stacked)
from repro_torch.core.run_state import RunState, pack_state, unpack_state
from repro_torch.device import resolve_device
from repro_torch.hier import population, sampling
from repro_torch.obs import spans as obs_spans

#: default client block width of the streamed parity encode (encode
#: memory is O(encode_block * u * l), never O(n_s * u * l))
DEFAULT_ENCODE_BLOCK = 1024

#: the parity-generator stream offset, as the flat coded setup's
GENERATOR_SEED_OFFSET = 99


def shard_ranges(n: int, shards: int) -> list[tuple[int, int]]:
    """Balanced contiguous client ranges [(lo, hi), ...] for the shards.

    The first ``n % shards`` shards take one extra client, so shard sizes
    differ by at most one.
    """
    if not isinstance(shards, int) or isinstance(shards, bool) or shards < 1:
        raise ValueError(f"hier_shards must be an int >= 1, got {shards!r}")
    if shards > n:
        raise ValueError(
            f"hier_shards={shards} exceeds the population n_clients={n}")
    base, rem = divmod(n, shards)
    out, lo = [], 0
    for s in range(shards):
        hi = lo + base + (1 if s < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


def shard_generator(fl_seed: int, shard: int) -> torch.Generator:
    """The CPU generator of shard `shard`'s parity generators, seeded from
    ``SeedSequence((fl_seed + 99, shard))``."""
    seed = np.random.SeedSequence(
        (fl_seed + GENERATOR_SEED_OFFSET, shard)).generate_state(
            1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


@dataclasses.dataclass
class ShardPlan:
    """One edge aggregator's frozen deployment (setup output)."""
    lo: int                      # client range [lo, hi)
    hi: int
    t_star: float                # shard deadline (chunked two-step solve)
    u: int                       # shard parity rows
    loads: np.ndarray            # (n_s,) int optimal per-client loads
    p_return: np.ndarray         # (n_s,) P(T_j <= t*_s) at its load
    gmask: torch.Tensor          # (n_s, l) f32 prefix-validity mask
    parity_x: torch.Tensor       # (u, q) shard-global parity features
    parity_y: torch.Tensor       # (u, c) shard-global parity targets
    parity_weight: float         # coded-compensation reweight w(f)
    expected_return_mass: float  # R_s = sum_j l_j P(T_j <= t*_s)
    setup_time: float            # one-time parity-upload overhead (s)

    @property
    def n_clients(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass
class HierResult:
    """Completed hierarchical run (the tier's `FedResult` analogue)."""
    theta: torch.Tensor          # (q, c) final iterate
    t_rounds: np.ndarray         # (iterations,) simulated round times
    n_ret: np.ndarray            # (iterations,) in-cohort returns by t*
    wall_clock: np.ndarray       # setup_time + cumsum(t_rounds)
    setup_time: float            # max over shards
    t_round: float               # max_s t*_s (server combine deadline)
    shards: int
    sample_fraction: float
    plans: list                  # per-shard `ShardPlan` provenance


def _coded_static_names() -> tuple[str, ...]:
    """Registered coded-family schemes with the STATIC coded step."""
    return tuple(n for n in schemes_registry.coded_names()
                 if schemes_registry.get_scheme(n).step_kind == "coded")


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class HierExperiment:
    """One runnable hierarchical deployment (module docstring).

    Data comes in either dense — ``x_stack (n, l, q)``, ``y_stack
    (n, l, c)`` on the host, sliced per shard — or streamed via
    ``data_fn(lo, hi) -> (x, y)`` returning the block for clients [lo, hi)
    as NumPy arrays or tensors.  ``solver_block`` is the chunked
    allocation solver's node-block width (never changes results);
    ``encode_block`` bounds the streamed parity encode's transient;
    ``solver_kwargs`` sets the solver's iteration counts.  ``device``
    defaults to the GPU; ``"cpu"`` runs the plain versions of the kernels.
    ``parity_generators`` is a list of per-shard ``(n_s, u_s, l)`` stacks
    in place of the port's own draw.

    The driving surface mirrors the flat engine: `init_state` /
    `run_block` / `finish` over an explicit `RunState` (mode "hier"),
    `save_state` / `restore_state` checkpoints with spec provenance, and
    `run` chaining them block by block.
    """

    def __init__(self, spec: ExperimentSpec, x_stack=None, y_stack=None, *,
                 data_fn: Optional[Callable] = None,
                 rng: Optional[np.random.Generator] = None,
                 solver_block: Optional[int] = None,
                 encode_block: int = DEFAULT_ENCODE_BLOCK,
                 solver_kwargs: Optional[dict] = None,
                 device=None, parity_generators=None):
        if not isinstance(spec, ExperimentSpec):
            raise TypeError(
                f"spec must be an ExperimentSpec, got {type(spec).__name__}")
        if spec.engine != "batched":
            raise ValueError(
                "the hierarchical tier requires the batched engine "
                f"(spec.engine={spec.engine!r})")
        self.spec = spec
        self.scheme = spec.resolved_scheme
        self.scheme_obj = schemes_registry.get_scheme(self.scheme)
        if self.scheme_obj.step_kind != "coded":
            raise ValueError(
                f"scheme {self.scheme!r} (step_kind="
                f"{self.scheme_obj.step_kind!r}) cannot drive the "
                "hierarchical tier: edge aggregators run the static coded "
                "round — expected one of the registered coded-family "
                f"schemes {_coded_static_names()}")
        self.scheme_params = spec.scheme_params_dict
        fl = spec.resolved_fl()
        self.fl = fl
        self.train = spec.train
        self.n = fl.n_clients
        self.device = resolve_device(device)
        self.sample_fraction = float(spec.sample_fraction)
        self.steps_per_epoch = spec.steps_per_epoch
        self.checkpoint_every = spec.checkpoint_every
        # --- data plumbing: dense host slices or a streaming block callable
        if data_fn is not None:
            if x_stack is not None or y_stack is not None:
                raise ValueError(
                    "pass dense x_stack/y_stack OR a data_fn, not both")
            probe_x, probe_y = (_host(a) for a in data_fn(0, 1))
            if probe_x.ndim != 3 or probe_y.ndim != 3 \
                    or probe_x.shape[0] != 1 or probe_y.shape[0] != 1 \
                    or probe_x.shape[1] != probe_y.shape[1]:
                raise ValueError(
                    "data_fn(0, 1) must return ((1, l, q), (1, l, c)) "
                    f"blocks, got {probe_x.shape} / {probe_y.shape}")
            self.l, self.q = int(probe_x.shape[1]), int(probe_x.shape[2])
            self.c = int(probe_y.shape[2])
            self._data = data_fn
        else:
            if x_stack is None or y_stack is None:
                raise ValueError("HierExperiment needs x_stack/y_stack "
                                 "or a data_fn")
            x, y = _host(x_stack), _host(y_stack)
            if x.shape[0] != self.n:
                raise ValueError(
                    f"x_stack covers {x.shape[0]} clients but "
                    f"fl.n_clients={self.n}")
            self.l, self.q = int(x.shape[1]), int(x.shape[2])
            self.c = int(y.shape[2])
            self._x_np, self._y_np = x, y
            self._data = lambda lo, hi: (self._x_np[lo:hi],
                                         self._y_np[lo:hi])
        self.m = self.n * self.l
        if encode_block < 1:
            raise ValueError(f"encode_block={encode_block} must be >= 1")
        self._encode_block = int(encode_block)
        self._solver_block = int(solver_block or population.DEFAULT_BLOCK)
        self._solver_kwargs = dict(solver_kwargs or {})
        # --- population delay state: O(n) scalars, zero node objects
        self._prm = population.population_delay_arrays(fl, self.q * self.c)
        self._ranges = shard_ranges(self.n, spec.hier_shards)
        if parity_generators is not None \
                and len(parity_generators) != len(self._ranges):
            raise ValueError(
                f"parity_generators holds {len(parity_generators)} stacks; "
                f"the deployment has {len(self._ranges)} shards")
        self._generators = parity_generators
        # telemetry capture (repro_torch.obs): per-block delay/cohort
        # arrays kept only while spans are enabled, feeding `attribution()`
        self._attr_blocks: "list[dict]" = []
        with obs_spans.span("setup/experiment", sync=self.device):
            self.plans = [self._setup_shard(s, lo, hi)
                          for s, (lo, hi) in enumerate(self._ranges)]
        self.setup_time = max(p.setup_time for p in self.plans)
        self.t_round = max(p.t_star for p in self.plans)
        self._pop_loads = np.concatenate(
            [p.loads for p in self.plans]).astype(np.float64)
        self.rng = rng or np.random.default_rng(fl.seed + 17)
        self._sample_rng = sampling.sampling_rng(fl.seed)

    # -------------------------------------------------------------- setup
    def _upload(self, arr) -> torch.Tensor:
        """A host block (NumPy or tensor) as a float32 tensor on the
        device."""
        if isinstance(arr, torch.Tensor):
            return arr.to(device=self.device, dtype=torch.float32)
        return torch.from_numpy(
            np.ascontiguousarray(arr, dtype=np.float32)).to(self.device)

    def _shard_data(self, lo: int, hi: int):
        """Clients [lo, hi) of the population, uploaded to the device."""
        xb, yb = self._data(lo, hi)
        return self._upload(xb), self._upload(yb)

    def _setup_shard(self, s: int, lo: int, hi: int) -> ShardPlan:
        """One edge aggregator's coded deployment over clients [lo, hi)."""
        with obs_spans.span("hier/shard_setup", sync=self.device):
            return self._setup_shard_inner(s, lo, hi)

    def _shard_generators(self, s: int, n_s: int, u_s: int):
        """Yield shard `s`'s (b - a, u_s, l) generator blocks on the
        device, one an encode block."""
        if self._generators is None:
            gen = shard_generator(self.fl.seed, s)

            def draw(a, b):
                return torch.stack([encoding.generator_matrix(gen, u_s,
                                                              self.l)
                                    for _ in range(b - a)])
        else:
            carried = torch.as_tensor(self._generators[s],
                                      dtype=torch.float32)
            if tuple(carried.shape) != (n_s, u_s, self.l):
                raise ValueError(
                    f"parity_generators[{s}] has shape "
                    f"{tuple(carried.shape)}, shard {s} needs (n_s, u_s, "
                    f"l) = {(n_s, u_s, self.l)}")

            def draw(a, b):
                return carried[a:b]
        for a in range(0, n_s, self._encode_block):
            b = min(a + self._encode_block, n_s)
            yield a, b, draw(a, b).to(self.device)

    def _setup_shard_inner(self, s: int, lo: int, hi: int) -> ShardPlan:
        fl = self.fl
        n_s = hi - lo
        m_s = n_s * self.l
        # redundancy rule via the registered scheme's own u_budget (the
        # shard IS the scheme's deployment, so partial_coded's u_fraction
        # etc. apply per shard)
        shim = types.SimpleNamespace(fl=fl, m=m_s,
                                     scheme_params=self.scheme_params)
        u_s = int(self.scheme_obj.u_budget(shim))
        sub = {k: v[lo:hi] for k, v in self._prm.items()}
        with obs_spans.span("solver/two_step"):
            alloc = population.two_step_allocate_chunked(
                prm=sub, client_caps=float(self.l), server=None,
                u_max=float(u_s), m=float(m_s),
                block_size=min(self._solver_block, n_s), device=self.device,
                **self._solver_kwargs)
        loads = np.minimum(np.floor(alloc.loads).astype(int), self.l)
        p_ret = population.return_prob(self._prm, lo, hi, alloc.t_star,
                                       loads)
        p_ret = np.where(loads > 0, p_ret, 0.0)
        # prefix processed subsets: the first l*_j points of each client's
        # local set
        prefix = np.arange(self.l)[None, :] < loads[:, None]      # (n_s, l)
        w_stack = np.where(prefix, np.sqrt(1.0 - p_ret)[:, None],
                           1.0).astype(np.float32)
        px = torch.zeros((u_s, self.q), dtype=torch.float32,
                         device=self.device)
        py = torch.zeros((u_s, self.c), dtype=torch.float32,
                         device=self.device)
        with obs_spans.span("encode/parity", sync=self.device):
            for a, b, g in self._shard_generators(s, n_s, u_s):
                xb, yb = self._shard_data(lo + a, lo + b)
                stacked = encoding.encode_local_batched(
                    g, xb, yb, self._upload(w_stack[a:b]))
                agg = encoding.aggregate_parity_stacked(stacked)
                px = px + agg.x
                py = py + agg.y
        r_mass = float(np.sum(loads * p_ret))
        w_f = sampling.parity_reweight(m_s, r_mass, self.sample_fraction)
        # one-time parity upload overhead (the flat coded formula over the
        # stacked arrays)
        bits = packet_bits(fl, u_s * (self.q + self.c))
        unit = packet_bits(fl, self.q * self.c)
        setup = float(np.max(sub["tau_down"] / unit * bits
                             / (1.0 - sub["p_down"])))
        return ShardPlan(
            lo=lo, hi=hi, t_star=float(alloc.t_star), u=u_s, loads=loads,
            p_return=p_ret, gmask=self._upload(prefix), parity_x=px,
            parity_y=py, parity_weight=float(w_f),
            expected_return_mass=r_mass, setup_time=setup)

    @staticmethod
    def _shard_round(x, y, gmask, ret, theta, par_x, par_y, w_par):
        """One edge aggregator's round: the masked client gradients (one
        ``linreg_grad_masked`` launch), their returned-mask sum, and the
        reweighted coded gradient (one ``linreg_grad`` launch)."""
        grads = aggregation.batched_client_gradients(x, y, theta, mask=gmask)
        g = aggregation.masked_gradient_sum(grads, ret)
        return g + w_par * aggregation.coded_gradient(par_x, par_y, theta)

    # ------------------------------------------------------------ schedule
    def _lr(self, epoch: int) -> float:
        lr = self.train.learning_rate
        for e in self.train.lr_decay_epochs:
            if epoch >= e:
                lr *= self.train.lr_decay
        return lr

    def _lr_schedule_range(self, r0: int, r1: int) -> np.ndarray:
        return np.array([self._lr(it // self.steps_per_epoch)
                         for it in range(r0, r1)], np.float32)

    # ------------------------------------------------------------- memory
    def peak_client_tensor_bytes(self) -> int:
        """Peak transient client-tensor footprint of one round (bytes):
        the largest shard's f32 feature/target block plus its gradient
        stack — the O(active cohort) quantity the scale section records."""
        n_s = max(hi - lo for lo, hi in self._ranges)
        return 4 * n_s * (self.l * (self.q + self.c) + self.q * self.c)

    def population_tensor_bytes(self) -> int:
        """Resident O(n)-scalar population state (bytes): stacked delay
        arrays + per-client loads (all float64)."""
        return 8 * self.n * (len(self._prm) + 1)

    # ------------------------------------------------------------- running
    def init_state(self, iterations: int) -> RunState:
        """Fresh mode-"hier" `RunState`, seeded from this experiment's
        live delay and sampling streams (back-to-back runs consume
        disjoint randomness, like the flat engine)."""
        iterations = int(iterations)
        if iterations < 1:
            raise ValueError(f"iterations={iterations} must be >= 1")
        self._attr_blocks = []   # attribution covers the new run only
        return RunState(
            mode="hier", iterations=iterations, rounds_done=0,
            realizations_done=0, n_realizations=None, collect=False,
            theta=torch.zeros((self.q, self.c), dtype=torch.float32,
                              device=self.device),
            rng_state=self.rng.bit_generator.state,
            trace_call=-1, trace=None, est=None, controls=None,
            t_rounds=np.zeros(0, np.float64),
            n_ret=np.zeros(0, np.int32),
            losses=None, accs=None, sched=None,
            sample_rng_state=self._sample_rng.bit_generator.state)

    def _draw_block(self, state: RunState, K: int):
        """The next `K` rounds' delays (K, n) float64 and cohorts (K, n)
        bool from the state's two streams, and the streams' new states.
        Both streams draw a fixed layout a round (delays: one 3-draw row;
        sampling: one uniform row), so the position depends only on the
        global round cursor."""
        rng = np.random.default_rng()
        rng.bit_generator.state = state.rng_state
        srng = np.random.default_rng()
        srng.bit_generator.state = state.sample_rng_state
        times = np.concatenate(
            [sample_round_times_stacked(self._prm, self._pop_loads, rng, 1)
             for _ in range(K)], axis=0)
        cohort = sampling.sample_cohort_rows(srng, K, self.n,
                                             self.sample_fraction)
        return times, cohort, rng.bit_generator.state, \
            srng.bit_generator.state

    def _returned(self, times: np.ndarray, cohort: np.ndarray) -> np.ndarray:
        """(K, n) bool: in the round's cohort and back by the shard's
        deadline t*_s (float64 comparisons on the host)."""
        ret = np.zeros(times.shape, bool)
        for plan in self.plans:
            ret[:, plan.lo:plan.hi] = ((times[:, plan.lo:plan.hi]
                                        <= plan.t_star)
                                       & cohort[:, plan.lo:plan.hi])
        return ret

    def run_block(self, state: RunState,
                  n_rounds: Optional[int] = None) -> RunState:
        """Advance a hierarchical run by one block (new state returned,
        input never mutated).  ``n_rounds`` defaults to
        ``spec.checkpoint_every``, or the remaining horizon when 0.

        The block's returned masks go to the device in one copy; each
        round uploads every shard's client block in turn and launches two
        kernels a shard.
        """
        if state.mode != "hier":
            raise ValueError(f"run_block(hier) got a {state.mode!r} state")
        if state.done:
            raise ValueError(
                "run is already complete "
                f"({state.rounds_done}/{state.iterations} rounds)")
        r0 = state.rounds_done
        K = int(n_rounds) if n_rounds is not None else (
            self.checkpoint_every or state.iterations)
        if K < 1:
            raise ValueError(f"n_rounds={K} must be >= 1")
        K = min(K, state.iterations - r0)
        times, cohort, rng_state, srng_state = self._draw_block(state, K)
        if obs_spans.enabled():
            self._attr_blocks.append({"times": times, "active": cohort})
        ret = self._returned(times, cohort)
        n_ret_blk = ret.sum(axis=1).astype(np.int32)
        lrs = self._upload(self._lr_schedule_range(r0, r0 + K))
        ret_dev = self._upload(ret)
        l2 = float(np.float32(self.train.l2_reg))
        m = float(np.float32(self.m))
        weights = [float(np.float32(p.parity_weight)) for p in self.plans]
        theta = state.theta
        with obs_spans.span("hier/round_block", sync=self.device):
            for k in range(K):
                g = torch.zeros((self.q, self.c), dtype=torch.float32,
                                device=self.device)
                for plan, w_par in zip(self.plans, weights):
                    xb, yb = self._shard_data(plan.lo, plan.hi)
                    g = g + self._shard_round(
                        xb, yb, plan.gmask, ret_dev[k, plan.lo:plan.hi],
                        theta, plan.parity_x, plan.parity_y, w_par)
                theta = theta - lrs[k] * (g / m + l2 * theta)
        return dataclasses.replace(
            state, rounds_done=r0 + K, theta=theta, rng_state=rng_state,
            sample_rng_state=srng_state,
            t_rounds=np.concatenate(
                [state.t_rounds, np.full(K, self.t_round, np.float64)]),
            n_ret=np.concatenate([state.n_ret, n_ret_blk]))

    # ------------------------------------------------------------ telemetry
    def attribution(self, k: int = 3) -> dict:
        """Per-shard straggler attribution (`repro_torch.obs.attribution`)
        over the delay/cohort blocks captured while telemetry was enabled:
        ``{shard_index: Attribution}``, each shard attributed against its
        own deadline t*_s, loads, and data mass.  Covers rounds computed
        in this process since the last `init_state`/`restore_state`.
        Raises `RuntimeError` when nothing was captured."""
        from repro_torch.obs.attribution import compute_attribution
        if not self._attr_blocks:
            raise RuntimeError(
                "no telemetry captured for this run: call "
                "repro_torch.obs.spans.enable() before running, then "
                "attribution()")
        times = np.concatenate([b["times"] for b in self._attr_blocks])
        cohort = np.concatenate([b["active"] for b in self._attr_blocks])
        out = {}
        for s, plan in enumerate(self.plans):
            deadline = np.full(times.shape[0], float(plan.t_star),
                               np.float64)
            out[s] = compute_attribution(
                times[:, plan.lo:plan.hi], cohort[:, plan.lo:plan.hi],
                deadline, loads=plan.loads,
                m=plan.n_clients * self.l, coded=True, k=k)
        return out

    # --------------------------------------------------------- checkpoints
    def save_state(self, path: str, state: RunState) -> str:
        """Checkpoint `state` atomically with spec provenance."""
        arrays, meta = pack_state(state)
        meta["spec"] = self.spec.to_dict()
        with obs_spans.span("checkpoint/save"):
            return ckpt_io.save_state(path, arrays, meta)

    def restore_state(self, path: str) -> RunState:
        """Load a checkpoint onto this experiment's device, verifying its
        spec matches this deployment."""
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
                    "experiment's — refusing to resume across specs")
        return unpack_state(arrays, meta, device=self.device)

    # ----------------------------------------------------------- finishing
    def finish(self, state: RunState) -> HierResult:
        """Completed state -> `HierResult`; syncs both stream positions
        so back-to-back runs stay disjoint."""
        if not state.done:
            raise ValueError(
                f"run is not complete ({state.rounds_done}/"
                f"{state.iterations} rounds); call run_block until "
                "state.done")
        if state.mode != "hier":
            raise ValueError(f"finish(hier) got a {state.mode!r} state")
        self.rng.bit_generator.state = state.rng_state
        self._sample_rng.bit_generator.state = state.sample_rng_state
        return HierResult(
            theta=state.theta, t_rounds=np.asarray(state.t_rounds),
            n_ret=np.asarray(state.n_ret),
            wall_clock=self.setup_time + np.cumsum(state.t_rounds),
            setup_time=self.setup_time, t_round=self.t_round,
            shards=len(self.plans),
            sample_fraction=self.sample_fraction, plans=self.plans)

    def run(self, iterations: int, *,
            checkpoint_dir: Optional[str] = None, resume: bool = False,
            n_rounds: Optional[int] = None,
            journal_dir: Optional[str] = None) -> HierResult:
        """Run `iterations` rounds block by block (the flat engine's
        driving contract: checkpoint every block boundary when a directory
        is given, ``resume=True`` restores the latest checkpoint there,
        ``journal_dir`` appends one `repro_torch.obs` event per round —
        with the per-shard deadlines ``t_star_s`` — at the same
        boundaries)."""
        state = None
        if resume:
            if checkpoint_dir is None:
                raise ValueError("resume=True requires checkpoint_dir")
            latest = ckpt_io.latest_checkpoint(checkpoint_dir,
                                               valid_only=True)
            if latest is not None:
                state = self.restore_state(latest)
                if state.mode != "hier":
                    raise ValueError(
                        f"checkpoint {latest!r} holds a {state.mode!r} "
                        "run; resume it with the flat engine")
                if state.iterations != int(iterations):
                    raise ValueError(
                        f"checkpoint {latest!r} is a {state.iterations}-"
                        f"round run; this run asked for {iterations}")
        if state is None:
            state = self.init_state(iterations)
        journal = None
        if journal_dir is not None:
            from repro_torch.obs.events import RunJournal
            journal = RunJournal(journal_dir)
            journal.reset_to(state.rounds_done)
            journal.sync(self, state)
        while not state.done:
            state = self.run_block(state, n_rounds)
            if checkpoint_dir is not None:
                self.save_state(
                    os.path.join(
                        checkpoint_dir,
                        f"{ckpt_io.CKPT_PREFIX}"
                        f"{state.rounds_done:06d}.npz"),
                    state)
            if journal is not None:
                journal.sync(self, state)
        return self.finish(state)
