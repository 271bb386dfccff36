"""Straggler-mitigation scheme registry (the paper's §V "Schemes").

The port of ``repro.core.schemes``:

  naive          — server waits for ALL n clients (full load).
  greedy         — server waits for the fastest (1-psi)*n clients.
  ideal          — deterministic no-straggler floor: full load, exact
                   compute, one transmission per direction.
  coded          — CodedFedL: optimized loads l*_j + a global parity set
                   with redundancy u = delta * m; round time = t*.
  partial_coded  — coded with a fraction of the redundancy budget,
                   u = u_fraction * delta * m (``scheme_params``
                   "u_fraction", default 0.5).
  adaptive_coded — coded with the loads and t* re-solved every
                   ``adapt_every`` rounds on the estimated network
                   (`repro_torch.net.estimator`), applied as per-block
                   prefix masks over full-length client rows.
  adaptive_greedy — greedy with the wait count re-tuned every
                   ``adapt_every`` rounds.

Each scheme owns its host-side deployment setup (load allocation, parity
construction, privacy accounting) and its contribution to the round step
(`fed_runtime.build_step`).  The adaptive schemes opt out of the profile
grid (``grid = False``), as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import (aggregation, encoding, load_allocation,
                              privacy, secure_agg)
from repro_torch.core.delay_model import ideal_round_time, packet_bits
from repro_torch.obs import spans as obs_spans

STEP_KINDS = ("naive", "greedy", "coded", "ideal", "adaptive_coded",
              "adaptive_greedy")


class Scheme:
    """Base scheme: full per-client loads, no parity, no deadline consts.

    Subclasses set ``name`` (registry key) and ``step_kind`` (the branch of
    `fed_runtime.build_step`: one of `STEP_KINDS`).  ``coded`` marks
    schemes that allocate loads and build a parity set; ``grid`` those
    that belong to the default profile-grid sweep (the adaptive schemes
    opt out: they need a channel trace and a per-run control schedule).
    """
    name: str = ""
    step_kind: str = ""
    coded: bool = False
    grid: bool = True

    def setup(self, exp) -> None:
        """Host-side deployment setup; mutates the Experiment in place."""

    def consts_point_len(self, exp) -> int:
        """Point-axis length of `grad_tensors`' gx: shape arithmetic only,
        so a sweep computes its grid-wide l_target without building the
        tensors."""
        return exp.l

    def grad_tensors(self, exp, l_target=None):
        """(gx, gy, gmask, ret_tail) — the dense client gradient tensors.

        ret_tail lists the returned-mask entries of any pseudo-client rows
        appended past the n real clients.  `l_target` pads the point axis
        to a common length (`repro_torch.launch.sweep`); full-load schemes
        are at their length already (`consts_point_len` is l), and ignore
        it, as in the reference.
        """
        gmask = torch.ones((exp.n, exp.l), dtype=torch.float32,
                           device=exp.device)
        return exp.x, exp.y, gmask, []

    def extra_consts(self, exp) -> dict:
        """Scheme-specific entries of the step `consts`."""
        return {}

    def privacy_budget(self, exp):
        """Worst-case eps-MI-DP leakage (bits) of what clients share, or
        None when nothing beyond gradients leaves the device."""
        return None

    def replan(self, exp, estimator) -> dict:
        """Adaptive-family hook: new control values from the estimated
        network, called by `repro_torch.net.estimator.plan_segment`
        between sub-blocks ({"loads", "t_star"} for the coded family,
        {"n_wait"} for the greedy family); other schemes never re-plan."""
        raise NotImplementedError(f"{self.name!r} is not adaptive")

    def initial_controls(self, exp) -> dict:
        """The control values in effect at round 0 of a fresh `RunState`:
        the load vector, the wait count and (coded family) the setup-time
        deadline (``t_star`` None otherwise)."""
        return {"loads": np.asarray(exp.loads, np.float64).copy(),
                "t_star": exp.t_star, "n_wait": exp.n_wait}

    def __repr__(self):
        return f"<Scheme {self.name!r} step_kind={self.step_kind!r}>"


class NaiveScheme(Scheme):
    name = "naive"
    step_kind = "naive"


class GreedyScheme(Scheme):
    name = "greedy"
    step_kind = "greedy"


class IdealScheme(Scheme):
    """Deterministic no-straggler baseline: naive's gradients, with the
    round clock at the deterministic floor `ideal_round_time`."""
    name = "ideal"
    step_kind = "ideal"

    def setup(self, exp) -> None:
        exp.t_ideal = ideal_round_time(exp.nodes, float(exp.l))

    def extra_consts(self, exp) -> dict:
        return {"t_ideal": torch.tensor(exp.t_ideal, dtype=torch.float32,
                                        device=exp.device)}


class CodedScheme(Scheme):
    """CodedFedL (paper §III): optimized loads + global parity set."""
    name = "coded"
    step_kind = "coded"
    coded = True

    def u_budget(self, exp) -> int:
        """Parity rows u to build — the full paper budget delta * m."""
        return max(1, int(round(exp.fl.delta * exp.m)))

    def setup(self, exp) -> None:
        """`repro.core.schemes.CodedScheme.setup`, step for step, on the
        same host generator `exp.rng`."""
        fl = exp.fl
        u_max = self.u_budget(exp)
        with obs_spans.span("solver/two_step"):
            if exp._pick_alloc_backend() == "vectorized":
                alloc = load_allocation.two_step_allocate_vectorized(
                    exp.nodes, [float(exp.l)] * exp.n, server=None,
                    u_max=float(u_max), m=float(exp.m), device=exp.device)
            else:
                alloc = load_allocation.two_step_allocate(
                    exp.nodes, [float(exp.l)] * exp.n, server=None,
                    u_max=float(u_max), m=float(exp.m))
        exp.t_star = alloc.t_star
        exp.u = u_max
        # integer loads (floor, at least 0)
        exp.loads = np.minimum(np.floor(alloc.loads).astype(int), exp.l)
        # probability of return by t* per client at its optimal load
        exp.p_return = np.array([
            nd.cdf(exp.t_star, float(ld)) if ld > 0 else 0.0
            for nd, ld in zip(exp.nodes, exp.loads)])
        # processed subsets: one `rng.permuted` draw over an (n, l) index
        # matrix; point perm[j, k] is the k-th point client j processes
        perm = exp.rng.permuted(
            np.tile(np.arange(exp.l), (exp.n, 1)), axis=1)
        # selection-priority order: the adaptive family re-masks prefixes
        # of it when it re-allocates loads
        exp._select_perm = perm
        take = np.arange(exp.l)[None, :] < exp.loads[:, None]   # (n, l)
        processed = np.zeros((exp.n, exp.l), dtype=bool)
        row_ids = np.broadcast_to(np.arange(exp.n)[:, None],
                                  (exp.n, exp.l))
        processed[row_ids[take], perm[take]] = True
        exp.processed_idx = [np.nonzero(processed[j])[0]
                             for j in range(exp.n)]
        # weight matrices (paper §III-D): sqrt(1 - P(return)) on processed
        # points, 1 elsewhere
        w_stack = np.where(processed,
                           np.sqrt(1.0 - exp.p_return)[:, None],
                           1.0).astype(np.float32)
        g_stack = exp.parity_generators
        if g_stack is None:
            g_stack = encoding.generator_stack(
                fl.seed + 99, exp.n, exp.u, exp.l, device=exp.device)
        elif tuple(g_stack.shape) != (exp.n, exp.u, exp.l):
            raise ValueError(
                f"parity_generators has shape {tuple(g_stack.shape)}, "
                f"the deployment needs (n, u, l) = "
                f"{(exp.n, exp.u, exp.l)}")
        exp.w_stack = torch.from_numpy(w_stack).to(exp.device)
        # all n local parity sets: two parity_encode_batched launches.  With
        # fused_embed the clients hold RAW features: the encode runs over a
        # transient (n, l, q) embed that only this setup step sees
        x_enc = exp.embedded_x() if exp.fused_embed else exp.x
        with obs_spans.span("encode/parity", sync=exp.device):
            stacked = encoding.encode_local_batched(g_stack, x_enc, exp.y,
                                                    exp.w_stack)
        if exp.secure_aggregation:
            # paper §VI future work: the server sees only masked uploads;
            # the pairwise masks cancel in their sum (core/secure_agg.py)
            uploads = secure_agg.masked_uploads(
                fl.seed + 1234, stacked, pair_masks=exp.secure_masks)
            exp.parity = secure_agg.secure_aggregate(uploads)
        else:
            exp.parity = encoding.aggregate_parity_stacked(stacked)
        # one-time parity upload overhead: clients upload u*(q+c) scalars
        # in parallel; expected transmissions 1/(1-p) (paper Fig 4a inset)
        bits = packet_bits(fl, exp.u * (exp.q + exp.c))
        exp.setup_time = max(
            nd.tau / packet_bits(fl, exp.q * exp.c) * bits / (1.0 - nd.p)
            for nd in exp.nodes)
        # ragged per-client subsets: only the legacy oracle reads them
        if exp.engine == "legacy":
            exp._sub_x = [exp.x[j][torch.from_numpy(exp.processed_idx[j]).to(
                exp.device)] for j in range(exp.n)]
            exp._sub_y = [exp.y[j][torch.from_numpy(exp.processed_idx[j]).to(
                exp.device)] for j in range(exp.n)]
        # dense mask-padded (n, l_max, ·) view: the chosen indices of each
        # row, sorted ascending, with unchosen slots pushed past the end
        # by an `l` sentinel
        l_max = max(1, int(exp.loads.max()))
        sorted_idx = np.sort(np.where(take, perm, exp.l), axis=1)[:, :l_max]
        valid = sorted_idx < exp.l
        rows = torch.from_numpy(np.where(valid, sorted_idx, 0)).to(
            exp.device)
        mask = torch.from_numpy(valid.astype(np.float32)).to(exp.device)
        clients = torch.arange(exp.n, device=exp.device)[:, None]
        exp._sub_x_pad = exp.x[clients, rows] * mask[:, :, None]
        exp._sub_y_pad = exp.y[clients, rows] * mask[:, :, None]
        exp._grad_mask = mask                     # (n, l_max) row validity

    def consts_point_len(self, exp) -> int:
        l_max = int(exp._sub_x_pad.shape[1])
        return max(l_max, exp.u) if exp.fused_coded else l_max

    def grad_tensors(self, exp, l_target=None):
        l_max = exp._sub_x_pad.shape[1]
        if not exp.fused_coded:
            # the coded gradient is a separate launch over par_x / par_y;
            # padding to l_target is zero rows past l_max, which the round
            # skips (live_rows (l_max, l_max), the launch plan unpadded)
            gx, gy, gmask = exp._sub_x_pad, exp._sub_y_pad, exp._grad_mask
            exp._live_rows = (l_max, l_max)
            if l_target is not None and l_target > l_max:
                pad = l_target - l_max
                gx = torch.nn.functional.pad(gx, (0, 0, 0, pad))
                gy = torch.nn.functional.pad(gy, (0, 0, 0, pad))
                gmask = torch.nn.functional.pad(gmask, (0, pad))
            return gx, gy, gmask, []
        if exp.fused_embed:
            # raw client rows; the embedded parity block rides in as the
            # `pphi` const the fused kernel reads on the parity row
            gx, gy, gmask, exp._pphi_const = \
                aggregation.fused_embed_client_parity_tensors(
                    exp._sub_x_pad, exp._sub_y_pad, exp._grad_mask,
                    exp.parity.x, exp.parity.y, pnr_c=0.0,
                    l_target=l_target)
        else:
            gx, gy, gmask = aggregation.fused_client_parity_tensors(
                exp._sub_x_pad, exp._sub_y_pad, exp._grad_mask,
                exp.parity.x, exp.parity.y, pnr_c=0.0, l_target=l_target)
        # past l_max client rows and u parity rows the tensors are zero
        # padding (l_target's too), which the kernel skips
        exp._live_rows = (l_max, exp.parity.x.shape[0])
        return gx, gy, gmask, [1.0]   # the always-active parity pseudo-row

    def extra_consts(self, exp) -> dict:
        consts = {
            "t_star": torch.tensor(exp.t_star, dtype=torch.float32,
                                   device=exp.device),
            "active": torch.from_numpy(
                (exp.loads > 0).astype(np.float32)).to(exp.device),
        }
        consts["live_rows"] = exp._live_rows
        if exp.fused_coded and exp.fused_embed:
            consts["pphi"] = exp._pphi_const
        if not exp.fused_coded:
            consts["par_x"] = exp.parity.x
            consts["par_y"] = exp.parity.y
        return consts

    def privacy_budget(self, exp) -> float:
        """Worst-client eps-MI-DP budget (bits) of sharing u parity rows
        (paper Appendix F, eq. 62), on the host in float64 as in the
        reference.  What leaks is the EMBEDDED data the parity rows are
        built from, so fused_embed runs account over the same transient
        embeds the parity encode consumed."""
        x_src = exp.embedded_x() if exp.fused_embed else exp.x
        x = x_src.cpu().numpy()
        return float(max(privacy.mi_dp_budget(x[j], exp.u)
                         for j in range(exp.n)))


class PartialCodedScheme(CodedScheme):
    """Coded with a tunable fraction of the redundancy budget,
    u = u_fraction * delta * m, u_fraction in (0, 1]."""
    name = "partial_coded"
    default_u_fraction = 0.5

    def u_fraction(self, exp) -> float:
        frac = float(exp.scheme_params.get("u_fraction",
                                           self.default_u_fraction))
        if not 0.0 < frac <= 1.0:
            raise ValueError(
                f"u_fraction must lie in (0, 1], got {frac}")
        return frac

    def u_budget(self, exp) -> int:
        return max(1, int(round(self.u_fraction(exp)
                                * exp.fl.delta * exp.m)))


class AdaptiveCodedScheme(CodedScheme):
    """CodedFedL with blockwise load re-allocation under network drift
    (``repro.core.schemes.AdaptiveCodedScheme``).

    Every ``adapt_every`` rounds the two-step allocation is re-solved on
    the estimated network; the new loads are prefix masks over each
    client's points in selection-priority order, so the (n+1, L, q) round
    tensor never changes, only the mask the round indexes by sub-block.
    The parity set stays the one built at setup.  ``scheme_params``:
    ``est_beta``, ``est_window`` (the estimator), ``avail_min`` (the
    availability score below which a client gets no load, default 0.5).

    Unlike the coded round, the client rows are NOT zero past a client's
    setup load: they hold every point in priority order, which a re-plan
    may switch on (up to l, past the setup's largest load).  So the round
    passes live_rows = (l, u).
    """
    name = "adaptive_coded"
    step_kind = "adaptive_coded"
    grid = False

    def setup(self, exp) -> None:
        if not exp.fused_coded:
            raise ValueError(
                "adaptive_coded requires fused_coded=True (re-allocation "
                "re-weights the fused client+parity mask)")
        if exp.fused_embed:
            raise NotImplementedError(
                "adaptive_coded does not support fused_embed yet (the "
                "per-block gmask re-weighting assumes embedded tensors)")
        super().setup(exp)
        # full-length priority view: every client's points in selection-
        # priority order, so any re-allocated load l_j <= l is a prefix
        # mask of the same (n, l) tensor
        perm = torch.from_numpy(exp._select_perm).to(exp.device)
        clients = torch.arange(exp.n, device=exp.device)[:, None]
        exp._adapt_x = exp.x[clients, perm]
        exp._adapt_y = exp.y[clients, perm]

    def consts_point_len(self, exp) -> int:
        return max(exp.l, exp.u)

    def grad_tensors(self, exp, l_target=None):
        # full-length tensors; the per-block prefix mask (not baked into
        # the data) selects the processed points
        gx, gy, gmask = aggregation.fused_client_parity_tensors(
            exp._adapt_x, exp._adapt_y,
            torch.from_numpy(self._prefix_mask(exp, exp.loads)).to(
                exp.device),
            exp.parity.x, exp.parity.y, pnr_c=0.0, l_target=l_target)
        exp._live_rows = (exp.l, exp.parity.x.shape[0])
        return gx, gy, gmask, [1.0]

    @staticmethod
    def _prefix_mask(exp, loads) -> np.ndarray:
        """(n, l) float32 prefix mask over the priority order."""
        loads = np.asarray(loads)
        return (np.arange(exp.l)[None, :]
                < loads[:, None]).astype(np.float32)

    def gmask_for_loads(self, exp, loads) -> torch.Tensor:
        """(n+1, L) float32 fused mask for a load vector, on the
        experiment's device: client prefix rows plus the 1/u-scaled parity
        pseudo-row."""
        L = max(exp.l, exp.u)
        mask = np.zeros((exp.n + 1, L), np.float32)
        mask[:exp.n, :exp.l] = self._prefix_mask(exp, loads)
        mask[exp.n, :exp.u] = 1.0 / exp.u
        return torch.from_numpy(mask).to(exp.device)

    def replan(self, exp, estimator) -> dict:
        est_nodes = estimator.estimated_nodes()
        avail_min = float(exp.scheme_params.get("avail_min", 0.5))
        caps = np.where(estimator.avail_hat >= avail_min, float(exp.l), 0.0)
        if exp._pick_alloc_backend() == "vectorized":
            def allocate(*args):
                return load_allocation.two_step_allocate_vectorized(
                    *args, device=exp.device)
        else:
            allocate = load_allocation.two_step_allocate
        with obs_spans.span("solver/two_step"):
            try:
                alloc = allocate(est_nodes, list(caps), None, float(exp.u),
                                 float(exp.m))
            except ValueError:
                # too many clients estimated unavailable for feasibility:
                # fall back to full caps rather than keep a stale plan
                alloc = allocate(est_nodes, [float(exp.l)] * exp.n, None,
                                 float(exp.u), float(exp.m))
        loads = np.minimum(np.floor(alloc.loads).astype(int), exp.l)
        return {"loads": loads, "t_star": float(alloc.t_star)}


class AdaptiveGreedyScheme(GreedyScheme):
    """Greedy waiting with an adaptively re-tuned wait count
    (``repro.core.schemes.AdaptiveGreedyScheme``): every ``adapt_every``
    rounds, the k minimizing E[T]_(k) / k over the estimated per-client
    expected delays of the clients whose availability score clears
    ``avail_min`` (default 0.5)."""
    name = "adaptive_greedy"
    step_kind = "adaptive_greedy"
    grid = False

    def replan(self, exp, estimator) -> dict:
        est_nodes = estimator.estimated_nodes()
        avail_min = float(exp.scheme_params.get("avail_min", 0.5))
        avail = estimator.avail_hat >= avail_min
        if not np.any(avail):
            return {"n_wait": 1}
        exp_delay = np.array([nd.expected_delay(float(exp.l))
                              for nd in est_nodes])
        srt = np.sort(np.where(avail, exp_delay, np.inf))
        k = np.arange(1, exp.n + 1, dtype=np.float64)
        with np.errstate(invalid="ignore"):
            cost = np.where(np.isfinite(srt), srt / k, np.inf)
        return {"n_wait": int(np.argmin(cost)) + 1}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Scheme] = {}


def register(scheme: Scheme, *, overwrite: bool = False) -> Scheme:
    """Register a Scheme instance under its ``name``."""
    if not scheme.name:
        raise ValueError(f"{scheme!r} has no name")
    if scheme.step_kind not in STEP_KINDS:
        raise ValueError(
            f"scheme {scheme.name!r} has unknown step_kind "
            f"{scheme.step_kind!r} (the port runs {STEP_KINDS})")
    if scheme.name in _REGISTRY and not overwrite:
        raise ValueError(f"scheme {scheme.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[scheme.name] = scheme
    return scheme


def unregister(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_scheme(name: str) -> Scheme:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown scheme {name!r} (registered: "
                         f"{registered_names()})") from None


def registered_names() -> tuple[str, ...]:
    """All registered scheme names, in registration order."""
    return tuple(_REGISTRY)


def coded_names() -> tuple[str, ...]:
    """Names of the coded-family schemes (parity + load allocation)."""
    return tuple(n for n, s in _REGISTRY.items() if s.coded)


def grid_names() -> tuple[str, ...]:
    """Schemes of the default profile grid (the adaptive ones opt out)."""
    return tuple(n for n, s in _REGISTRY.items() if s.grid)


register(CodedScheme())
register(NaiveScheme())
register(GreedyScheme())
register(IdealScheme())
register(PartialCodedScheme())
register(AdaptiveCodedScheme())
register(AdaptiveGreedyScheme())
