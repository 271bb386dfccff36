"""Straggler-mitigation scheme registry (the paper's §V "Schemes").

The port of ``repro.core.schemes`` for the stationary main path:

  naive          — server waits for ALL n clients (full load).
  greedy         — server waits for the fastest (1-psi)*n clients.
  ideal          — deterministic no-straggler floor: full load, exact
                   compute, one transmission per direction.
  coded          — CodedFedL: optimized loads l*_j + a global parity set
                   with redundancy u = delta * m; round time = t*.
  partial_coded  — coded with a fraction of the redundancy budget,
                   u = u_fraction * delta * m (``scheme_params``
                   "u_fraction", default 0.5).

Each scheme owns its host-side deployment setup (load allocation, parity
construction, privacy accounting) and its contribution to the round step
(`fed_runtime.build_step`).  The adaptive schemes of the reference are not
registered here yet.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import aggregation, encoding, load_allocation, privacy
from repro_torch.core.delay_model import ideal_round_time, packet_bits

STEP_KINDS = ("naive", "greedy", "coded", "ideal")


class Scheme:
    """Base scheme: full per-client loads, no parity, no deadline consts.

    Subclasses set ``name`` (registry key) and ``step_kind`` (the branch of
    `fed_runtime.build_step`: one of `STEP_KINDS`).  ``coded`` marks
    schemes that allocate loads and build a parity set.
    """
    name: str = ""
    step_kind: str = ""
    coded: bool = False

    def setup(self, exp) -> None:
        """Host-side deployment setup; mutates the Experiment in place."""

    def grad_tensors(self, exp):
        """(gx, gy, gmask, ret_tail) — the dense client gradient tensors.

        ret_tail lists the returned-mask entries of any pseudo-client rows
        appended past the n real clients.
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
        stacked = encoding.encode_local_batched(g_stack, x_enc, exp.y,
                                                exp.w_stack)
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

    def grad_tensors(self, exp):
        if not exp.fused_coded:
            # the coded gradient is a separate launch over par_x / par_y
            return exp._sub_x_pad, exp._sub_y_pad, exp._grad_mask, []
        if exp.fused_embed:
            # raw client rows; the embedded parity block rides in as the
            # `pphi` const the fused kernel reads on the parity row
            gx, gy, gmask, exp._pphi_const = \
                aggregation.fused_embed_client_parity_tensors(
                    exp._sub_x_pad, exp._sub_y_pad, exp._grad_mask,
                    exp.parity.x, exp.parity.y, pnr_c=0.0)
        else:
            gx, gy, gmask = aggregation.fused_client_parity_tensors(
                exp._sub_x_pad, exp._sub_y_pad, exp._grad_mask,
                exp.parity.x, exp.parity.y, pnr_c=0.0)
        # past l_max client rows and u parity rows the tensors are zero
        # padding, which the kernel skips
        exp._live_rows = (exp._sub_x_pad.shape[1], exp.parity.x.shape[0])
        return gx, gy, gmask, [1.0]   # the always-active parity pseudo-row

    def extra_consts(self, exp) -> dict:
        consts = {
            "t_star": torch.tensor(exp.t_star, dtype=torch.float32,
                                   device=exp.device),
            "active": torch.from_numpy(
                (exp.loads > 0).astype(np.float32)).to(exp.device),
        }
        if exp.fused_coded:
            consts["live_rows"] = exp._live_rows
            if exp.fused_embed:
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


register(CodedScheme())
register(NaiveScheme())
register(GreedyScheme())
register(IdealScheme())
register(PartialCodedScheme())
