"""Plain reference of the CodedFedL deployment that the benchmark drives.

It recomputes, from the inputs the benchmark made (raw client points,
labels, Omega and delta, the parity generators and the host seed), what
the program derives from them: the delay network, the deadline t* and the
loads (frozen copies of the allocation and of the delay sampler), the
processed subsets, the RFF embedding, the parity set, every round's
returned set and simulated round time, and the model's trajectory under
the masked gradient and the update.  Plain PyTorch in float32 with TF32
off, or NumPy; it imports nothing of the program.

With ``control=True`` every matrix product rounds its operands to TF32
(10 explicit mantissa bits) first: the step below float32 that would tempt
a later change, which the benchmark's comparison has to catch.
"""
from __future__ import annotations

import math
import types

import numpy as np
import torch

from portbench.reference import delay_model as dm
from portbench.reference import load_allocation as la

#: the program's divergence guard: a non-finite iterate is not committed
#: and the learning rate halves
LR_BACKOFF = 0.5
#: rows a block of the embedding and of the parity encode
ROW_BLOCK = 8192


def fp32_only() -> None:
    """Matrix products in float32 on the card, as the configuration
    states (PyTorch would otherwise be free to use TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """`t` (float32) rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero), kept in float32."""
    bits = t.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, control: bool) -> torch.Tensor:
    if control:
        a, b = to_tf32(a), to_tf32(b)
    return torch.matmul(a, b)


def network(cfg: dict, n: int) -> types.SimpleNamespace:
    """The configuration's MEC network parameters with its client count."""
    return types.SimpleNamespace(n_clients=n, **cfg["network"])


def nodes_unscaled(cfg: dict, n: int) -> list:
    """The paper's network (tau per bit), as the paper's data split sees
    it."""
    return dm.mec_network(network(cfg, n),
                          d_scalars_per_point=cfg["q"] * cfg["c"])


def nodes_scaled(cfg: dict, n: int) -> list:
    """The network with tau scaled to the model / gradient packet."""
    net = network(cfg, n)
    payload = dm.packet_bits(net, cfg["q"] * cfg["c"])
    return [dm.scale_tau(nd, payload) for nd in nodes_unscaled(cfg, n)]


def embed(x: torch.Tensor, omega: torch.Tensor, delta: torch.Tensor,
          control: bool = False) -> torch.Tensor:
    """phi(X) = sqrt(2/q) cos(X Omega + delta): (..., d) -> (..., q), in
    blocks of rows."""
    lead, d = x.shape[:-1], x.shape[-1]
    q = omega.shape[1]
    flat = x.reshape(-1, d)
    out = torch.empty((flat.shape[0], q), dtype=torch.float32,
                      device=x.device)
    scale = math.sqrt(2.0 / q)
    for lo in range(0, flat.shape[0], ROW_BLOCK):
        hi = lo + ROW_BLOCK
        out[lo:hi] = scale * torch.cos(
            matmul(flat[lo:hi], omega, control) + delta)
    return out.reshape(*lead, q)


def learning_rate(phi: torch.Tensor, target: float, iters: int) -> float:
    """target / lambda_max(Phi^T Phi / m) by power iteration from the
    start vector of ``rff.suggest_lr`` (``default_rng(0)``)."""
    m, q = phi.shape
    v0 = np.random.default_rng(0).normal(size=(q,))
    v = torch.from_numpy(v0 / np.linalg.norm(v0)).to(phi.device,
                                                      torch.float32)
    lam = 1.0
    for _ in range(iters):
        w = (phi.t() @ (phi @ v)) / m
        lam = float(torch.linalg.vector_norm(w))
        v = w / max(lam, 1e-12)
    return target / max(lam, 1e-12)


def allocate(nodes: list, n: int, l: int, m: int, u: int, device):
    """t* and the real-valued loads, by the solver the program's
    ``alloc_backend="auto"`` picks: the vectorized one at n >= 64."""
    caps = [float(l)] * n
    if n >= 64 and la.vectorized_grid_width(nodes) <= 4096:
        return la.two_step_allocate_vectorized(
            nodes, caps, server=None, u_max=float(u), m=float(m),
            device=device)
    return la.two_step_allocate(nodes, caps, server=None, u_max=float(u),
                                m=float(m))


class Deployment:
    """What set-up derives from the inputs, recomputed.

    `inp` carries x (n, l, d), y (n, l, c), omega, delta, gens (n, u, l)
    or None, host_seed and lr.  ``rng`` is left where the program's host
    generator is after its set-up, ready for the runs' delay draws.
    """

    def __init__(self, cfg: dict, traffic: dict, inp, *,
                 control: bool = False):
        self.cfg, self.control = cfg, control
        self.scheme = traffic["scheme"]
        self.R = int(traffic["realizations"])
        self.K = int(traffic["block_rounds"])
        self.rounds = int(cfg["rounds"])
        n, l, _ = inp.x.shape
        self.n, self.l, self.q, self.c = n, l, cfg["q"], cfg["c"]
        self.m = n * l
        self.lr = inp.lr
        self.device = inp.x.device
        self.nodes = nodes_scaled(cfg, n)
        self.rng = np.random.default_rng(inp.host_seed)
        self.phi = embed(inp.x, inp.omega, inp.delta, control)  # (n, l, q)
        self.y = inp.y
        if self.scheme == "coded":
            self._coded_setup(inp)
        elif self.scheme == "naive":
            self.t_star = None
            self.u = 0
            self.loads = np.full(n, l, dtype=np.int64)
            self.processed = np.ones((n, l), dtype=bool)
            self.setup_time = 0.0
            self.parity_x = self.parity_y = None
        else:
            raise ValueError(f"the reference has no scheme {self.scheme!r}")
        self.row_w = torch.from_numpy(self.processed.astype(np.float32)).to(
            self.device)

    def _coded_setup(self, inp) -> None:
        n, l, m = self.n, self.l, self.m
        net = network(self.cfg, n)
        self.u = u = max(1, int(round(self.cfg["delta"] * m)))
        alloc = allocate(self.nodes, n, l, m, u, self.device)
        self.t_star = alloc.t_star
        self.loads = np.minimum(np.floor(alloc.loads).astype(int), l)
        p_return = np.array([
            nd.cdf(self.t_star, float(ld)) if ld > 0 else 0.0
            for nd, ld in zip(self.nodes, self.loads)])
        perm = self.rng.permuted(np.tile(np.arange(l), (n, 1)), axis=1)
        take = np.arange(l)[None, :] < self.loads[:, None]
        processed = np.zeros((n, l), dtype=bool)
        rows = np.broadcast_to(np.arange(n)[:, None], (n, l))
        processed[rows[take], perm[take]] = True
        self.processed = processed
        w = np.where(processed, np.sqrt(1.0 - p_return)[:, None],
                     1.0).astype(np.float32)
        w = torch.from_numpy(w).to(self.device)
        # global parity set: sum_j G_j W_j (Phi_j, Y_j), clients in blocks
        px = torch.zeros((u, self.q), dtype=torch.float32, device=self.device)
        py = torch.zeros((u, self.c), dtype=torch.float32, device=self.device)
        step = max(1, ROW_BLOCK // max(u, 1) * 4)
        for lo in range(0, n, step):
            hi = min(n, lo + step)
            gw = inp.gens[lo:hi] * w[lo:hi, None, :]
            px += matmul(gw, self.phi[lo:hi], self.control).sum(0)
            py += matmul(gw, self.y[lo:hi], self.control).sum(0)
        self.parity_x, self.parity_y = px, py
        bits = dm.packet_bits(net, u * (self.q + self.c))
        unit = dm.packet_bits(net, self.q * self.c)
        self.setup_time = max(nd.tau / unit * bits / (1.0 - nd.p)
                              for nd in self.nodes)

    # ------------------------------------------------------------ the rounds
    def lr_schedule(self) -> np.ndarray:
        """(rounds,) float32 learning rates, decayed at the configured
        rounds."""
        out = []
        for r in range(self.rounds):
            lr = self.lr
            for e in self.cfg["lr_decay_rounds"]:
                if r >= e:
                    lr *= self.cfg["lr_decay"]
            out.append(lr)
        return np.array(out, np.float32)

    def block_delays(self, k: int) -> np.ndarray:
        """The next block's (R, k, n) float32 delays from the host stream,
        one draw of R * k rows as the program takes them."""
        t = dm.sample_round_times(self.nodes, np.asarray(self.loads, float),
                                  self.rng, self.R * k)
        return t.astype(np.float32).reshape(self.R, k, self.n)

    def round_outcome(self, t: np.ndarray):
        """(t_round float32, n_ret, returned mask) of delays t (..., n)."""
        if self.scheme == "coded":
            t_star = np.float32(self.t_star)
            by_deadline = t <= t_star
            t_round = np.broadcast_to(t_star, t.shape[:-1])
            return t_round, by_deadline.sum(-1), by_deadline & (
                self.loads > 0)
        return t.max(-1), np.full(t.shape[:-1], self.n), np.ones_like(
            t, dtype=bool)

    def run_blocks(self):
        """One run's blocks: [(R, k, n) float32 delays], drawn in turn."""
        out, done = [], 0
        while done < self.rounds:
            k = min(self.K, self.rounds - done)
            out.append(self.block_delays(k))
            done += k
        return out

    def trajectory(self, blocks: list) -> list:
        """theta (R, q, c) at the end of each block of a run that starts
        from 0 and meets the delays `blocks`."""
        R, n, l, q, c = self.R, self.n, self.l, self.q, self.c
        phi = self.phi.reshape(n * l, q)
        y = self.y.reshape(n * l, c)
        theta = torch.zeros((R, q, c), dtype=torch.float32,
                            device=self.device)
        lr_scale = torch.ones((R, 1, 1), dtype=torch.float32,
                              device=self.device)
        lrs = self.lr_schedule()
        m, l2 = float(self.m), float(self.cfg["l2_reg"])
        inv_u = np.float32(1.0 / self.u) if self.u else None
        out, r = [], 0
        for delays in blocks:
            for k in range(delays.shape[1]):
                _, _, ret = self.round_outcome(delays[:, k])
                ret = torch.from_numpy(ret.astype(np.float32)).to(
                    self.device)                                  # (R, n)
                w = (self.row_w[None] * ret[:, :, None]).reshape(R, n * l)
                g = self._masked_grad(phi, y, theta, w)
                if self.parity_x is not None:
                    ones = torch.full((R, self.u), float(inv_u),
                                      device=self.device)
                    g = g + self._masked_grad(self.parity_x, self.parity_y,
                                              theta, ones)
                lr = torch.tensor(lrs[r], device=self.device)
                upd = theta - (lr * lr_scale) * (g / m + l2 * theta)
                ok = torch.isfinite(upd).flatten(1).all(1)[:, None, None]
                theta = torch.where(ok, upd, theta)
                lr_scale = torch.where(ok, lr_scale, lr_scale * LR_BACKOFF)
                r += 1
            out.append(theta)
        return out

    def _masked_grad(self, x, y, theta, w):
        """sum over rows of w_r x^T (x theta_r - y) for each realization:
        x (N, q), y (N, c), theta (R, q, c), w (R, N) -> (R, q, c)."""
        R, q, c = theta.shape
        th = theta.permute(1, 0, 2).reshape(q, R * c)
        res = matmul(x, th, self.control).reshape(-1, R, c) - y[:, None, :]
        res = res * w.t()[:, :, None]
        g = matmul(x.t(), res.reshape(-1, R * c), self.control)
        return g.reshape(q, R, c).permute(1, 0, 2)

    def wall_clock(self, blocks: list) -> np.ndarray:
        """(R, rounds) simulated wall clock of a run: set-up upload, then
        the cumulative round times."""
        t_round = np.concatenate(
            [self.round_outcome(b)[0] for b in blocks], axis=1)
        return self.setup_time + np.cumsum(t_round.astype(np.float64),
                                           axis=1)

    def returned(self, blocks: list) -> np.ndarray:
        """(R, rounds) returned counts of a run."""
        return np.concatenate([self.round_outcome(b)[1] for b in blocks],
                              axis=1)

    def counted_rows(self, blocks: list) -> np.ndarray:
        """(R, rounds) rows whose gradient the round needs: the returned
        clients' processed points, and the parity rows."""
        return np.concatenate(
            [self.round_outcome(b)[2] @ self.loads + self.u for b in blocks],
            axis=1)
