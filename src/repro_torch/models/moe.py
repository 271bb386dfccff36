"""Mixture-of-Experts FFN with GShard/Switch-style capacity dispatch (the
counterpart of ``repro.models.moe``).

Each token picks its top-k experts by router probability (float32 router,
``torch.topk`` sorted: descending values, as ``jax.lax.top_k``); its k
gates are renormalized to sum to 1.  Every expert has a buffer of
``cap = max(int(capacity_factor * N * k / E), 1)`` rows (N tokens); a
token's slot in its expert's buffer is the running count of earlier
(token, choice) pairs routed there, over the flattened N * k pairs,
token-major with the k choices inner.  A pair past the capacity is
dropped: its gate is zeroed and its slot is clamped to cap - 1, so it
reads a row back with weight 0.  Every expert then runs its SwiGLU over
its whole buffer (batched products: the active FLOPs of the reference's
einsums, outside any Pallas kernel there too), the pairs gather their
rows back, and the gated sum over the k choices is the output; shared
experts (DeepSeek) are added after the combine.

Kept slots are unique, so the buffer is filled by index assignment, the
dropped pairs sent to a spare row past the buffer: no atomics, no host
sync, the same bits on every run.

At decode N is the batch, so ``cap`` is 1 for mixtral and deepseek at the
serving batch and most pairs are dropped by design: a decode step is not a
prefill continuation for these families, in the reference as here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


def init_moe(gen, cfg, dtype) -> dict:
    m = cfg.moe
    D, Fe, E = cfg.d_model, (m.d_ff_expert or cfg.d_ff), m.num_experts
    p = {
        "router": dense_init(gen, (D, E), torch.float32, scale=0.02),
        "w1": dense_init(gen, (E, D, Fe), dtype),
        "w3": dense_init(gen, (E, D, Fe), dtype),
        "w2": dense_init(gen, (E, Fe, D), dtype),
    }
    if m.num_shared_experts:
        Fs = Fe * m.num_shared_experts
        p["ws1"] = dense_init(gen, (D, Fs), dtype)
        p["ws3"] = dense_init(gen, (D, Fs), dtype)
        p["ws2"] = dense_init(gen, (Fs, D), dtype)
    return p


def capacity(m, n_tokens: int) -> int:
    """Rows of each expert's buffer for `n_tokens` tokens (a host int)."""
    return max(int(m.capacity_factor * n_tokens * m.top_k / m.num_experts),
               1)


def route(p, xt, m):
    """Router of tokens xt (N, D): (probs (N, E) float32, gates (N, k)
    renormalized, expert indices (N, k) in descending probability)."""
    probs = torch.softmax(xt.float() @ p["router"].float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


def dispatch(gate_idx, E: int, cap: int):
    """(slot (N * k,) in the (E * cap)-row buffer, keep (N * k,) bool) of
    the flattened (token, choice) pairs, token-major."""
    flat = gate_idx.reshape(-1)
    onehot = F.one_hot(flat, E)                               # (N*k, E)
    pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1     # in its expert
    keep = pos < cap
    return flat * cap + pos.clamp(max=cap - 1), keep


def moe_ffn(p, x, cfg):
    """x: (B, S, D) -> (out (B, S, D), aux float32 scalar): the capacity
    dispatch above, and the GShard load-balance value
    E * sum_e(mean prob_e * share of tokens whose first choice is e) *
    aux_loss_weight."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    N = B * S
    xt = x.reshape(N, D)
    probs, gate_vals, gate_idx = route(p, xt, m)
    cap = capacity(m, N)
    slot, keep = dispatch(gate_idx, E, cap)
    gate_vals = gate_vals * keep.reshape(N, k)

    # the kept pairs' rows into their slots; dropped pairs into a spare row
    buf = x.new_zeros((E * cap + 1, D))
    dest = torch.where(keep, slot, E * cap)
    buf.index_copy_(0, dest, xt.repeat_interleave(k, dim=0))
    buf = buf[:E * cap].view(E, cap, D)

    h = F.silu(torch.bmm(buf, p["w1"])) * torch.bmm(buf, p["w3"])
    out_buf = torch.bmm(h, p["w2"]).reshape(E * cap, D)

    gathered = out_buf.index_select(0, slot).reshape(N, k, D)
    out = (gathered * gate_vals[..., None].to(x.dtype)).sum(dim=1)

    if "ws1" in p:
        hs = F.silu(xt @ p["ws1"]) * (xt @ p["ws3"])
        out = out + hs @ p["ws2"]

    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], E).float().mean(dim=0)
    aux = E * (me * ce).sum() * m.aux_loss_weight
    return out.reshape(B, S, D), aux
