"""Sharding policies: map every param / batch / cache leaf to a logical
spec, and a spec to DTensor placements (the counterpart of
``repro.sharding.policy``).

Policies:
  fsdp_tp  — params 2-D sharded: tensor-parallel dim over `model`, FSDP dim
             over `data`; batch over (`pod`, `data`).  Train default.
  tp_only  — params sharded over `model` only (replicated over `data`).
  dp_only  — pure data parallel (small models).
Each takes an optional ``_ep`` suffix that shards MoE experts over `model`
where the expert count divides.  Any other name replicates everything, as
in the reference.

A spec is a tuple with one entry a tensor dim: an axis name, ``None``
(replicated), or a tuple of two or more axis names (the dim split over
all of them, the first major), the entries of the reference's
``PartitionSpec`` as it stores them.  The
rules are the reference's, pure Python over a leaf's name and shape, and
a dim is sharded only where the axis size divides it (`AXIS_SIZE`, the
sizes of the production mesh: ``repro_torch.launch.mesh``).

The port's models hold one tensor a layer where the reference stacks a
stage's layers on a leading axis.  `param_pspecs` and `cache_pspecs` key
their specs by the reference's key paths (``stage0/l0/attn/wq``,
``dec/self/wq``; ``stage0/l0/attn/k``, ``k`` for the enc-dec cache), and a
stacked leaf's spec has the reference's leading ``None``; each of its
per-layer tensors takes the spec without it.  `placements` turns a
per-tensor spec into the placements of a ``DeviceMesh``.
"""
from __future__ import annotations

DATA, MODEL, POD = "data", "model", "pod"
AXIS_SIZE = {DATA: 16, MODEL: 16, POD: 2}


def _div(n: int, axis: str | None) -> bool:
    return axis is not None and n % AXIS_SIZE[axis] == 0


def _prod(axes) -> int:
    n = 1
    for a in axes:
        n *= AXIS_SIZE[a]
    return n


def _spec(*entries) -> tuple:
    """A spec with a one-axis tuple stored as the bare axis, as the
    reference's ``PartitionSpec`` stores it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _rule(name: str, shape: tuple[int, ...], fsdp, tp,
          expert_parallel: bool = False) -> tuple:
    """Spec for one *logical* (unstacked) param leaf."""
    nd = len(shape)
    leaf = name.rsplit("/", 1)[-1]

    def fs(dim):                        # fsdp if divisible
        return fsdp if _div(shape[dim], fsdp) else None

    def mp(dim):                        # tensor-parallel if divisible
        return tp if _div(shape[dim], tp) else None

    # ---------- embeddings / heads: vocab-dim (output) sharding only; an
    # FSDP-sharded contraction dim sharing the batch's axis would make the
    # partitioner replicate the full-batch activations
    if leaf == "embed":
        if _div(shape[0], tp):
            return (tp, None)
        return (None, mp(1))
    if leaf == "lm_head":
        if _div(shape[1], tp):
            return (None, tp)
        return (mp(0), None)
    if leaf in ("patch_proj", "enc_in_proj"):
        return (fs(0), mp(1))

    # ---------- attention (wq/wk/wv (D,H,hd), wo (H,hd,D))
    if leaf in ("wq", "wk", "wv") and nd == 3:
        if _div(shape[1], tp):
            return (fs(0), tp, None)
        return (None, None, None)       # tiny heads: replicate
    if leaf == "wo" and nd == 3:
        if _div(shape[0], tp):
            return (tp, None, fs(2))
        return (None, None, None)

    # ---------- MLA
    if leaf == "w_dkv":
        return (fs(0), None)
    if leaf in ("w_uk", "w_uv"):
        return (None, mp(1), None)

    # ---------- MoE
    if leaf == "router":
        return (fs(0), None)
    if leaf in ("w1", "w3") and nd == 3:        # (E, D, F)
        if expert_parallel and _div(shape[0], tp):
            # experts over `model`, expert-FFN dim over `data`
            return (tp, None, fs(2))
        return (None, fs(1), mp(2))             # TP within each expert
    if leaf == "w2" and nd == 3:                # (E, F, D)
        if expert_parallel and _div(shape[0], tp):
            return (tp, fs(1), None)
        return (None, mp(1), fs(2))
    if leaf in ("ws1", "ws3"):
        return (fs(0), mp(1))
    if leaf == "ws2":
        return (mp(0), fs(1))

    # ---------- dense FFN (w1/w3 (D,F), w2 (F,D)) & generic 2-D matmuls
    if leaf in ("w1", "w3", "wk_ffn") and nd == 2:
        return (fs(0), mp(1))
    if leaf == "w2" and nd == 2:
        return (mp(0), fs(1))

    # ---------- RWKV
    if leaf in ("wr", "wg") and nd == 2:
        return (fs(0), mp(1))
    if leaf == "wv" and nd == 2:                 # rwkv ffn (F, D)
        return (mp(0), fs(1))
    if leaf == "wk" and nd == 2:                 # rwkv (D, D) / ffn (D, F)
        return (fs(0), mp(1))
    if leaf == "wo" and nd == 2:
        return (mp(0), fs(1))
    if leaf == "wA":
        return (fs(0), None)
    if leaf == "wB":
        return (None, mp(1))
    if leaf == "u" and nd == 2:
        return (mp(0), None)

    # ---------- Mamba
    if leaf == "in_proj":
        return (fs(0), mp(1))
    if leaf == "conv_w":
        return (None, mp(1))
    if leaf in ("conv_b", "dt_proj_b", "D"):
        return (mp(0),)
    if leaf == "x_proj":
        return (mp(0), None)
    if leaf == "dt_proj_w":
        return (None, mp(1))
    if leaf == "A_log":
        return (mp(0), None)
    if leaf == "out_proj":
        return (mp(0), fs(1))

    # ---------- norms / scalars / small vectors: replicated
    return (None,) * nd


def _is_stacked(path_s: str) -> bool:
    return path_s.startswith("stage") or path_s.startswith("enc/") \
        or path_s.startswith("dec/")


def param_pspecs(params, policy: str = "fsdp_tp") -> dict:
    """{reference key path: spec} of a port model (a ``Transformer`` or an
    ``EncDec``, on any device, ``meta`` included).  A stacked path's spec
    has the reference's leading ``None`` (its layer axis); each of its
    per-layer tensors takes ``spec[1:]``.

    Policies: fsdp_tp | tp_only | dp_only, each with an optional `_ep`
    suffix that shards MoE experts over `model` instead of tensor-parallel
    within each expert (where num_experts % 16 == 0: deepseek, jamba).
    """
    from repro_torch.carry import _layer_leaves

    ep = policy.endswith("_ep")
    base = policy[:-3] if ep else policy
    fsdp = DATA if base == "fsdp_tp" else None
    tp = MODEL if base in ("fsdp_tp", "tp_only") else None
    out = {}
    for ps, leaf in _layer_leaves(params).items():
        if isinstance(leaf, list):
            out[ps] = (None,) + _rule(ps, tuple(leaf[0].shape), fsdp, tp, ep)
        else:
            out[ps] = _rule(ps, tuple(leaf.shape), fsdp, tp, ep)
    return out


def batch_pspecs(batch: dict, multi_pod: bool) -> dict:
    """{name: spec} of a batch dict: batch dims over (pod, data) where
    they divide; everything else replicated."""
    baxes = (POD, DATA) if multi_pod else (DATA,)

    def spec(leaf):
        if len(leaf.shape) == 0:
            return ()
        b = leaf.shape[0]
        first = baxes if b % _prod(baxes) == 0 else None
        return _spec(first, *((None,) * (len(leaf.shape) - 1)))

    return {name: spec(leaf) for name, leaf in batch.items()}


def _cache_rule(leaf_name: str, logical: tuple, long_context: bool) -> tuple:
    """Spec of one per-layer cache tensor of logical shape `logical`,
    with the reference's leading ``None`` of the stacked layer axis."""
    seq_axes = (DATA, MODEL) if long_context else (MODEL,)
    nd = len(logical)
    if leaf_name == "pos":
        return (None,) * (nd + 1)
    batch = logical[0] if nd else 1
    b_axis = DATA if (not long_context and batch % AXIS_SIZE[DATA] == 0) \
        else None
    if leaf_name in ("k", "v", "xk", "xv"):          # (B, S, K, hd)
        seq = logical[1]
        s_ax = seq_axes if all(seq % AXIS_SIZE[a] == 0 for a in seq_axes) \
            and _prod(seq_axes) <= seq else None
        if s_ax is None and seq % AXIS_SIZE[MODEL] == 0:
            s_ax = (MODEL,)
        heads = logical[2]
        h_ax = MODEL if (s_ax is None and heads % AXIS_SIZE[MODEL] == 0) \
            else None
        return _spec(None, b_axis, s_ax, h_ax, None)
    if leaf_name in ("c", "kpe"):                    # MLA latent (B,S,r)
        seq = logical[1]
        s_ax = seq_axes if all(seq % AXIS_SIZE[a] == 0 for a in seq_axes) \
            else ((MODEL,) if seq % AXIS_SIZE[MODEL] == 0 else None)
        return _spec(None, b_axis, s_ax, None)
    if leaf_name == "wkv":                           # (B, H, hs, hs)
        h_ax = MODEL if logical[1] % AXIS_SIZE[MODEL] == 0 else None
        return (None, b_axis, h_ax, None, None)
    if leaf_name in ("x_prev_mix", "x_prev_ffn"):    # (B, D)
        d_ax = MODEL if logical[1] % AXIS_SIZE[MODEL] == 0 else None
        return (None, b_axis, d_ax)
    if leaf_name == "conv":                          # (B, K-1, din)
        d_ax = MODEL if logical[2] % AXIS_SIZE[MODEL] == 0 else None
        return (None, b_axis, None, d_ax)
    if leaf_name == "h":                             # (B, din, N)
        d_ax = MODEL if logical[1] % AXIS_SIZE[MODEL] == 0 else None
        return (None, b_axis, d_ax, None)
    return (None,) * (nd + 1)


def cache_pspecs(cache, long_context: bool, multi_pod: bool, cfg) -> dict:
    """{reference key path: spec} of a port cache for decode: a list with
    one dict a layer (``Model.init_cache`` / ``abstract_cache``) of the
    model of `cfg`, which places the layers in the reference's stages.

    decode_32k: batch over `data`, cache seq over `model`.
    long_500k (batch=1): cache seq over (`data`,`model`); states over
    `model`.  The stacked-layer axis (the specs' leading ``None``) is
    replicated.  `multi_pod` changes no cache spec, as in the
    reference."""
    from repro_torch.carry import _cache_leaves

    return {ps: _cache_rule(ps.rsplit("/", 1)[-1], tuple(ts[0].shape),
                            long_context)
            for ps, ts in _cache_leaves(cache, cfg).items()}


def param_shards(params, policy: str = "fsdp_tp") -> list:
    """[(reference key path, one device's local shape, dtype)] of every
    tensor of a port model under `policy` on the production mesh: one
    entry a layer for a stacked path, with its per-layer spec."""
    from repro_torch.carry import _layer_leaves

    specs = param_pspecs(params, policy)
    out = []
    for ps, leaf in _layer_leaves(params).items():
        spec = specs[ps]
        for t, s in ([(t, spec[1:]) for t in leaf] if isinstance(leaf, list)
                     else [(leaf, spec)]):
            out.append((ps, local_shape(tuple(t.shape), s), t.dtype))
    return out


def placements(spec: tuple, mesh) -> list:
    """DTensor placements on `mesh` (a ``DeviceMesh`` with dim names) of
    one per-tensor spec: ``Shard(d)`` on the mesh dim of each axis that
    splits tensor dim d, ``Replicate()`` on the others.  A dim split over
    a tuple of axes takes them in mesh order, the first the major one, as
    the reference's ``PartitionSpec`` lays out its blocks; a tuple against
    the mesh's order, an axis the mesh lacks or an axis used twice
    raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    used = set()
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        dims = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: axis {a!r} is not one of "
                                 f"the mesh's {names}")
            m = names.index(a)
            if m in used:
                raise ValueError(f"spec {spec}: axis {a!r} used twice")
            used.add(m)
            dims.append(m)
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {names}")
        for m in dims:
            out[m] = Shard(d)
    return out


def local_shape(shape, spec: tuple) -> tuple:
    """The shape of one device's block of a tensor of `shape` under
    `spec` on the production mesh (every sharded dim divides)."""
    out = []
    for d, n in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is not None:
            n //= _prod(ax if isinstance(ax, tuple) else (ax,))
        out.append(n)
    return tuple(out)
