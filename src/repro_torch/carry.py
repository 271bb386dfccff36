"""Carry the reference's random state over into the port.

The reference draws its random numbers with ``jax.random`` (threefry), the
port with ``torch.Generator``s: the same seed gives different numbers.  To
make both packages compute the same thing, a caller draws with the
reference, hands the draws over as NumPy arrays, and these functions turn
them into the port's tensors:

  * `rff_from_reference`: (Omega, delta) of ``repro.core.rff.rff_params``,
    for ``rff_transform`` or for ``build_experiment(..., rff_draw=...)``
    (the fused_embed path, where the reference's ``Experiment`` draws them
    from ``spec.rff`` itself);
  * `generators_from_reference`: the (n, u, l) stack of generator matrices
    that ``repro.core.schemes.CodedScheme.setup`` draws from its key chain
    (``PRNGKey(fl.seed + 99)``, split client after client), for
    ``build_experiment(..., parity_generators=...)``;
  * `hier_generators_from_reference`: the per-shard (n_s, u_s, l) stacks
    that ``repro.hier.topology.HierExperiment`` draws for its shards
    (``fold_in(PRNGKey(fl.seed + 99), s)``, then a split chain an encode
    block), for ``build_experiment(hier_spec, ..., parity_generators=...)``;
  * `secure_masks_from_reference`: the pairwise masks of
    ``repro.core.secure_agg`` (``_mask_like(_pair_key(PRNGKey(fl.seed +
    1234), i, j), parity, 1.0)``, one a client pair), for
    ``build_experiment(..., secure_masks=...)``;
  * `theta_from_reference`: a (q, c) model iterate;
  * `model_params_from_reference`: the model zoo's weights (the param
    pytree of ``repro.models.model_zoo.build(cfg).init_params``), for
    ``repro_torch.launch.serve.serve(..., params=...)`` and
    ``repro_torch.launch.train.train(..., params=...)``;
  * `model_params_to_reference`, its inverse: a port model as the
    reference's pytree (layers stacked again), NumPy arrays, and
    `reference_layout`, that tree's key paths and shapes without reading
    a weight (``repro_torch.checkpoint.io`` writes and checks the
    reference's param-tree files with them);
  * `cache_layout`: the key paths, shapes and dtypes of the reference's
    cache tree of a port cache (the compile driver's abstract cache).

This module imports neither ``jax`` nor ``repro``: the caller does the
drawing.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _tensor(arr, ndim: int, what: str, device) -> torch.Tensor:
    a = np.array(arr, dtype=np.float32, copy=True)
    if a.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim} dimensions, "
                         f"got shape {a.shape}")
    return torch.from_numpy(a).to(resolve_device(device))


def rff_from_reference(omega, delta, device=None):
    """(Omega (d, q), delta (q,)) as float32 tensors on `device`."""
    om = _tensor(omega, 2, "omega", device)
    de = _tensor(delta, 1, "delta", device)
    if de.shape[0] != om.shape[1]:
        raise ValueError(f"delta has {de.shape[0]} entries, omega "
                         f"{om.shape[1]} columns")
    return om, de


def generators_from_reference(g_stack, device=None) -> torch.Tensor:
    """The (n, u, l) generator stack as a float32 tensor on `device`."""
    return _tensor(g_stack, 3, "generator stack", device)


def hier_generators_from_reference(stacks, device=None) -> list:
    """The per-shard (n_s, u_s, l) generator stacks of the hierarchical
    tier, in shard order, as float32 tensors on `device`."""
    return [_tensor(g, 3, f"generator stack of shard {s}", device)
            for s, g in enumerate(stacks)]


def secure_masks_from_reference(mask_x, mask_y, device=None):
    """The pairwise secure-aggregation masks as float32 tensors on
    `device`: mask_x (P, u, q) and mask_y (P, u, c), one row a client pair
    (lo, hi), lo < hi, in lexicographic order
    (``repro_torch.core.secure_agg.pairs``)."""
    mx = _tensor(mask_x, 3, "secure masks (x)", device)
    my = _tensor(mask_y, 3, "secure masks (y)", device)
    if mx.shape[:2] != my.shape[:2]:
        raise ValueError(f"x masks {tuple(mx.shape)} and y masks "
                         f"{tuple(my.shape)} disagree in pairs or rows")
    return mx, my


def theta_from_reference(theta, device=None) -> torch.Tensor:
    """A (q, c) model iterate as a float32 tensor on `device`."""
    return _tensor(theta, 2, "theta", device)


def _weight(arr, dtype, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":       # ml_dtypes: hand the bits over
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def model_params_from_reference(params_np, cfg, device=None):
    """The reference's param pytree (NumPy arrays) as a port model on
    `device`: a `Transformer`, or an `EncDec` where ``cfg.is_encdec``.

    The reference stacks the layers of each stage's pattern position on a
    leading axis (``params["stage0"]["l0"]["attn"]["wq"]`` of shape
    (count, D, H, hd)); this unstacks them into the port's layers, in the
    order they run (stage by stage; within a stage, repeat by repeat, the
    pattern's layers in turn: jamba's superblocks ``l0..l7``).  The
    enc-dec tree's ``enc`` and ``dec`` stacks become its encoder and
    decoder layers.  Layouts are kept, and each leaf takes its dtype in
    the model (``transformer.leaf_dtype``: the config's, float32 for the
    MoE router and the recurrent mixers' float32 leaves), whatever dtype
    the array has (a checkpoint holds bf16 weights as float32)."""
    from repro_torch.models import encdec, transformer
    from repro_torch.models.common import dtype_of

    dev = resolve_device(device)
    dtype = dtype_of(cfg)

    def w(arr):
        return _weight(arr, dtype, dev)

    def group(node, key, i):
        return {name: _weight(a[i], transformer.leaf_dtype(cfg, key, name),
                              dev) for name, a in node[key].items()}

    if cfg.is_encdec:
        enc, dec = params_np["enc"], params_np["dec"]
        enc_layers = [encdec.EncLayer(w(enc["ln1"][i]), w(enc["ln2"][i]),
                                      group(enc, "attn", i),
                                      group(enc, "ffn", i))
                      for i in range(cfg.n_encoder_layers)]
        dec_layers = [encdec.DecLayer(w(dec["ln1"][i]), w(dec["ln_x"][i]),
                                      w(dec["ln2"][i]), group(dec, "self", i),
                                      group(dec, "cross", i),
                                      group(dec, "ffn", i))
                      for i in range(cfg.n_layers)]
        return encdec.EncDec(cfg, w(params_np["embed"]),
                             w(params_np["enc_in_proj"]),
                             w(params_np["enc_norm"]),
                             w(params_np["dec_norm"]),
                             w(params_np["lm_head"]), enc_layers, dec_layers)
    layers = []
    for si, (pattern, count) in enumerate(transformer.stages(cfg)):
        stage = params_np[f"stage{si}"]
        for c in range(count):
            for i, spec in enumerate(pattern):
                node = stage[f"l{i}"]
                layers.append(transformer.Layer(
                    spec, w(node["ln1"][c]), w(node["ln2"][c]),
                    group(node, spec[0], c),
                    group(node, transformer.FFN_KEYS[spec[1]], c)))
    lm_head = None if cfg.tie_embeddings else w(params_np["lm_head"])
    patch_proj = (w(params_np["patch_proj"]) if cfg.n_prefix_patches
                  else None)
    return transformer.Transformer(cfg, w(params_np["embed"]),
                                   w(params_np["final_norm"]), lm_head,
                                   layers, patch_proj)


def _stacked(prefix: str, layers) -> dict:
    """{key path: the tensors it stacks, one a layer} of layers that share
    one place in the reference's tree: each weight group's leaves in key
    order, then the norms."""
    first = layers[0]
    out = {}
    for key, group in first.groups.items():
        for name in sorted(group):
            out[f"{prefix}{key}/{name}"] = [layer.groups[key][name]
                                            for layer in layers]
    for norm in first.norms:
        out[prefix + norm] = [getattr(layer, norm) for layer in layers]
    return out


def _layer_leaves(params) -> dict:
    """{reference key path: the tensors it stacks (one a layer) or the one
    tensor it holds}, in the reference's tree order."""
    from repro_torch.models import transformer

    cfg = params.cfg
    if cfg.is_encdec:
        out = {name: getattr(params, name) for name in (
            "embed", "enc_in_proj", "enc_norm", "dec_norm", "lm_head")}
        out.update(_stacked("enc/", list(params.enc)))
        out.update(_stacked("dec/", list(params.dec)))
        return out
    out = {"embed": params.embed, "final_norm": params.final_norm}
    if params.lm_head is not None:
        out["lm_head"] = params.lm_head
    if params.patch_proj is not None:
        out["patch_proj"] = params.patch_proj
    first = 0
    for si, (pattern, count) in enumerate(transformer.stages(cfg)):
        n = len(pattern)
        for i in range(n):
            out.update(_stacked(f"stage{si}/l{i}/", [
                params.layers[first + c * n + i] for c in range(count)]))
        first += n * count
    return out


def reference_layout(params) -> dict:
    """{key path of the reference's tree: (shape, torch dtype)} of a port
    model (also one on the ``meta`` device); stacked layers have the layer
    axis first."""
    out = {}
    for key, leaf in _layer_leaves(params).items():
        if isinstance(leaf, list):
            out[key] = ((len(leaf),) + tuple(leaf[0].shape), leaf[0].dtype)
        else:
            out[key] = (tuple(leaf.shape), leaf.dtype)
    return out


def _cache_leaves(cache, cfg) -> dict:
    """{reference key path: the tensors it stacks, one a layer} of a port
    cache (a list with one dict a layer) of the model of `cfg`, in the
    reference's tree order: ``stage{si}/l{i}/{attn|mla|rwkv|mamba}/<leaf>``
    for a decoder stack, ``k``, ``v``, ``pos``, ``xk``, ``xv`` for the
    enc-dec one."""
    from repro_torch.models import transformer

    if cfg.is_encdec:
        return {name: [c[name] for c in cache] for name in cache[0]}
    out = {}
    first = 0
    for si, (pattern, count) in enumerate(transformer.stages(cfg)):
        n = len(pattern)
        for i, (mixer, _) in enumerate(pattern):
            layers = [cache[first + c * n + i] for c in range(count)]
            for name in layers[0]:
                out[f"stage{si}/l{i}/{mixer}/{name}"] = [
                    c[name] for c in layers]
        first += n * count
    return out


def cache_layout(cache, cfg) -> dict:
    """{key path of the reference's cache tree: (shape, torch dtype)} of a
    port cache (also one on the ``meta`` device, ``Model.abstract_cache``):
    the cache's counterpart of `reference_layout`, the layer axis first."""
    return {key: ((len(ts),) + tuple(ts[0].shape), ts[0].dtype)
            for key, ts in _cache_leaves(cache, cfg).items()}


def _host(t) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:          # exact in float32
        t = t.float()
    return t.cpu().numpy()


def model_params_to_reference(params) -> dict:
    """The inverse of `model_params_from_reference`: the reference's param
    pytree of a port model as nested dicts of NumPy arrays, the layers
    stacked on a leading axis (``tree["stage0"]["l0"]["attn"]["wq"]`` of
    shape (count, D, H, hd); ``tree["dec"]["self"]["wq"]`` for enc-dec).
    bfloat16 weights come out as float32 (exact); the reference casts them
    back with ``astype``; float32 leaves of a bf16 model stay float32."""
    tree: dict = {}
    for key, leaf in _layer_leaves(params).items():
        arr = (np.stack([_host(t) for t in leaf]) if isinstance(leaf, list)
               else _host(leaf))
        *parents, last = key.split("/")
        node = tree
        for name in parents:
            node = node.setdefault(name, {})
        node[last] = arr
    return tree
