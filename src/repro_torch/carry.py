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
    ``repro_torch.launch.serve.serve(..., params=...)``.

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
    """The reference's param pytree (NumPy arrays) as a port `Transformer`
    on `device`, in the config's dtype.

    The reference stacks the layers of its one dense stage on a leading
    axis (``params["stage0"]["l0"][...]`` of shape (n_layers, ...)); this
    unstacks them into the port's layers.  Layouts are kept: wq (D, H, hd),
    wk/wv (D, K, hd), wo (H, hd, D), w1/w3 (D, F), w2 (F, D), embed (V, D),
    lm_head (D, V)."""
    from repro_torch.models import transformer
    from repro_torch.models.common import dtype_of

    transformer.check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg)
    stage = params_np["stage0"]["l0"]

    def w(arr):
        return _weight(arr, dtype, dev)

    layers = []
    for i in range(cfg.n_layers):
        attn = {name: w(a[i]) for name, a in stage["attn"].items()}
        ffn = {name: w(stage["ffn"][name][i]) for name in ("w1", "w3", "w2")}
        layers.append(transformer.DenseLayer(w(stage["ln1"][i]),
                                             w(stage["ln2"][i]), attn, ffn))
    lm_head = None if cfg.tie_embeddings else w(params_np["lm_head"])
    return transformer.Transformer(cfg, w(params_np["embed"]),
                                   w(params_np["final_norm"]), lm_head,
                                   layers)
