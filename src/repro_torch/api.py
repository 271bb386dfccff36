"""Declarative experiment API of the port (see ``repro.api``).

    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.config import FLConfig, TrainConfig

    spec = ExperimentSpec(fl=FLConfig(n_clients=12, delta=0.2),
                          train=TrainConfig(learning_rate=0.5),
                          scheme="coded")
    result = build_experiment(spec, xs, ys).run(100)     # on the GPU

A spec the reference wrote (``repro.config.ExperimentSpec.to_dict()``)
builds here unchanged.  A hier-active spec (``hier_shards > 1`` or
``sample_fraction < 1.0``) builds a `repro_torch.hier.HierExperiment`,
which may stream its clients through ``data_fn(lo, hi)``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.config import ExperimentSpec
from repro_torch.core import schemes
from repro_torch.core.fed_runtime import (Experiment, FedResult,  # noqa: F401
                                          MultiFedResult, RoundLog,
                                          RunHealth)
from repro_torch.core.run_state import RunState  # noqa: F401
from repro_torch.core.schemes import (Scheme, get_scheme,  # noqa: F401
                                      grid_names, register,
                                      registered_names)
from repro_torch.faults import (FAULT_PROFILES, FaultProfile,  # noqa: F401
                                get_fault_profile)
from repro_torch.net.channel import (CHANNEL_PROFILES,  # noqa: F401
                                     ChannelProfile)
from repro_torch.obs import (Attribution, RunJournal,  # noqa: F401
                             histories_equal, history_from_journal,
                             load_events)
from repro_torch.obs import spans as obs_spans  # noqa: F401

__all__ = [
    "ExperimentSpec", "Experiment", "ExperimentService", "FedResult",
    "MultiFedResult", "RoundLog", "RunHealth", "RunState", "Scheme",
    "build_experiment", "get_scheme", "grid_names", "register",
    "registered_names", "CHANNEL_PROFILES", "ChannelProfile",
    "FAULT_PROFILES", "FaultProfile", "get_fault_profile",
    "Attribution", "RunJournal", "load_events", "history_from_journal",
    "histories_equal", "obs_spans",
]


def __getattr__(name):
    # lazy: launch.service imports build_experiment from here, so a
    # top-level import would be circular
    if name == "ExperimentService":
        from repro_torch.launch.service import ExperimentService
        return ExperimentService
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def build_experiment(spec: "ExperimentSpec | dict", x_stack=None,
                     y_stack=None, *,
                     nodes: Optional[list] = None,
                     rng: Optional[np.random.Generator] = None,
                     device=None, parity_generators=None,
                     rff_draw=None, secure_masks=None, mesh=None,
                     data_fn=None):
    """Build a runnable `Experiment` (or `HierExperiment`) from a spec and
    client data.

    spec: an `ExperimentSpec` (or its `to_dict()` form, revived here);
    x_stack: (n, l, q) RFF-embedded client features, or (n, l, d) RAW ones
    with ``spec.fused_embed``; y_stack: (n, l, c) targets, as NumPy arrays
    or tensors.  `nodes` / `rng` override the
    delay network and the host RNG (both default to the spec's seeds).
    `device` defaults to the GPU ("cuda"); "cpu" runs the plain versions
    of the kernels.  `parity_generators` (n, u, l) replaces the coded
    family's generator draw — ``repro_torch.carry`` turns the reference's
    key chain into one.  `rff_draw` = (omega (d, q), delta (q,)) replaces
    the fused_embed path's own draw from ``spec.rff`` — e.g. the output of
    ``repro_torch.carry.rff_from_reference`` — and is refused otherwise.
    `secure_masks` = (x masks (P, u, q), y masks (P, u, c)), one a client
    pair, replaces the secure-aggregation setup's own mask draws —
    ``repro_torch.carry.secure_masks_from_reference`` — and is refused
    without ``spec.secure_aggregation``.  `mesh` overrides ``spec.mesh``:
    a rank count or a `repro_torch.launch.mesh.ClientMesh` (a mesh object
    is no spec field), sharding the client axis over the first k ranks of
    the process group, one all-reduce a round; every rank of the group
    calls this with the same arguments, and a rank past the first k is
    refused with a ``ValueError`` naming it.

    Specs with ``hier_shards > 1`` or ``sample_fraction < 1.0`` build a
    `repro_torch.hier.HierExperiment` instead (edge-aggregator shards,
    sampled cohorts with coded compensation); those may stream client
    blocks via ``data_fn(lo, hi) -> (x, y)`` in place of dense stacks, and
    their `parity_generators` is a list of per-shard (n_s, u_s, l) stacks
    (``repro_torch.carry.hier_generators_from_reference``).  The identity
    configuration (``hier_shards=1, sample_fraction=1.0``) always takes
    the flat engine.
    """
    if isinstance(spec, dict):
        spec = ExperimentSpec.from_dict(spec)
    # validate the scheme against the live registry up front
    schemes.get_scheme(spec.resolved_scheme)
    if spec.hier_active:
        from repro_torch.hier import HierExperiment
        if nodes is not None or mesh is not None:
            raise ValueError(
                "the hierarchical tier builds its delay population from "
                "the spec (repro_torch.hier.population_delay_arrays) and "
                "shards clients over edge aggregators; nodes/mesh "
                "overrides are not supported with hier_shards > 1 or "
                "sample_fraction < 1.0")
        if rff_draw is not None or secure_masks is not None:
            raise ValueError(
                "rff_draw and secure_masks replace draws of fused_embed "
                "and secure aggregation, which the hierarchical tier does "
                "not run")
        return HierExperiment(spec, x_stack, y_stack, data_fn=data_fn,
                              rng=rng, device=device,
                              parity_generators=parity_generators)
    if data_fn is not None:
        raise ValueError(
            "data_fn streaming is only supported by the hierarchical tier "
            "(hier_shards > 1 or sample_fraction < 1.0); the flat engine "
            "takes dense x_stack/y_stack")
    return Experiment(spec, x_stack, y_stack, nodes=nodes, rng=rng,
                      device=device, parity_generators=parity_generators,
                      rff_draw=rff_draw, secure_masks=secure_masks,
                      mesh=mesh)
