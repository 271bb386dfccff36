"""Declarative experiment API of the port (see ``repro.api``).

    from repro_torch.api import ExperimentSpec, build_experiment
    from repro_torch.config import FLConfig, TrainConfig

    spec = ExperimentSpec(fl=FLConfig(n_clients=12, delta=0.2),
                          train=TrainConfig(learning_rate=0.5),
                          scheme="coded")
    result = build_experiment(spec, xs, ys).run(100)     # on the GPU

A spec the reference wrote (``repro.config.ExperimentSpec.to_dict()``)
builds here unchanged.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.config import ExperimentSpec, unsupported_features
from repro_torch.core import schemes
from repro_torch.core.fed_runtime import (Experiment, FedResult,  # noqa: F401
                                          RoundLog, RunHealth)
from repro_torch.core.schemes import (Scheme, get_scheme,  # noqa: F401
                                      register, registered_names)

__all__ = [
    "ExperimentSpec", "Experiment", "FedResult", "RoundLog", "RunHealth",
    "Scheme", "build_experiment", "get_scheme", "register",
    "registered_names",
]

def build_experiment(spec: "ExperimentSpec | dict", x_stack, y_stack, *,
                     nodes: Optional[list] = None,
                     rng: Optional[np.random.Generator] = None,
                     device=None, parity_generators=None) -> Experiment:
    """Build a runnable `Experiment` from a spec and client data.

    spec: an `ExperimentSpec` (or its `to_dict()` form, revived here);
    x_stack: (n, l, q) RFF-embedded client features; y_stack: (n, l, c)
    targets, as NumPy arrays or tensors.  `nodes` / `rng` override the
    delay network and the host RNG (both default to the spec's seeds).
    `device` defaults to the GPU ("cuda"); "cpu" runs the plain versions
    of the kernels.  `parity_generators` (n, u, l) replaces the coded
    family's generator draw — ``repro_torch.carry`` turns the reference's
    key chain into one.

    A spec that asks for a feature the port does not have yet raises
    ``NotImplementedError`` naming it.
    """
    if isinstance(spec, dict):
        spec = ExperimentSpec.from_dict(spec)
    missing = unsupported_features(spec)
    if missing:
        raise NotImplementedError(
            "the PyTorch port does not support " + "; ".join(missing)
            + " yet")
    # validate the scheme against the live registry up front
    schemes.get_scheme(spec.resolved_scheme)
    return Experiment(spec, x_stack, y_stack, nodes=nodes, rng=rng,
                      device=device, parity_generators=parity_generators)
