"""Configuration dataclasses of the PyTorch port.

The same frozen dataclasses as ``repro.config`` (``FLConfig``,
``TrainConfig``, ``RFFConfig``, ``ExperimentSpec``), field for field, so a
spec's ``to_dict()`` equals the reference's and a spec the reference wrote
as JSON revives here with ``ExperimentSpec.from_dict``.

The port runs the main path only.  A spec may still name a feature the port
does not have yet (channel dynamics, fault injection, the hierarchical
tier, a client mesh, secure aggregation, the adaptive schemes,
``fused_embed``, ``fused_coded=False``, ``engine="legacy"``): the spec holds
it so that it round-trips, and ``build_experiment`` raises
``NotImplementedError`` naming the feature (`unsupported_features`).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgd"          # sgd | momentum | adam
    learning_rate: float = 6.0      # paper's initial step size for RFF model
    momentum: float = 0.0
    weight_decay: float = 0.0
    l2_reg: float = 9e-6            # paper's lambda
    lr_decay: float = 0.8           # paper: step decay 0.8 at epochs 40, 65
    lr_decay_epochs: Tuple[int, ...] = (40, 65)
    epochs: int = 70
    remat: bool = True
    sharding_policy: str = "fsdp_tp"   # fsdp_tp | tp_only | dp_only


@dataclasses.dataclass(frozen=True)
class FLConfig:
    """Federated-learning runtime configuration (paper §V-A defaults)."""
    n_clients: int = 30
    scheme: str = "coded"           # coded | naive | greedy
    psi: float = 0.1                # greedy: wait for (1-psi)*n clients
    delta: float = 0.1              # coded: u_max = delta * m
    # MEC network parameters (paper §V-A)
    max_rate_bps: float = 216e3     # 3 LTE resource blocks
    rate_decay: float = 0.95        # k1
    max_mac_rate: float = 3.072e6   # MAC/s
    mac_decay: float = 0.8          # k2
    alpha: float = 2.0              # compute/memory-access ratio
    p_erasure: float = 0.1          # link erasure probability
    overhead: float = 0.10          # protocol overhead
    bits_per_scalar: int = 32
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class RFFConfig:
    """Paper §V-A kernel embedding hyperparameters."""
    q: int = 2000
    sigma: float = 5.0
    seed: int = 1234


_ENGINES = ("batched", "legacy")
_KERNEL_BACKENDS = ("xla", "pallas")
_ALLOC_BACKENDS = ("auto", "scalar", "vectorized")


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One federated experiment, declaratively (see ``repro.config``).

    Build the runnable deployment with
    ``repro_torch.api.build_experiment(spec, xs, ys)``.

    ``kernel_backend`` is kept for the round trip with the reference only.
    The port does not read it: it dispatches by the device of the tensors.
    Tensors on the CPU take the plain PyTorch versions of the kernels
    (``repro_torch.kernels.ref``), CUDA tensors the hand-written kernels.
    """
    fl: FLConfig = FLConfig()
    train: TrainConfig = TrainConfig()
    rff: Optional[RFFConfig] = None
    scheme: Optional[str] = None
    scheme_params: Tuple[Tuple[str, object], ...] = ()
    delay_profile: Optional[str] = None
    channel_profile: Optional[str] = None
    channel_params: Tuple[Tuple[str, object], ...] = ()
    adapt_every: int = 0
    fault_profile: Optional[str] = None
    fault_params: Tuple[Tuple[str, object], ...] = ()
    nonfinite_guard: bool = True
    engine: str = "batched"
    kernel_backend: str = "xla"
    alloc_backend: str = "auto"
    mesh: Optional[int] = None
    fused_coded: bool = True
    fused_embed: bool = False
    secure_aggregation: bool = False
    steps_per_epoch: int = 1
    checkpoint_every: int = 0
    run_id: Optional[str] = None
    hier_shards: int = 1
    sample_fraction: float = 1.0

    def __post_init__(self):
        if self.engine not in _ENGINES:
            raise ValueError(f"unknown engine {self.engine!r} "
                             f"(expected one of {_ENGINES})")
        if self.kernel_backend not in _KERNEL_BACKENDS:
            raise ValueError(f"unknown kernel_backend "
                             f"{self.kernel_backend!r} "
                             f"(expected one of {_KERNEL_BACKENDS})")
        if self.alloc_backend not in _ALLOC_BACKENDS:
            raise ValueError(f"unknown alloc_backend {self.alloc_backend!r} "
                             f"(expected one of {_ALLOC_BACKENDS})")
        if self.mesh is not None and (not isinstance(self.mesh, int)
                                      or self.mesh < 1):
            raise ValueError(f"mesh must be a positive device count or "
                             f"None, got {self.mesh!r}")
        if self.steps_per_epoch < 1:
            raise ValueError(f"steps_per_epoch must be >= 1, "
                             f"got {self.steps_per_epoch}")
        # normalize the *_params fields (dict / iterable of pairs) to a
        # sorted tuple of pairs so equal specs hash equal
        for field in ("scheme_params", "channel_params", "fault_params"):
            params = getattr(self, field)
            if isinstance(params, dict):
                items = params.items()
            else:
                items = (tuple(p) for p in params)
            norm = tuple(sorted((str(k), v) for k, v in items))
            object.__setattr__(self, field, norm)
        if self.delay_profile is not None:
            from repro_torch.core.delay_model import HETEROGENEITY_PROFILES
            if self.delay_profile not in HETEROGENEITY_PROFILES:
                raise ValueError(
                    f"unknown delay_profile {self.delay_profile!r} "
                    f"(expected one of "
                    f"{tuple(HETEROGENEITY_PROFILES)})")
        if self.adapt_every < 0:
            raise ValueError(
                f"adapt_every must be >= 0, got {self.adapt_every}")
        if (not isinstance(self.checkpoint_every, int)
                or self.checkpoint_every < 0):
            raise ValueError(f"checkpoint_every must be an int >= 0, "
                             f"got {self.checkpoint_every!r}")
        if self.fused_embed and self.rff is None:
            raise ValueError(
                "fused_embed=True requires an RFFConfig (`rff`): the "
                "fused kernel derives q and the shared Omega/delta "
                "frequencies from it")
        if self.run_id is not None and not (
                isinstance(self.run_id, str)
                and re.fullmatch(r"[A-Za-z0-9][A-Za-z0-9._-]{0,127}",
                                 self.run_id)):
            raise ValueError(
                f"run_id must be a filesystem-safe slug "
                f"([A-Za-z0-9._-], not starting with '.'), "
                f"got {self.run_id!r}")
        if not isinstance(self.nonfinite_guard, bool):
            raise ValueError(f"nonfinite_guard must be a bool, "
                             f"got {self.nonfinite_guard!r}")
        if not isinstance(self.hier_shards, int) \
                or isinstance(self.hier_shards, bool) or self.hier_shards < 1:
            raise ValueError(f"hier_shards must be an int >= 1, "
                             f"got {self.hier_shards!r}")
        if not isinstance(self.sample_fraction, (int, float)) \
                or isinstance(self.sample_fraction, bool) \
                or not 0.0 < float(self.sample_fraction) <= 1.0:
            raise ValueError(f"sample_fraction must lie in (0, 1], "
                             f"got {self.sample_fraction!r}")

    @property
    def hier_active(self) -> bool:
        """True when the spec asks for the hierarchical tier."""
        return self.hier_shards > 1 or float(self.sample_fraction) < 1.0

    @property
    def resolved_scheme(self) -> str:
        return self.scheme if self.scheme is not None else self.fl.scheme

    @property
    def scheme_params_dict(self) -> dict:
        return dict(self.scheme_params)

    def resolved_fl(self) -> FLConfig:
        """`fl` with the named delay profile's knobs applied."""
        if self.delay_profile is None:
            return self.fl
        from repro_torch.core.delay_model import HETEROGENEITY_PROFILES
        return dataclasses.replace(
            self.fl, **HETEROGENEITY_PROFILES[self.delay_profile])

    # ------------------------------------------------------------- round trip
    def to_dict(self) -> dict:
        """Plain-JSON dict; `from_dict(to_dict(spec)) == spec`."""
        d = dataclasses.asdict(self)
        d["scheme_params"] = dict(self.scheme_params)
        d["channel_params"] = dict(self.channel_params)
        d["fault_params"] = dict(self.fault_params)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        d = dict(d)
        for key, typ in (("fl", FLConfig), ("train", TrainConfig),
                         ("rff", RFFConfig)):
            val = d.get(key)
            if isinstance(val, dict):
                val = dict(val)
                # JSON has no tuples; restore the tuple-typed fields
                for tup_field in ("lr_decay_epochs",):
                    if tup_field in val and val[tup_field] is not None:
                        val[tup_field] = tuple(val[tup_field])
                d[key] = typ(**val)
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - valid
        if unknown:
            raise ValueError(
                f"unknown ExperimentSpec field(s) {sorted(unknown)} "
                f"(valid fields: {sorted(valid)})")
        return cls(**d)


def unsupported_features(spec: ExperimentSpec) -> list[str]:
    """Names of the features `spec` asks for that the port lacks."""
    checks = (
        (spec.channel_profile is not None or bool(spec.channel_params),
         "channel dynamics (channel_profile/channel_params)"),
        (spec.adapt_every > 0, "adaptive re-allocation (adapt_every)"),
        (spec.resolved_scheme in ("adaptive_coded", "adaptive_greedy"),
         f"the adaptive scheme {spec.resolved_scheme!r}"),
        (spec.fault_profile is not None or bool(spec.fault_params),
         "fault injection (fault_profile/fault_params)"),
        (spec.hier_active,
         "the hierarchical tier (hier_shards/sample_fraction)"),
        (spec.mesh is not None, "client-mesh sharding (mesh)"),
        (spec.secure_aggregation, "secure aggregation"),
        (spec.fused_embed, "the fused embed->gradient path (fused_embed)"),
        (not spec.fused_coded,
         "the unfused coded gradient (fused_coded=False)"),
        (spec.engine == "legacy", "the legacy per-client engine"),
        (spec.checkpoint_every > 0, "checkpointed runs (checkpoint_every)"),
    )
    return [name for asked, name in checks if asked]
