"""Configuration dataclasses of the PyTorch port.

The same frozen dataclasses as ``repro.config`` (``FLConfig``,
``TrainConfig``, ``RFFConfig``, ``ExperimentSpec``), field for field, so a
spec's ``to_dict()`` equals the reference's and a spec the reference wrote
as JSON revives here with ``ExperimentSpec.from_dict``.

The port runs the flat engine: the batched engine with the fused or
unfused coded round (``fused_coded``), with raw features embedded in the
gradient kernel (``fused_embed``), block-structured and checkpointed
(``checkpoint_every``), over stationary delays or a traced channel
(``channel_profile``/``channel_params``, `resolved_channel`), with the
adaptive schemes (``adapt_every``), return-fault injection
(``fault_profile``/``fault_params``, `resolved_faults`), secure
aggregation of the parity sets (``secure_aggregation``), and the legacy
per-client oracle (``engine="legacy"``); and the hierarchical tier
(``hier_shards``/``sample_fraction``, `hier_active`,
``repro_torch.hier``).  A spec may still name the one feature the port
does not have yet, a client mesh: the spec holds it so that it
round-trips, and ``build_experiment`` raises ``NotImplementedError``
naming the feature (`unsupported_features`).  Every combination the
reference refuses when a spec is made raises ``ValueError`` here too,
with the reference's message, and the fields are checked in the
reference's order, so a spec with two faults names the same one.

The model zoo's configurations (``ModelConfig`` and its family blocks,
``ShapeConfig``, ``SHAPES``) are copied field for field as well; the
architectures themselves live in ``repro_torch.configs``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Tuple



@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    num_shared_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0            # expert hidden size (may differ from dense d_ff)
    capacity_factor: float = 1.25
    every_n_layers: int = 1         # apply MoE FFN every n-th layer (1 = all)
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 style selective SSM (used by jamba)."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0                # 0 -> ceil(d_model/16)
    attn_every_n: int = 8           # hybrid: 1 attention layer per n layers


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64            # rank of data-dependent decay LoRA
    shift_lora: int = 32            # rank of data-dependent token-shift LoRA


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qk_norm: bool = False
    rope_theta: float = 10000.0
    swa_window: int = 0             # 0 = full attention; >0 sliding window
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # enc-dec (whisper): number of encoder layers; encoder input is a stub
    # of precomputed frame embeddings (audio carve-out).
    n_encoder_layers: int = 0
    encoder_seq: int = 0            # fixed encoder frames (whisper: 1500)
    # vlm: number of prefix patch-embedding positions (stub ViT output)
    n_prefix_patches: int = 0
    # pad the embedding/vocab rows up to a multiple of 16; padded ids are
    # masked out of the logits
    pad_vocab: bool = False
    dtype: str = "bfloat16"
    # citation for the config (paper / model card)
    source: str = ""

    @property
    def vocab_padded(self) -> int:
        if not self.pad_vocab:
            return self.vocab
        return -(-self.vocab // 16) * 16

    @property
    def attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """True if the arch natively supports O(<seq^2) long-context decode."""
        return self.arch_type in ("ssm", "hybrid") or self.swa_window > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

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
        if self.checkpoint_every > 0 and self.engine == "legacy":
            raise ValueError(
                "checkpoint_every requires the batched engine; the legacy "
                "per-client oracle has no block-structured run state")
        if self.fused_embed:
            if self.rff is None:
                raise ValueError(
                    "fused_embed=True requires an RFFConfig (`rff`): the "
                    "fused kernel derives q and the shared Omega/delta "
                    "frequencies from it")
            if self.engine == "legacy":
                raise ValueError(
                    "fused_embed requires the batched engine; the legacy "
                    "per-client oracle consumes pre-embedded features")
            if self.mesh is not None:
                raise ValueError(
                    "fused_embed does not support client-mesh sharding yet")
        if self.run_id is not None and not (
                isinstance(self.run_id, str)
                and re.fullmatch(r"[A-Za-z0-9][A-Za-z0-9._-]{0,127}",
                                 self.run_id)):
            raise ValueError(
                f"run_id must be a filesystem-safe slug "
                f"([A-Za-z0-9._-], not starting with '.'), "
                f"got {self.run_id!r}")
        if self.channel_profile is not None or self.channel_params:
            from repro_torch.net.channel import CHANNEL_PROFILES
            name = self.channel_profile
            if name is not None and name not in CHANNEL_PROFILES:
                raise ValueError(
                    f"unknown channel_profile {name!r} "
                    f"(expected one of {tuple(CHANNEL_PROFILES)})")
            if self.engine == "legacy":
                raise ValueError(
                    "channel dynamics require the batched engine; the "
                    "legacy per-client oracle has no traced-delay path")
            # knob names (and values, via construction) validated eagerly
            # so the error points at the spec
            self.resolved_channel()
        if not isinstance(self.nonfinite_guard, bool):
            raise ValueError(f"nonfinite_guard must be a bool, "
                             f"got {self.nonfinite_guard!r}")
        if self.fault_profile is not None or self.fault_params:
            from repro_torch.faults.profile import FAULT_PROFILES
            name = self.fault_profile
            if name is not None and name not in FAULT_PROFILES:
                raise ValueError(
                    f"unknown fault_profile {name!r} "
                    f"(expected one of {tuple(FAULT_PROFILES)})")
            if self.engine == "legacy":
                raise ValueError(
                    "fault injection requires the batched engine; the "
                    "legacy per-client oracle has no fault path")
            # knob names and values validated eagerly, as channel_params
            faults = self.resolved_faults()
            if self.mesh is not None and faults.has_return_faults:
                raise ValueError(
                    "return-fault injection does not support client-mesh "
                    "sharding yet (crash/checkpoint faults are fine)")
        if not isinstance(self.hier_shards, int) \
                or isinstance(self.hier_shards, bool) or self.hier_shards < 1:
            raise ValueError(f"hier_shards must be an int >= 1, "
                             f"got {self.hier_shards!r}")
        if self.hier_shards > self.fl.n_clients:
            raise ValueError(
                f"hier_shards={self.hier_shards} exceeds "
                f"fl.n_clients={self.fl.n_clients} (each edge-aggregator "
                "shard needs at least one client)")
        if not isinstance(self.sample_fraction, (int, float)) \
                or isinstance(self.sample_fraction, bool) \
                or not 0.0 < float(self.sample_fraction) <= 1.0:
            raise ValueError(f"sample_fraction must lie in (0, 1], "
                             f"got {self.sample_fraction!r}")
        if self.hier_active:
            hier = (f"hier_shards={self.hier_shards}, "
                    f"sample_fraction={self.sample_fraction}")
            if self.engine == "legacy":
                raise ValueError(
                    f"the hierarchical tier ({hier}) requires the batched "
                    "engine; the legacy per-client oracle has no sharded "
                    "round")
            if self.channel_profile is not None or self.channel_params:
                raise ValueError(
                    f"the hierarchical tier ({hier}) has no traced-channel "
                    "path yet; drop channel_profile/channel_params "
                    "(population traces: "
                    "repro_torch.hier.generate_trace_chunked)")
            if self.fault_profile is not None or self.fault_params:
                raise ValueError(
                    f"the hierarchical tier ({hier}) has no fault-injection "
                    "path yet; drop fault_profile/fault_params")
            if self.adapt_every > 0:
                raise ValueError(
                    f"the hierarchical tier ({hier}) runs the static coded "
                    "round per shard; adaptive re-allocation "
                    f"(adapt_every={self.adapt_every}) is not supported")
            if self.fused_embed:
                raise ValueError(
                    f"the hierarchical tier ({hier}) consumes embedded "
                    "client blocks; fused_embed is not supported")
            if self.secure_aggregation:
                raise ValueError(
                    f"the hierarchical tier ({hier}) does not implement "
                    "secure aggregation of shard rows yet")
            if self.mesh is not None:
                raise ValueError(
                    f"the hierarchical tier ({hier}) shards clients over "
                    "edge aggregators, not a device mesh; drop mesh")

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

    @property
    def channel_params_dict(self) -> dict:
        return dict(self.channel_params)

    @property
    def fault_params_dict(self) -> dict:
        return dict(self.fault_params)

    def resolved_faults(self):
        """The effective `FaultProfile`, or None when no faults are
        requested.  ``fault_params`` override the named profile's knobs
        (base profile "none" when only overrides are given)."""
        if self.fault_profile is None and not self.fault_params:
            return None
        from repro_torch.faults.profile import FAULT_PROFILES
        base = FAULT_PROFILES[self.fault_profile or "none"]
        if not self.fault_params:
            return base
        try:
            return dataclasses.replace(base, **self.fault_params_dict)
        except TypeError as exc:
            knobs = tuple(f.name for f in dataclasses.fields(base))
            raise ValueError(f"bad fault_params: {exc} "
                             f"(valid knobs: {knobs})") from None

    def resolved_channel(self):
        """The effective `ChannelProfile`, or None when no dynamics are
        requested.  ``channel_params`` override the named profile's knobs
        (base profile "static" when only overrides are given)."""
        if self.channel_profile is None and not self.channel_params:
            return None
        from repro_torch.net.channel import CHANNEL_PROFILES
        base = CHANNEL_PROFILES[self.channel_profile or "static"]
        if not self.channel_params:
            return base
        try:
            return dataclasses.replace(base, **self.channel_params_dict)
        except TypeError as exc:
            knobs = tuple(f.name for f in dataclasses.fields(base))
            raise ValueError(f"bad channel_params: {exc} "
                             f"(valid knobs: {knobs})") from None

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
        (spec.mesh is not None, "client-mesh sharding (mesh)"),
    )
    return [name for asked, name in checks if asked]
