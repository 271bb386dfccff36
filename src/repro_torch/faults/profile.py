"""Declarative fault profiles, registered like `CHANNEL_PROFILES` (the
port of ``repro.faults.profile``, field for field).

A `FaultProfile` names the failure modes injected into a run and their
per-round probabilities:

  * **return faults** (``nan_prob`` / ``stale_prob`` /
    ``parity_corrupt_prob``) enter the round step
    (`repro_torch.core.fed_runtime.build_step`): a faulty client uploads a
    non-finite gradient, replays its update from the previous iterate, or
    (coded schemes) the shared parity contribution arrives corrupted.
    Corruption is non-finite garbage, which the non-finite guard can
    detect; arbitrary finite Byzantine values are out of scope;
  * **infrastructure faults** (``crash_prob`` / ``ckpt_corrupt_prob``)
    act in the experiment service (`repro_torch.launch.service`): block
    crashes, checkpoints corrupted on disk.

All knobs default to 0: ``FaultProfile()`` (the ``"none"`` profile) is
benign and, because the fault stream is separate from the delay and
channel-trace streams, gives the fault-free run bit for bit.
"""
from __future__ import annotations

import dataclasses

_NAN_KINDS = ("nan", "inf", "mix")
_CKPT_KINDS = ("truncate", "bitflip", "mix")


@dataclasses.dataclass(frozen=True)
class FaultProfile:
    """Declarative fault-mix knobs (all off by default: benign)."""
    # non-finite client gradient returns: each client's upload is corrupted
    # with `nan_prob` a round; `nan_kind` picks NaN, +inf or an even mix
    nan_prob: float = 0.0
    nan_kind: str = "nan"
    # stale-update replay: the client returns its gradient at the PREVIOUS
    # round's iterate (never on a client-round with a non-finite fault)
    stale_prob: float = 0.0
    # corrupted parity contribution (coded schemes): the round's parity
    # gradient arrives non-finite and is masked
    parity_corrupt_prob: float = 0.0
    # service-level: probability a scheduled block crashes
    crash_prob: float = 0.0
    # service-level: probability a just-written checkpoint is corrupted on
    # disk, and how ("truncate" | "bitflip" | "mix")
    ckpt_corrupt_prob: float = 0.0
    ckpt_corrupt_kind: str = "truncate"

    def __post_init__(self):
        for name in ("nan_prob", "stale_prob", "parity_corrupt_prob",
                     "crash_prob", "ckpt_corrupt_prob"):
            val = getattr(self, name)
            if not (isinstance(val, (int, float)) and 0.0 <= val <= 1.0):
                raise ValueError(f"{name}={val!r} must lie in [0, 1]")
        if self.nan_kind not in _NAN_KINDS:
            raise ValueError(f"nan_kind={self.nan_kind!r} must be one of "
                             f"{_NAN_KINDS}")
        if self.ckpt_corrupt_kind not in _CKPT_KINDS:
            raise ValueError(f"ckpt_corrupt_kind="
                             f"{self.ckpt_corrupt_kind!r} must be one of "
                             f"{_CKPT_KINDS}")

    @property
    def has_return_faults(self) -> bool:
        """True if the round step must inject per-round faults."""
        return (self.nan_prob > 0.0 or self.stale_prob > 0.0
                or self.parity_corrupt_prob > 0.0)

    @property
    def has_service_faults(self) -> bool:
        """True if an experiment service would inject infra faults."""
        return self.crash_prob > 0.0 or self.ckpt_corrupt_prob > 0.0

    @property
    def is_benign(self) -> bool:
        return not (self.has_return_faults or self.has_service_faults)

    def to_dict(self) -> dict:
        """Plain-JSON dict; `from_dict(to_dict(p)) == p`."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "FaultProfile":
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(
                f"unknown FaultProfile field(s) {sorted(unknown)}")
        return cls(**d)


#: named profiles addressable from ``ExperimentSpec.fault_profile``
FAULT_PROFILES: dict[str, FaultProfile] = {
    # benign: the fault-free step
    "none": FaultProfile(),
    # flaky clients: ~8% of uploads a round come back NaN
    "flaky_clients": FaultProfile(nan_prob=0.08),
    # occasional NaN/inf plus stale-update replay
    "byzantine_lite": FaultProfile(nan_prob=0.05, nan_kind="mix",
                                   stale_prob=0.10),
    # the shared parity upload is corrupted in ~15% of rounds
    "corrupt_parity": FaultProfile(parity_corrupt_prob=0.15),
    # infrastructure only: blocks crash ~30% of the time
    "crash_loop": FaultProfile(crash_prob=0.3),
    # infrastructure only: half the checkpoints written are corrupted
    "bad_disk": FaultProfile(ckpt_corrupt_prob=0.5,
                             ckpt_corrupt_kind="mix"),
    # everything at once
    "chaos": FaultProfile(nan_prob=0.05, nan_kind="mix", stale_prob=0.05,
                          parity_corrupt_prob=0.10, crash_prob=0.2,
                          ckpt_corrupt_prob=0.3, ckpt_corrupt_kind="mix"),
}


def get_fault_profile(name: str) -> FaultProfile:
    try:
        return FAULT_PROFILES[name]
    except KeyError:
        raise ValueError(f"unknown fault profile {name!r} (known: "
                         f"{tuple(FAULT_PROFILES)})") from None
