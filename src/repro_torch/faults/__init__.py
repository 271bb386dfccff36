"""Fault injection of the port (the port of ``repro.faults``).

The coding layer compensates for *missing* client work (stragglers,
erasures: `repro_torch.net`).  This package injects the *wrong*-work
failures a real MEC deployment adds on top: non-finite client gradient
returns, stale-update replay and corrupted parity uploads, which
`repro_torch.core.fed_runtime.build_step`'s non-finite guard and
divergence guard absorb; and checkpoint truncation and bit-flips, which
`repro_torch.checkpoint.io`'s digest verification detects.

`FaultProfile` declares a fault mix (``ExperimentSpec.fault_profile``,
overridden knob by knob by ``fault_params``).  Per-round, per-client fault
draws come from a stream of their own (`sample_fault_rows`), independent
of the delay and channel-trace streams, so turning faults on never shifts
the network a run faces.  Everything here is host-side NumPy, the
reference's code on the same generators, so the draws are bit-identical
to the reference's.  The service-level knobs (``crash_prob``,
``ckpt_corrupt_prob``, ``ckpt_corrupt_kind``) act in the experiment service
(`repro_torch.launch.service`), on the reference's chaos stream.
"""
from repro_torch.faults.profile import (FAULT_PROFILES,  # noqa: F401
                                        FaultProfile, get_fault_profile)
from repro_torch.faults.inject import (CODE_CLEAN, CODE_INF,  # noqa: F401
                                       CODE_NAN, CODE_STALE,
                                       InjectedCrashError, bitflip_file,
                                       corrupt_checkpoint,
                                       sample_fault_rows, truncate_file)

__all__ = [
    "FaultProfile", "FAULT_PROFILES", "get_fault_profile",
    "InjectedCrashError", "sample_fault_rows", "corrupt_checkpoint",
    "truncate_file", "bitflip_file",
    "CODE_CLEAN", "CODE_NAN", "CODE_INF", "CODE_STALE",
]
