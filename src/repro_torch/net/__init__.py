"""Wireless network dynamics of the port: time-varying channels, churn,
adaptation (the port of ``repro.net``).

The paper's delay model (`repro_torch.core.delay_model`) is *stationary*:
one `NodeDelayParams` per node, frozen for the whole run, with the load
allocation solved exactly once at setup.  This package models what the
stationary view misses — links and compute that drift over a training run:

  channel.py    declarative `ChannelProfile` (Gilbert–Elliott erasure
                states, log-normal shadowing with an LTE MCS-style rate
                mapping, bounded compute-speed drift, dropout/rejoin
                churn) plus the named `CHANNEL_PROFILES` registry that
                `ExperimentSpec.channel_profile` addresses.
  trace.py      vectorized, deterministic-per-seed generation of
                `(rounds, n)` network-state traces, and the traced delay
                sampler that extends `delay_model.sample_round_times` —
                bit-exactly equal to it under the static profile.
  estimator.py  online estimation of `(mu, tau, p)` from observed round
                telemetry (EWMA or windowed means) and the planner that
                re-solves the load allocation every `adapt_every` rounds.

Everything here is host-side NumPy, the reference's code on the same
generators, so traces, observations, estimates and plans are bit-identical
to the reference's; only the adaptive_coded load masks are stacked into a
tensor on the experiment's device.
"""
from repro_torch.net.channel import CHANNEL_PROFILES, ChannelProfile  # noqa: F401
from repro_torch.net.trace import (NetworkTrace, TraceState,  # noqa: F401
                                   generate_trace, generate_trace_block,
                                   sample_round_observations,
                                   sample_round_times_traced)
from repro_torch.net.estimator import (AdaptiveController,  # noqa: F401
                                       AdaptiveSchedule, SegmentPlan,
                                       OnlineChannelEstimator, plan_segment)
