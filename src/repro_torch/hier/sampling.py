"""Per-round client sampling with coded compensation (hierarchical tier),
the port of ``repro.hier.sampling``: NumPy, the reference's code, so the
cohorts are bit-identical to the reference's.

Sampling gets its OWN seeded RNG stream, exactly like the fault stream
(`repro_torch.faults.inject`, ``seed + 7717``) and the trace stream
(``seed + 9973``): the cohort draws live at ``fl.seed + SAMPLE_SEED_OFFSET``
and consume a fixed layout — one uniform block of shape ``(rounds, n)``
per block of rounds, drawn whether or not ``sample_fraction < 1.0``.
Two invariants follow (the contract of the trace and fault streams too):

  * toggling ``sample_fraction`` never shifts the delay, channel-trace,
    or fault realizations — those streams are never touched;
  * the stream position checkpoints/resumes bit-identically through
    `RunState.sample_rng_state` — uniform blocks are drawn row-major over
    rounds, so any block partition of a run consumes the same draws.

Coded compensation: under Bernoulli(f) sampling only ~f of the client
mass participates, so the expected returned client mass shrinks from
``R = sum_j l_j P(T_j <= t*)`` to ``f * R``.  The global parity gradient
was built (paper §III-D) to stand in for the *expected missing mass*
``m - R``; `parity_reweight` scales it by ``(m - f R) / (m - R)`` so it
stands in for the larger sampled-round miss ``m - f R`` instead, keeping
``E[g_round] ~= m * grad`` — an unbiased SGD step at every f, with the
reweight exactly 1.0 at f = 1 (the flat engine's update, bit-identical).
"""
from __future__ import annotations

import numpy as np

#: dedicated sampling-stream seed offset (delay draws live at +17, the
#: subset permutation at +99, secure-agg at +1234, faults at +7717,
#: traces at +9973 — all disjoint by construction)
SAMPLE_SEED_OFFSET = 5557


def sampling_rng(fl_seed: int) -> np.random.Generator:
    """Fresh generator at the start of the dedicated sampling stream."""
    return np.random.default_rng((fl_seed + SAMPLE_SEED_OFFSET,))


def sample_cohort_rows(rng: np.random.Generator, rounds: int, n: int,
                       sample_fraction: float) -> np.ndarray:
    """Per-round Bernoulli(f) cohort masks, (rounds, n) bool.

    Fixed layout: ONE uniform block of shape (rounds, n) is drawn per
    call regardless of ``sample_fraction`` (f = 1.0 draws too, and every
    client is then in-cohort with certainty), so toggling f re-interprets
    the same uniforms rather than consuming a different stream prefix.
    """
    u = rng.random((rounds, n))
    return u < float(sample_fraction)


def parity_reweight(m: float, expected_return_mass: float,
                    sample_fraction: float) -> float:
    """Coded-compensation scale on the parity gradient (module docstring).

        w(f) = (m - f * R) / (m - R),   R = sum_j l_j P(T_j <= t*)

    w(1.0) == 1.0 exactly; w grows as f shrinks (the parity set covers
    the unsampled mass on top of the usual straggled mass).  R is clipped
    a hair below m so a deployment whose clients return almost surely
    degrades to a finite reweight instead of dividing by zero.
    """
    m = float(m)
    r = min(float(expected_return_mass), m * (1.0 - 1e-9))
    f = float(sample_fraction)
    if not 0.0 < f <= 1.0:
        raise ValueError(f"sample_fraction={f} must lie in (0, 1]")
    if f == 1.0:
        return 1.0
    return (m - f * r) / (m - r)
