"""Hierarchical population-scale tier of the port (edge aggregators over
client shards), the port of ``repro.hier``.

Scales the CodedFedL round from one MEC cell (n ~ 1e3) to a population of
n = 1e5-1e6 clients:

  * `repro_torch.hier.population` — chunked/streamed population state:
    stacked delay-parameter arrays instead of n node objects, a
    block-by-block two-step load-allocation solver (torch float64 on the
    experiment's device, a fixed host fold of the totals), and a
    client-chunked channel-trace generator, all O(block) memory.
  * `repro_torch.hier.sampling` — per-round client sampling on its own
    fixed-layout RNG stream plus the coded-compensation parity reweight
    that keeps the sampled update an unbiased SGD step.
  * `repro_torch.hier.topology` — the two-level topology: edge-aggregator
    shards each run a coded round over their cohort on the device
    (``linreg_grad_masked`` + ``linreg_grad`` a shard a round, the parity
    set encoded with ``parity_encode_batched``) and contribute one
    aggregate row to the server-level combine (`HierExperiment`).

`repro_torch.api.build_experiment` routes specs with ``hier_shards > 1``
or ``sample_fraction < 1.0`` here; the identity configuration
(``hier_shards=1, sample_fraction=1.0``) stays on the flat engine, so its
trajectory is bit-identical to a directly built `Experiment`.
"""
from repro_torch.hier.population import (generate_trace_chunked,  # noqa: F401
                                         iter_trace_chunks,
                                         nodes_for_range,
                                         population_delay_arrays,
                                         two_step_allocate_chunked)
from repro_torch.hier.sampling import (SAMPLE_SEED_OFFSET,  # noqa: F401
                                       parity_reweight, sample_cohort_rows,
                                       sampling_rng)
from repro_torch.hier.topology import (HierExperiment,  # noqa: F401
                                       HierResult, ShardPlan, shard_ranges)

__all__ = [
    "HierExperiment", "HierResult", "ShardPlan", "shard_ranges",
    "SAMPLE_SEED_OFFSET", "parity_reweight", "sample_cohort_rows",
    "sampling_rng", "generate_trace_chunked", "iter_trace_chunks",
    "nodes_for_range", "population_delay_arrays",
    "two_step_allocate_chunked",
]
