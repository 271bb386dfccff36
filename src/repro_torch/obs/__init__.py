"""Run telemetry of the port: span timers, per-round event journal,
straggler attribution (the port of ``repro.obs``).

Everything here is observational — enabling telemetry never touches a
random stream or changes a trajectory (``tests/test_torch_obs.py``).  The
span collector is the port's own, apart from the reference's.
"""
from repro_torch.obs import spans
from repro_torch.obs.attribution import (
    Attribution,
    attribution_from_blocks,
    compute_attribution,
    round_deadlines,
)
from repro_torch.obs.events import (
    EVENTS_NAME,
    RunJournal,
    histories_equal,
    history_from_journal,
    load_events,
)
from repro_torch.obs.spans import (SPANS_NAME, collecting, disable, enable,
                                   enabled, span, totals)

__all__ = [
    "spans",
    "span",
    "enable",
    "disable",
    "enabled",
    "totals",
    "collecting",
    "SPANS_NAME",
    "RunJournal",
    "EVENTS_NAME",
    "load_events",
    "history_from_journal",
    "histories_equal",
    "Attribution",
    "attribution_from_blocks",
    "compute_attribution",
    "round_deadlines",
]
