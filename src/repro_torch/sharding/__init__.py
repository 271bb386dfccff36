"""Sharding policies of the compile driver (fsdp_tp / tp_only / dp_only,
each with an optional ``_ep`` suffix): the counterpart of
``repro.sharding``."""
from repro_torch.sharding import policy

__all__ = ["policy"]
