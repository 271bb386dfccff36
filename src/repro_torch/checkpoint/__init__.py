"""Checkpoints of resumable runs (the port of ``repro.checkpoint``)."""
