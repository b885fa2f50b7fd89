"""Checkpointing of the port (copy of ``repro.checkpoint``)."""
