"""Sharding rules of the port (copy of ``repro.distributed``)."""
