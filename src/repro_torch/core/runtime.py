"""Scenario execution entry point of the port.

``run_scenario`` compiles a ``Scenario`` and runs it on the vector
runtime, on the card unless ``vector_config`` asks for the CPU.  The
event-engine backends of ``repro.core.runtime`` (``sim``, ``engine``)
are not ported yet.
"""
from __future__ import annotations


def run_scenario(scenario, backend: str = "vector", *, rep: int = 0,
                 vector_config=None):
    """Compile ``scenario`` and execute repetition ``rep`` on ``backend``.
    Returns the finished runtime (telemetry under ``.telemetry``)."""
    if backend in ("sim", "engine"):
        raise NotImplementedError(
            f"backend {backend!r} is not ported yet (use 'vector')")
    if backend != "vector":
        raise ValueError(f"unknown backend: {backend!r}")
    from repro_torch.vector import VectorRuntime
    rt = VectorRuntime(scenario.compile(), rep=rep, config=vector_config)
    rt.run()
    return rt
