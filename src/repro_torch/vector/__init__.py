"""Vector runtime on PyTorch: whole sweep grids as batched array
programs, with the slot scan and the quantile head as CUDA kernels.

Port of ``repro.vector``.  A grid cell is one (point, repetition) of a
scenario; the runtime lays the whole grid out structure-of-arrays with
axes ``(cell, time_slot, server)`` and advances fixed-step queueing
dynamics for every cell at once on the card.  It is the statistically
equivalent fast lane of the TailBench++ event engine, held to the JAX
package's vector runtime (``repro.vector``) cell for cell.
"""
from repro_torch.vector.compile import (VectorCompileError, VectorProgram,
                                        compile_experiment,
                                        program_from_numpy)
from repro_torch.vector.runtime import (VectorConfig, VectorResult,
                                        VectorRuntime, run_cells)
from repro_torch.vector.telemetry import VectorTelemetry

__all__ = [
    "VectorCompileError", "VectorProgram", "compile_experiment",
    "program_from_numpy", "VectorConfig", "VectorResult", "VectorRuntime",
    "VectorTelemetry", "run_cells",
]
