"""Closed-loop control plane + client resilience primitives.

``ControlPolicy`` implementations observe windowed telemetry
(``Observation``) and emit actions — scale the fleet, tune admission
control — which the runtimes apply with actuation lag and cooldowns
(``ControlLoop``).  The resilience side (``RetryPolicy``,
``AdmissionController``, ``CircuitBreaker``, ``RetryBudget``) gives
clients timeouts, bounded jittered retries, and shedding whose refused
requests are accounted explicitly in the latency statistics (see
``LatencyRecorder.record_failure``) instead of vanishing from the
percentiles.

Copy of ``repro.control``, NumPy only: the event simulator, the vector
compiler's fluid pre-pass and (later) the engine runtime share it.
The package deliberately imports nothing from ``repro_torch.core`` — the
runtimes import it, never the reverse.
"""
from repro_torch.control.loop import ControlLoop, observe_runtime
from repro_torch.control.policy import (CONTROLLERS, AdmissionShedder,
                                        ControlPolicy, ControlSpec,
                                        Observation, ThresholdAutoscaler)
from repro_torch.control.resilience import (AdmissionController,
                                            BreakerSpec, CircuitBreaker,
                                            RetryBudget, RetryPolicy)

__all__ = [
    "AdmissionController", "AdmissionShedder", "BreakerSpec",
    "CircuitBreaker", "CONTROLLERS", "ControlLoop", "ControlPolicy",
    "ControlSpec", "Observation", "observe_runtime", "RetryBudget",
    "RetryPolicy", "ThresholdAutoscaler",
]
