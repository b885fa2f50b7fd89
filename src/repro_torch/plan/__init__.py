"""Gradient-based capacity planning over the smoothed vector runtime, on
the card.

Port of ``repro.plan``.  The dense alternative — sweeping a
provisioning grid on the exact vector runtime — costs O(grid points x
repetitions) cell evaluations per capacity question.
``repro_torch.plan`` answers the same question with O(optimizer steps)
through ``torch.autograd`` of a smoothed surrogate
(``repro_torch.vector.soft``), then spends a SMALL number of exact cells
verifying the rounded answer: the surrogate proposes, the exact runtime
decides.  Both run on the card unless ``VectorConfig(device="cpu")``
asks for the CPU.  ``benchmarks/torch_port/bench_plan.py`` holds the
planner to >= 10x fewer exact cells than the dense grid.

    PYTHONPATH=src python -m repro_torch.plan steady --slo 0.02 \
        --set policy=jsq --set qps=2600 --capacity 4,1,24
"""
from repro_torch.plan.model import (OBJECTIVES, PlanConfig, PlanData,
                                    PlanError, analytic_capacity,
                                    build_plan_data, hard_metrics, plan_loss,
                                    surrogate_metrics)
from repro_torch.plan.planner import (DEFAULT_BOXES, PlanResult, PlanSpec,
                                      plan_spec_from_sweep, run_plan,
                                      run_plan_sweep)

__all__ = [
    "OBJECTIVES", "PlanConfig", "PlanData", "PlanError", "PlanResult",
    "PlanSpec", "DEFAULT_BOXES", "analytic_capacity", "build_plan_data",
    "hard_metrics", "plan_loss", "plan_spec_from_sweep", "run_plan",
    "run_plan_sweep", "surrogate_metrics",
]
