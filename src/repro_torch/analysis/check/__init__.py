"""Static spec validators over Scenario/Sweep/Experiment declarations.

Copy of ``repro.analysis.check`` over the port's declarations
(``repro_torch.scenarios``, ``repro_torch.sweep``).

``check_scenario`` compiles one declaration (cheap — no simulation)
and runs the capability matrix against a target backend plus schedule
sanity.  ``check_sweep`` additionally enumerates the sweep's derived
seeds for collisions and validates every point against the backend it
would actually run on (a per-point ``runtime`` axis overrides the
sweep default).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.analysis.check.capability import (  # noqa: F401
    BACKENDS,
    CAPABILITIES,
    INJECTION_KINDS,
    capabilities,
    format_matrix,
    required_features,
    skipped_kinds,
    support_matrix,
    unsupported_on,
)
from repro_torch.analysis.check.findings import CheckFinding  # noqa: F401
from repro_torch.analysis.check.schedule import check_schedule  # noqa: F401
from repro_torch.analysis.check.seeds import check_sweep_seeds  # noqa: F401


def _compile(obj):
    """Scenario -> Experiment; an Experiment passes through."""
    if hasattr(obj, "compile"):
        return obj.compile()
    return obj


def capability_findings(exp, backend: str, target: str) -> list:
    """Unsupported-feature errors, with the capability matrix."""
    missing = unsupported_on(exp, backend)
    if not missing:
        return []
    details = "\n".join(f"  {d}: {f} not supported on {backend!r}"
                        for f, d in missing)
    return [CheckFinding(
        rule="capability", severity="error", target=target,
        message=(f"cannot run on backend {backend!r}:\n{details}\n"
                 f"{format_matrix(exp)}"))]


def check_scenario(scenario, backend: Optional[str] = None,
                   dt: float = 0.05) -> list:
    """-> [CheckFinding] for one Scenario/Experiment declaration.

    With ``backend``, unsupported features are errors; without, only
    scenario-internal problems (compile failures, schedule sanity)
    are reported — a declaration may legitimately target one backend.
    """
    target = getattr(scenario, "name", None) or \
        type(scenario).__name__
    try:
        exp = _compile(scenario)
    except (ValueError, TypeError, KeyError) as e:
        return [CheckFinding(rule="compile", severity="error",
                             target=target,
                             message=f"declaration does not compile: "
                                     f"{e}")]
    findings = []
    if backend is not None:
        findings.extend(capability_findings(exp, backend, target))
    findings.extend(check_schedule(exp, target, dt=dt))
    return findings


def check_sweep(sweep, dt: float = 0.05,
                schedule_points: int = 8) -> list:
    """-> [CheckFinding] for one Sweep declaration.

    Seed collisions over the full task list; capability + schedule
    per point (schedule checks capped at ``schedule_points`` points —
    the load model is per-point work)."""
    from repro_torch.sweep.spec import PointCtx

    target = sweep.name
    findings = list(check_sweep_seeds(sweep, target=target))
    for index, params in enumerate(sweep.point_dicts()):
        seed, stream = sweep.seed_for(index, 0)
        ctx = PointCtx(params=dict(params), index=index, rep=0,
                       seed=seed, stream=stream)
        point_target = f"{target}[{index}]"
        try:
            exp = _compile(sweep.factory(ctx))
        except (ValueError, TypeError, KeyError) as e:
            findings.append(CheckFinding(
                rule="compile", severity="error", target=point_target,
                message=f"point {params} does not compile: {e}"))
            continue
        backend = params.get("runtime", sweep.runtime)
        findings.extend(capability_findings(exp, backend, point_target))
        if index < schedule_points:
            findings.extend(check_schedule(exp, point_target, dt=dt))
    return findings


def has_errors(findings) -> bool:
    return any(f.severity == "error" for f in findings)
