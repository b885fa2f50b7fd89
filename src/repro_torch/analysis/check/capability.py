"""Backend capability matrix for experiment features.

One place that states which backend supports which feature, derived
from the runtimes themselves: the simulator applies every injection
kind (``Simulator.apply_injection``), the engine runtime whitelists
``_ENGINE_INJECTIONS`` and has no hedging or legacy path, and the
vector compiler lowers speed/fail/drain/policy but surfaces hedging
and injection-time joins through ``VectorProgram.unsupported`` and
refuses ``legacy_mode`` outright.  ``python -m repro_torch.analysis check``
uses this to reject a declaration at check time instead of mid-run.

Features are strings: ``injection:<kind>`` for each injection kind,
plus the ``hedge_delay``/``legacy_mode`` experiment flags and the
resilience/control fields (``retry``, ``breaker``, ``control``).

``CAPABILITIES`` is the reference's table, so findings read as the
reference's.  One row depends on the experiment (``capabilities``): the
vector compiler's control pre-pass replays a scalar service's fluid
backlog only, and under a batched service model it surfaces ``control``
as unsupported, so the port's check rejects that pairing on ``vector``
where the reference's passes it.  No registered scenario pairs the two.
"""
from __future__ import annotations

from typing import Optional

BACKENDS = ("sim", "engine", "vector")

INJECTION_KINDS = ("server_fail", "server_speed", "server_join",
                   "server_drain", "set_policy", "set_hedge",
                   "set_admission", "set_scale", "set_retry",
                   "set_breaker")

_ALL = frozenset([f"injection:{k}" for k in INJECTION_KINDS] +
                 ["hedge_delay", "legacy_mode", "retry", "breaker",
                  "control"])

#: feature -> backends supporting it (mirrors the runtime contracts)
CAPABILITIES = {
    "sim": frozenset(_ALL),
    # core/runtime.py _ENGINE_INJECTIONS: join/drain/fail/policy plus the
    # resilience kinds; hedging and legacy mode stay simulator-only
    "engine": frozenset({"injection:server_join",
                         "injection:server_drain",
                         "injection:server_fail",
                         "injection:set_policy",
                         "injection:set_admission",
                         "injection:set_scale",
                         "injection:set_retry",
                         "injection:set_breaker",
                         "retry", "breaker", "control"}),
    # vector/compile.py: hedging, injection-time joins, and per-request
    # retry/breaker mechanics -> unsupported (no fluid analogue);
    # admission/scale lower as thinning + capacity schedules, and the
    # controller replays through the fluid pre-pass
    "vector": frozenset({"injection:server_fail",
                         "injection:server_speed",
                         "injection:server_drain",
                         "injection:set_policy",
                         "injection:set_admission",
                         "injection:set_scale",
                         "control"}),
}


#: the ``Injection.kind`` a runtime records in ``unsupported`` when it
#: skips a flag; an ``injection:<kind>`` feature is recorded as its kind
SKIP_KIND = {"hedge_delay": "set_hedge", "retry": "set_retry",
             "breaker": "set_breaker", "control": "control",
             "legacy_mode": "legacy_mode"}


def skipped_kinds(features) -> set:
    """-> the kinds a runtime's ``unsupported`` holds for these features
    (``unsupported_on``'s names): how the tests and chip_smoke hold the
    matrix against the vector and engine runtimes."""
    return {SKIP_KIND.get(f, f.removeprefix("injection:")) for f in features}


def _batched(exp) -> bool:
    resolve = getattr(exp, "resolved_service", None)
    return resolve is not None and \
        getattr(resolve(), "kind", "scalar") == "batched"


def capabilities(exp) -> dict:
    """-> {backend: features it honors} for this experiment."""
    if _batched(exp):
        return {**CAPABILITIES,
                "vector": CAPABILITIES["vector"] - {"control"}}
    return CAPABILITIES


def required_features(exp) -> list:
    """-> [(feature, human detail)] the experiment needs at runtime."""
    feats = []
    if getattr(exp, "legacy_mode", False):
        feats.append(("legacy_mode", "legacy_mode=True"))
    if getattr(exp, "hedge_delay", None) is not None:
        feats.append(("hedge_delay",
                      f"hedge_delay={exp.hedge_delay:g}s"))
    if getattr(exp, "retry", None) is not None:
        feats.append(("retry", f"retry={exp.retry!r}"))
    if getattr(exp, "breaker", None) is not None:
        feats.append(("breaker", f"breaker={exp.breaker!r}"))
    ctrl = getattr(exp, "control", None)
    if ctrl is not None:
        feats.append(("control",
                      f"control={getattr(ctrl, 'name', ctrl)!s}"))
    for inj in getattr(exp, "injections", ()):
        feats.append((f"injection:{inj.kind}",
                      f"{inj.kind}@{inj.at:g}s"))
    return feats


def unsupported_on(exp, backend: str) -> list:
    """-> [(feature, detail)] the named backend cannot honor."""
    if backend not in CAPABILITIES:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"known: {', '.join(BACKENDS)}")
    caps = capabilities(exp)[backend]
    return [(f, d) for f, d in required_features(exp) if f not in caps]


def support_matrix(exp) -> dict:
    """-> {backend: [(feature, detail) it cannot honor]}."""
    return {b: unsupported_on(exp, b) for b in BACKENDS}


def format_matrix(exp, features: Optional[list] = None) -> str:
    """Render the capability matrix for the experiment's features."""
    feats = features if features is not None else \
        [f for f, _ in required_features(exp)]
    seen: list = []
    for f in feats:
        if f not in seen:
            seen.append(f)
    if not seen:
        return "  (no backend-gated features)"
    caps = capabilities(exp)
    width = max(len(f) for f in seen)
    lines = ["  capability matrix (x = supported):",
             f"    {'feature':<{width}}  " +
             "  ".join(f"{b:>6}" for b in BACKENDS)]
    for f in seen:
        marks = "  ".join(
            f"{'x' if f in caps[b] else '.':>6}"
            for b in BACKENDS)
        lines.append(f"    {f:<{width}}  {marks}")
    return "\n".join(lines)
