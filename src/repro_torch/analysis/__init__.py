"""Static analysis for the repro codebase: determinism lint + spec checks.

The port's copy of ``repro.analysis``.  The lint scopes a file by its
path after the last ``repro/`` or ``repro_torch/`` segment, so the
port's modules fall under the same rules as the JAX package's; the
checks run on the port's scenarios, sweeps and vector compiler, and
their capability matrix is held against the port's runtimes.

Two layers, one CLI (``python -m repro_torch.analysis``):

``repro_torch.analysis.lint``
    An AST rule engine over the repo's own source.  Each rule targets a
    bug class this project has actually shipped and later fixed by hand
    (process-dependent ``hash()`` seeding, collapsed per-repetition RNG
    streams, wall-clock reads inside simulated time, stripped
    ``assert`` invariants, silent broad excepts, jax purity hazards in
    traced bodies).  Findings are suppressible inline with
    ``# repro: noqa[RULE]``.

``repro_torch.analysis.check``
    Static validators over ``Scenario``/``Sweep``/``Experiment``
    declarations: a backend capability matrix (unsupported injections
    fail at check time, not mid-run), seed-collision detection across
    sweep axes, and schedule sanity (offered load, horizon coverage).
"""
from repro_torch.analysis.check import (  # noqa: F401
    CheckFinding,
    check_scenario,
    check_sweep,
)
from repro_torch.analysis.lint.engine import (  # noqa: F401
    Finding,
    Rule,
    SourceFile,
    lint_paths,
    lint_text,
)
