"""AST determinism/purity linter: engine + rule catalogue."""
from repro_torch.analysis.lint.engine import (  # noqa: F401
    Finding,
    Rule,
    SourceFile,
    default_rules,
    lint_paths,
    lint_text,
)
