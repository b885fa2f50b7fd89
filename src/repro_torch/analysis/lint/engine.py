"""Rule engine for the determinism/purity linter.

Copy of ``repro.analysis.lint.engine``; the one change is the scoping
root, which may be ``repro_torch`` as well as ``repro`` (see below).

The engine owns everything that is not rule logic: walking files,
parsing, inline ``# repro: noqa[RULE]`` suppressions, severity
accounting, and human/JSON rendering.  Rules are small classes with a
``check(source_file)`` generator yielding ``(node, message)`` pairs —
see ``rules.py`` and ``jaxrules.py`` for the catalogue.

Scoping: every rule declares the repo-relative path prefixes it
applies to (``scope=None`` means all files).  The relative path is the
portion after the last package root segment of the file path
(``PACKAGE_ROOTS``: ``repro/`` or ``repro_torch/``), so
``src/repro_torch/cache/store.py`` scopes as ``cache/store.py``, the
port's files fall under the same rules as the JAX package's, and the
engine works from any checkout location; fixture files may override it
with a ``# lint-path: core/whatever.py`` directive on any line, which
lets the golden-file tests exercise path-scoped rules from ``tests/``.

Suppression: ``# repro: noqa[rule-a,rule-b]`` on the finding's line
suppresses those rules there; ``# repro: noqa`` (no bracket) blankets
the line.  Suppressed findings stay visible with ``--show-suppressed``
and in the JSON output — they are audit trail, not deletion.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import asdict, dataclass
from typing import Iterable, Iterator, Optional, Sequence

SEVERITIES = ("warning", "error")

_NOQA_RE = re.compile(r"#\s*repro:\s*noqa(?:\[([^\]]*)\])?")
_PATH_RE = re.compile(r"^#\s*lint-path:\s*(\S+)", re.MULTILINE)
#: path segments under which a file's scope path starts
PACKAGE_ROOTS = ("repro", "repro_torch")


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""
    rule: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    suppressed: bool = False

    def format(self) -> str:
        tail = "  [suppressed]" if self.suppressed else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity}: {self.rule}: {self.message}{tail}")

    def to_dict(self) -> dict:
        return asdict(self)


class Rule:
    """Base class for lint rules.

    Subclasses set ``name`` (the kebab-case id used in ``noqa[...]``),
    ``severity`` (``"error"`` or ``"warning"``), ``description`` (one
    line, shown by ``--list-rules``) and ``scope`` (tuple of rel-path
    prefixes, or ``None`` for every file), and implement ``check``.
    """
    name: str = ""
    severity: str = "error"
    description: str = ""
    scope: Optional[tuple] = None

    def applies_to(self, sf: "SourceFile") -> bool:
        if self.scope is None:
            return True
        return sf.rel.startswith(tuple(self.scope))

    def check(self, sf: "SourceFile") -> Iterator[tuple]:
        """Yield ``(node, message)`` pairs for each violation."""
        raise NotImplementedError


class SourceFile:
    """A parsed source file plus its suppression and scoping metadata."""

    def __init__(self, path: str, text: str, rel: Optional[str] = None):
        self.path = path
        self.text = text
        self.tree = ast.parse(text, filename=path)
        self.rel = rel if rel is not None else self._infer_rel(path, text)
        # line -> None (blanket) | frozenset of rule names
        self.noqa: dict = {}
        for lineno, line in enumerate(text.splitlines(), start=1):
            m = _NOQA_RE.search(line)
            if not m:
                continue
            names = m.group(1)
            if names is None:
                self.noqa[lineno] = None
            else:
                self.noqa[lineno] = frozenset(
                    n.strip() for n in names.split(",") if n.strip())

    @staticmethod
    def _infer_rel(path: str, text: str) -> str:
        m = _PATH_RE.search(text)
        if m:
            return m.group(1)
        parts = os.path.abspath(path).replace(os.sep, "/").split("/")
        roots = [i for i, seg in enumerate(parts) if seg in PACKAGE_ROOTS]
        if roots:
            rel = "/".join(parts[roots[-1] + 1:])
            if rel:
                return rel
        return parts[-1]

    def suppresses(self, rule_name: str, line: int) -> bool:
        if line not in self.noqa:
            return False
        names = self.noqa[line]
        return names is None or rule_name in names


def default_rules() -> list:
    """The full rule catalogue (lazy import: rules depend on Rule)."""
    from repro_torch.analysis.lint import jaxrules, rules
    return list(rules.RULES) + list(jaxrules.RULES)


def iter_python_files(paths: Iterable[str]) -> list:
    out = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for f in sorted(files):
                    if f.endswith(".py"):
                        out.append(os.path.join(root, f))
        elif p.endswith(".py"):
            out.append(p)
    return out


def lint_source(sf: SourceFile, rules: Optional[Sequence[Rule]] = None,
                ) -> list:
    """All findings (suppressed ones included, marked) for one file."""
    if rules is None:
        rules = default_rules()
    findings = []
    for rule in rules:
        if not rule.applies_to(sf):
            continue
        for node, message in rule.check(sf):
            line = getattr(node, "lineno", 1)
            col = getattr(node, "col_offset", 0)
            findings.append(Finding(
                rule=rule.name, severity=rule.severity, path=sf.path,
                line=line, col=col, message=message,
                suppressed=sf.suppresses(rule.name, line)))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_text(text: str, rel: Optional[str] = None, path: str = "<text>",
              rules: Optional[Sequence[Rule]] = None) -> list:
    return lint_source(SourceFile(path, text, rel=rel), rules=rules)


def lint_paths(paths: Iterable[str],
               rules: Optional[Sequence[Rule]] = None) -> list:
    if rules is None:
        rules = default_rules()
    findings = []
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        try:
            sf = SourceFile(path, text)
        except SyntaxError as e:
            findings.append(Finding(
                rule="syntax-error", severity="error", path=path,
                line=e.lineno or 1, col=e.offset or 0,
                message=f"cannot parse: {e.msg}"))
            continue
        findings.extend(lint_source(sf, rules=rules))
    return findings


def summarize(findings: Sequence[Finding]) -> dict:
    active = [f for f in findings if not f.suppressed]
    return {
        "errors": sum(1 for f in active if f.severity == "error"),
        "warnings": sum(1 for f in active if f.severity == "warning"),
        "suppressed": sum(1 for f in findings if f.suppressed),
    }


def render_human(findings: Sequence[Finding],
                 show_suppressed: bool = False) -> str:
    lines = [f.format() for f in findings
             if show_suppressed or not f.suppressed]
    s = summarize(findings)
    lines.append(f"{s['errors']} error(s), {s['warnings']} warning(s), "
                 f"{s['suppressed']} suppressed")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding]) -> str:
    return json.dumps({"findings": [f.to_dict() for f in findings],
                       "summary": summarize(findings)}, indent=2)


def exit_code(findings: Sequence[Finding], strict: bool = False) -> int:
    s = summarize(findings)
    if s["errors"] or (strict and s["warnings"]):
        return 1
    return 0
