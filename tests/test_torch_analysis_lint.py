"""The port's determinism lint (``repro_torch.analysis.lint``) against the
JAX package's (``repro.analysis.lint``).

The port's engine scopes a file by its path after the last ``repro/`` or
``repro_torch/`` segment; the reference's only knows ``repro/``.  So:

* over the shared golden fixtures (``tests/analysis_fixtures/``, read,
  never edited) and over ``src/repro`` the two give the same findings;
* over ``src/repro_torch`` the port gives what the reference gives on a
  copy of that tree placed under a directory named ``repro/`` — the
  port's files fall under the rules' real scopes, where the reference's
  lint, run on them in place, scopes them by bare file name and applies
  only ``seed-from-hash``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis.__main__ import main as ref_main
from repro.analysis.lint import engine as ref_engine
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.lint.engine import (
    SourceFile,
    default_rules,
    exit_code,
    lint_paths,
    lint_text,
    render_json,
    summarize,
)

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
FIXTURES = Path(__file__).parent / "analysis_fixtures"
_MARK = re.compile(r"#\s*F:\s*([a-z0-9-]+)")
FIELDS = ("rule", "severity", "line", "col", "message", "suppressed")


def _fixture_files():
    return sorted(FIXTURES.rglob("*.py"))


def _expected(path: Path) -> set:
    out = set()
    for lineno, line in enumerate(path.read_text().splitlines(), 1):
        for m in _MARK.finditer(line):
            out.add((m.group(1), lineno))
    return out


def _key(f, rel: str = None) -> tuple:
    return (rel if rel is not None else f.path,) + \
        tuple(getattr(f, k) for k in FIELDS)


def test_fixture_corpus_is_whole():
    names = {p.name for p in _fixture_files()}
    assert len(names) == 22
    for rule in default_rules():
        assert {f"{rule.name}_flag.py", f"{rule.name}_ok.py"} <= names


@pytest.mark.parametrize("path", _fixture_files(),
                         ids=lambda p: str(p.relative_to(FIXTURES)))
def test_fixture_findings_equal_reference_and_markers(path):
    got = lint_paths([str(path)])
    want = ref_engine.lint_paths([str(path)])
    assert [_key(f) for f in got] == [_key(f) for f in want]
    assert {(f.rule, f.line) for f in got if not f.suppressed} == \
        _expected(path)


def test_rule_catalogue_equals_reference():
    got = [(r.name, r.severity, r.description, r.scope)
           for r in default_rules()]
    want = [(r.name, r.severity, r.description, r.scope)
            for r in ref_engine.default_rules()]
    assert got == want
    assert len(got) == 10


def test_port_tree_scopes_as_reference_on_a_repro_copy(tmp_path):
    """The reference's lint on ``src/repro_torch`` copied to ``repro/``
    equals the port's lint on the tree in place, finding for finding."""
    port = SRC / "repro_torch"
    copy = tmp_path / "repro"
    shutil.copytree(port, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    want = [_key(f, os.path.relpath(f.path, copy))
            for f in ref_engine.lint_paths([str(copy)])]
    got = [_key(f, os.path.relpath(f.path, port))
           for f in lint_paths([str(port)])]
    assert got == want
    assert [k for k in got if not k[-1]] == []
    assert {k[1] for k in got} == {"broad-except"}
    assert {k[0] for k in got} == {"cache/store.py", "sweep/executor.py"}
    # in place, the reference scopes the port's files by bare name: none
    # of the suppressed findings above is even seen
    assert ref_engine.lint_paths([str(port)]) == []


def test_reference_tree_findings_equal_reference():
    tree = str(SRC / "repro")
    got = lint_paths([tree])
    want = ref_engine.lint_paths([tree])
    assert [_key(f) for f in got] == [_key(f) for f in want]
    assert summarize(got)["suppressed"] >= 6


@pytest.mark.parametrize("path,text,rel", [
    ("/x/src/repro_torch/cache/store.py", "", "cache/store.py"),
    ("/x/repro/src/repro_torch/core/a.py", "", "core/a.py"),
    ("/x/repro_torch/src/repro/vector/b.py", "", "vector/b.py"),
    ("/x/src/repro/core/c.py", "", "core/c.py"),
    ("/x/src/repro_torch/core/d.py", "# lint-path: figures/d.py\n",
     "figures/d.py"),
    ("/x/lib/tools/e.py", "", "e.py"),
    ("/x/src/repro_torch", "", "repro_torch"),
], ids=["port", "both-port-last", "both-repro-last", "reference",
        "directive", "neither", "root-only"])
def test_infer_rel(path, text, rel):
    assert SourceFile(path, text).rel == rel


def test_port_source_is_clean_under_strict():
    findings = lint_paths([str(SRC / "repro_torch")])
    active = [f for f in findings if not f.suppressed]
    assert active == [], "\n".join(f.format() for f in active)
    assert exit_code(findings, strict=True) == 0
    assert summarize(findings)["suppressed"] >= 11
    # the analysis package itself is in scope and clean
    assert SourceFile(str(SRC / "repro_torch/analysis/__main__.py"),
                      "").rel == "analysis/__main__.py"


# ---------------------------------------------------------------------------
# Engine mechanics (the reference's cases, on the port's engine)
# ---------------------------------------------------------------------------
SNIPPET = """\
import numpy as np


def build():
    return np.random.default_rng()
"""


def test_suppression_by_rule_name():
    text = SNIPPET.replace(
        "np.random.default_rng()",
        "np.random.default_rng()  # repro: noqa[unseeded-rng]")
    findings = lint_text(text, rel="core/x.py")
    assert [f.rule for f in findings] == ["unseeded-rng"]
    assert findings[0].suppressed


def test_blanket_suppression_and_wrong_name():
    blanket = SNIPPET.replace("default_rng()",
                              "default_rng()  # repro: noqa")
    assert all(f.suppressed for f in lint_text(blanket, rel="core/x.py"))
    wrong = SNIPPET.replace(
        "default_rng()", "default_rng()  # repro: noqa[broad-except]")
    findings = lint_text(wrong, rel="core/x.py")
    assert findings and not findings[0].suppressed


def test_scope_gating_via_rel_path():
    assert lint_text(SNIPPET, rel="core/x.py")
    assert not lint_text(SNIPPET, rel="figures/x.py")


def test_exit_code_and_strict():
    errors = lint_text(SNIPPET, rel="core/x.py")
    assert exit_code(errors) == 1
    warn_only = lint_text(
        "import numpy as np\nrng = np.random.default_rng(7)\n",
        rel="core/x.py")
    assert {f.severity for f in warn_only} == {"warning"}
    assert exit_code(warn_only) == 0
    assert exit_code(warn_only, strict=True) == 1
    suppressed = lint_text(
        SNIPPET.replace("default_rng()",
                        "default_rng()  # repro: noqa"),
        rel="core/x.py")
    assert exit_code(suppressed, strict=True) == 0
    assert summarize(suppressed)["suppressed"] == 1


def test_json_output_round_trips():
    findings = lint_text(SNIPPET, rel="core/x.py")
    doc = json.loads(render_json(findings))
    assert doc["summary"]["errors"] == 1
    assert doc["findings"][0]["rule"] == "unseeded-rng"
    ref = ref_engine.lint_text(SNIPPET, rel="core/x.py")
    assert doc == json.loads(ref_engine.render_json(ref))


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_lint_matches_reference(capsys, tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("# lint-path: core/bad.py\n"
                   "import random\n")
    for argv in (["lint", str(bad)], ["--json", str(bad)],
                 ["lint", "--show-suppressed", str(SRC / "repro_torch")]):
        rc = main(argv)
        out = capsys.readouterr().out
        ref_rc = ref_main(argv)
        ref_out = capsys.readouterr().out
        if "--show-suppressed" in argv:
            # the reference scopes the port's files by bare name
            assert rc == 0 and ref_out.strip() == \
                "0 error(s), 0 warning(s), 0 suppressed"
            assert out.strip().endswith(
                "0 error(s), 0 warning(s), 11 suppressed")
        else:
            assert (rc, out) == (ref_rc, ref_out) and rc == 1
            assert "stdlib-random" in out


def test_cli_list_rules_equals_reference(capsys):
    """``python -m repro_torch.analysis lint --list-rules`` in a
    subprocess: the reference's catalogue, line for line."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "lint",
         "--list-rules"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert ref_main(["lint", "--list-rules"]) == 0
    assert out.stdout == capsys.readouterr().out
    for rule in default_rules():
        assert rule.name in out.stdout
