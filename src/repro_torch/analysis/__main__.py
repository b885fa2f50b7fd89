"""Static analysis CLI: determinism lint + spec checks.

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch   # lint
    PYTHONPATH=src python -m repro_torch.analysis --strict src/repro_torch
    PYTHONPATH=src python -m repro_torch.analysis lint --list-rules
    PYTHONPATH=src python -m repro_torch.analysis lint --json src/repro_torch/core
    PYTHONPATH=src python -m repro_torch.analysis check          # all specs
    PYTHONPATH=src python -m repro_torch.analysis check \
        --scenario churn-storm --backend vector                 # rejects
    PYTHONPATH=src python -m repro_torch.analysis check --sweep-file s.json

``lint`` (the default subcommand) runs the AST rule catalogue over the
given paths and exits 1 on unsuppressed errors (``--strict`` also
fails warnings).  ``check`` validates declarations without running
them: all registered canonical scenarios and the built-in named sweep
by default, or one scenario against one backend with ``--scenario``/
``--backend`` — where an unsupported injection is a check-time error
with the full capability matrix.  Both run on the host and need no
card: ``check`` compiles declarations with the vector compiler's host
NumPy lowering and runs nothing.  The default ``check`` covers every
scenario registered in ``repro_torch.scenarios`` and the sweep CLI's
built-in smoke sweep (``repro_torch.sweep.__main__.SMOKE``).
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.analysis.lint.engine import (
    default_rules,
    exit_code,
    lint_paths,
    render_human,
    render_json,
)


def _lint_main(argv) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis lint",
        description="AST determinism/purity linter")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: src)")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail the exit code")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="print suppressed findings too")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalogue and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in default_rules():
            scope = ",".join(rule.scope) if rule.scope else "all files"
            print(f"{rule.name:<24} {rule.severity:<8} [{scope}]")
            print(f"{'':<24} {rule.description}")
        return 0

    paths = args.paths or ["src"]
    findings = lint_paths(paths)
    if args.as_json:
        print(render_json(findings))
    else:
        print(render_human(findings,
                           show_suppressed=args.show_suppressed))
    return exit_code(findings, strict=args.strict)


def _iter_default_sweeps():
    """The repo's named sweeps: today, the built-in CI smoke grid."""
    from repro_torch.sweep.__main__ import SMOKE, _sweep_from_decl
    yield _sweep_from_decl(dict(SMOKE))


def _check_main(argv) -> int:
    from repro_torch.analysis.check import (
        check_scenario,
        check_sweep,
        has_errors,
    )

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis check",
        description="static spec validation (no simulation runs)")
    ap.add_argument("--scenario", action="append", default=[],
                    metavar="NAME",
                    help="canonical scenario to validate (repeatable; "
                         "default: all registered)")
    ap.add_argument("--backend", default=None,
                    choices=["sim", "engine", "vector"],
                    help="target backend: unsupported features become "
                         "check-time errors")
    ap.add_argument("--sweep-file", action="append", default=[],
                    metavar="FILE",
                    help="JSON/YAML sweep declaration to validate")
    ap.add_argument("--strict", action="store_true",
                    help="warnings also fail the exit code")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    from repro_torch import scenarios

    findings = []
    names = args.scenario or list(scenarios.names())
    for name in names:
        try:
            scn = scenarios.get(name)
        except KeyError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        findings.extend(check_scenario(scn, backend=args.backend))

    if args.sweep_file:
        from repro_torch.sweep.__main__ import _load_file, _sweep_from_decl
        for path in args.sweep_file:
            findings.extend(check_sweep(_sweep_from_decl(
                _load_file(path))))
    elif not args.scenario:
        # default mode also validates the repo's named sweeps
        for sweep in _iter_default_sweeps():
            findings.extend(check_sweep(sweep))

    errors = sum(1 for f in findings if f.severity == "error")
    warnings = sum(1 for f in findings if f.severity == "warning")
    if args.as_json:
        print(json.dumps({"findings": [f.to_dict() for f in findings],
                          "summary": {"errors": errors,
                                      "warnings": warnings}},
                         indent=2))
    else:
        for f in findings:
            print(f.format())
        checked = len(names) + (len(args.sweep_file) or
                                (0 if args.scenario else 1))
        print(f"checked {checked} declaration(s): {errors} error(s), "
              f"{warnings} warning(s)")
    if has_errors(findings) or (args.strict and warnings):
        return 1
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "check":
        return _check_main(argv[1:])
    if argv and argv[0] == "lint":
        argv = argv[1:]
    return _lint_main(argv)


if __name__ == "__main__":
    sys.exit(main())
