"""jax purity rules for traced bodies in ``vector/``, ``plan/`` and the
vector Pallas kernels.

Copy of ``repro.analysis.lint.jaxrules``, rule for rule.  These are AST
rules and import nothing of JAX: they are kept so that the port's CLI
gives the reference's findings on any tree, the JAX package's included.
The port's own modules hold no traced body (no ``jit``, ``lax.scan``,
``pallas_call`` or autodiff call site, no ``(carry, xs)`` scan body), so
over ``src/repro_torch`` these rules find nothing to check.

A function body is considered *traced* when any of these hold:

* it is decorated with ``jit`` / ``jax.jit`` (or a ``partial`` of it);
* it is passed syntactically to ``lax.scan`` / ``jax.lax.scan`` /
  ``jax.jit`` / ``pl.pallas_call`` / ``jax.grad`` /
  ``jax.value_and_grad`` at a call site in the same file — a body
  handed to the autodiff tracers is traced exactly like a jitted one,
  which is how the planner's loss closures get covered;
* it follows the repo's scan-body convention: a (possibly nested)
  function whose parameters are exactly ``(carry, xs)`` — the shape
  ``_scalar_step``/``_batched_step`` build and hand to ``lax.scan``.

Inside a traced body the rules track a taint set seeded from the
traced parameters and propagated through simple assignments: Python
control flow on a traced value retraces or crashes under jit
(``jit-python-branch``), ``.item()``/``float()``/``int()``/``bool()``
forces concretization (``jit-concretize``), and writes to captured
state escape the trace and silently desynchronize
(``jit-captured-mutation``).
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from repro_torch.analysis.lint.engine import Rule, SourceFile
from repro_torch.analysis.lint.rules import dotted_name

VECTOR_SCOPE = ("vector/", "plan/", "kernels/vector_step.py",
                "kernels/vector_quantiles.py")

SCAN_CALLS = ("lax.scan", "jax.lax.scan")
JIT_CALLS = ("jit", "jax.jit")
#: a Pallas kernel body is a traced function too — same purity rules
PALLAS_CALLS = ("pl.pallas_call", "pallas_call", "pallas.pallas_call")
#: ...and so is anything handed to the autodiff tracers
GRAD_CALLS = ("jax.grad", "grad", "jax.value_and_grad", "value_and_grad")
CONCRETIZE_BUILTINS = ("float", "int", "bool")


def _param_names(fn: ast.AST) -> list:
    args = fn.args
    names = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    if args.kwarg:
        names.append(args.kwarg.arg)
    return names


def _is_jit_decorated(fn: ast.AST) -> bool:
    for dec in fn.decorator_list:
        name = dotted_name(dec)
        if name in JIT_CALLS:
            return True
        if isinstance(dec, ast.Call):
            cname = dotted_name(dec.func)
            if cname in JIT_CALLS:
                return True
            if cname in ("partial", "functools.partial") and dec.args:
                if dotted_name(dec.args[0]) in JIT_CALLS:
                    return True
    return False


def _traced_callee_names(tree: ast.AST) -> Set[str]:
    """Function names passed as the body argument of scan/jit calls."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        name = dotted_name(node.func)
        if name in SCAN_CALLS + JIT_CALLS + PALLAS_CALLS + GRAD_CALLS:
            first = dotted_name(node.args[0])
            if first is not None:
                out.add(first.split(".")[-1])
    return out


def iter_traced_functions(sf: SourceFile) -> Iterator[ast.AST]:
    by_call = _traced_callee_names(sf.tree)
    for node in ast.walk(sf.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = _param_names(node)
        if _is_jit_decorated(node) or node.name in by_call or \
                params[:2] == ["carry", "xs"]:
            yield node


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _assigned_names(target: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            out.add(n.id)
    return out


def taint_set(fn: ast.AST) -> Set[str]:
    """Traced parameters plus names assigned from tainted values,
    propagated to a fixpoint (flow-insensitive, per function)."""
    tainted: Set[str] = set(_param_names(fn))
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                value = node.value
                if value is None:
                    continue
                if _names_in(value) & tainted:
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for t in targets:
                        new = _assigned_names(t) - tainted
                        if new:
                            tainted |= new
                            changed = True
    return tainted


def _local_names(fn: ast.AST) -> Set[str]:
    out = set(_param_names(fn))
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                out |= _assigned_names(t)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            out |= _assigned_names(node.target)
        elif isinstance(node, ast.withitem) and node.optional_vars:
            out |= _assigned_names(node.optional_vars)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
    return out


class _TracedRule(Rule):
    scope = VECTOR_SCOPE

    def check(self, sf: SourceFile) -> Iterator[tuple]:
        for fn in iter_traced_functions(sf):
            tainted = taint_set(fn)
            yield from self.check_traced(fn, tainted)

    def check_traced(self, fn: ast.AST, tainted: Set[str],
                     ) -> Iterator[tuple]:
        raise NotImplementedError


class JitPythonBranch(_TracedRule):
    """Python ``if``/``while`` on a traced value inside a jit/scan
    body: the branch is resolved at trace time, so every execution
    replays one arm (or jit raises a ConcretizationTypeError).  Use
    ``jnp.where`` / ``lax.cond`` / ``lax.select``."""
    name = "jit-python-branch"
    severity = "error"
    description = ("Python control flow on a traced value in a "
                   "jit/scan body (use jnp.where/lax.cond)")

    def check_traced(self, fn: ast.AST, tainted: Set[str],
                     ) -> Iterator[tuple]:
        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                if _names_in(node.test) & tainted:
                    kind = {ast.If: "if", ast.While: "while",
                            ast.IfExp: "conditional expression"}[
                                type(node)]
                    yield node, (f"Python {kind} on a traced value "
                                 f"inside a traced body — use "
                                 f"jnp.where or lax.cond")
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                if _names_in(node.iter) & tainted:
                    yield node, ("Python loop over a traced value "
                                 "inside a traced body — use "
                                 "lax.scan/fori_loop")


class JitConcretize(_TracedRule):
    """``.item()`` / ``float()`` / ``int()`` / ``bool()`` on a traced
    value forces host concretization — a tracer error under jit, a
    silent recompile outside it."""
    name = "jit-concretize"
    severity = "error"
    description = (".item()/float()/int()/bool() on a traced value "
                   "in a jit/scan body")

    def check_traced(self, fn: ast.AST, tainted: Set[str],
                     ) -> Iterator[tuple]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "item" and \
                    _names_in(node.func.value) & tainted:
                yield node, (".item() concretizes a traced value — "
                             "keep it an array")
            elif isinstance(node.func, ast.Name) and \
                    node.func.id in CONCRETIZE_BUILTINS and node.args and \
                    _names_in(node.args[0]) & tainted:
                yield node, (f"{node.func.id}() concretizes a traced "
                             f"value — keep it an array")


class JitCapturedMutation(_TracedRule):
    """Writes to state captured from an enclosing scope inside a
    traced body: the mutation happens once at trace time, then never
    again — the classic silent-desync hazard."""
    name = "jit-captured-mutation"
    severity = "error"
    description = ("mutation of captured state inside a jit/scan "
                   "body (thread it through the carry)")

    MUTATORS = ("append", "extend", "insert", "add", "update", "pop",
                "remove", "clear", "setdefault")

    def check_traced(self, fn: ast.AST, tainted: Set[str],
                     ) -> Iterator[tuple]:
        local = _local_names(fn)
        for node in ast.walk(fn):
            if isinstance(node, (ast.Global, ast.Nonlocal)):
                kind = "global" if isinstance(node, ast.Global) \
                    else "nonlocal"
                yield node, (f"{kind} write inside a traced body "
                             f"mutates captured state — thread it "
                             f"through the carry")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    base = self._base_name(t)
                    if base is not None and base not in local:
                        yield node, (f"write to captured "
                                     f"{base!r} inside a traced body "
                                     f"— thread it through the carry")
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in self.MUTATORS:
                base = dotted_name(node.func.value)
                if base is not None and \
                        base.split(".")[0] not in local:
                    yield node, (f"{base}.{node.func.attr}() mutates "
                                 f"captured state inside a traced "
                                 f"body")

    @staticmethod
    def _base_name(target: ast.AST) -> Optional[str]:
        node = target
        while isinstance(node, (ast.Attribute, ast.Subscript)):
            node = node.value
        if isinstance(node, ast.Name) and node is not target:
            return node.id
        return None


RULES = (JitPythonBranch(), JitConcretize(), JitCapturedMutation())
