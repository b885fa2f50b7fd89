"""General determinism rules: seeding, randomness, clocks, invariants.

Copy of ``repro.analysis.lint.rules``: the same seven rules, names,
severities, descriptions, scopes and messages.  Each rule mirrors a bug
class the JAX package shipped and later fixed by hand: process-dependent
``hash(app)`` seeding, per-repetition RNG streams collapsing confidence
intervals, silent backend divergence behind broad excepts.  The scope of
the measurement-path rules is the set of packages whose code runs
inside an experiment: ``core``, ``vector``, ``sweep``, ``scenarios``,
``serving`` — plus ``analysis`` itself, so the linter eats its own
dogfood.  The engine scopes ``src/repro_torch/<pkg>/...`` as
``<pkg>/...``, so the port's packages fall under the same scopes.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.lint.engine import Rule, SourceFile

#: packages whose code executes inside a measurement
MEASUREMENT_SCOPE = ("core/", "vector/", "sweep/", "scenarios/",
                     "serving/", "analysis/", "plan/", "cache/")

#: call suffixes that consume a seed as their first positional argument
SEED_SINK_SUFFIXES = ("default_rng", "SeedSequence", "RandomState",
                      "PRNGKey", "Random")

#: draws on numpy's hidden module-level global RNG
NP_GLOBAL_DRAWS = ("rand", "randn", "randint", "random", "choice",
                   "shuffle", "permutation", "uniform", "normal",
                   "exponential", "lognormal", "poisson")

WALLCLOCK_CALLS = ("time.time", "time.monotonic", "time.perf_counter",
                   "time.time_ns", "time.monotonic_ns",
                   "time.perf_counter_ns", "datetime.now",
                   "datetime.utcnow", "datetime.datetime.now",
                   "datetime.datetime.utcnow")


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _call_name(node: ast.Call) -> Optional[str]:
    return dotted_name(node.func)


def _is_seed_sink(name: Optional[str]) -> bool:
    return bool(name) and name.split(".")[-1] in SEED_SINK_SUFFIXES


def _contains_hash_call(node: ast.AST) -> Optional[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and \
                isinstance(sub.func, ast.Name) and \
                sub.func.id in ("hash", "id"):
            return sub
    return None


class SeedFromHash(Rule):
    """``hash()``/``id()`` feeding a seed — both are process-dependent
    (PYTHONHASHSEED / allocator), so 'seeded' runs silently diverge
    across processes.  The shipped instance was ``hash(app)`` in the
    client-seed derivation, fixed with ``zlib.crc32``."""
    name = "seed-from-hash"
    severity = "error"
    description = ("hash()/id() used in seed derivation "
                   "(process-dependent; use zlib.crc32 or SeedSequence)")
    scope = None

    def check(self, sf: SourceFile) -> Iterator[tuple]:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                name = _call_name(node)
                seedish = _is_seed_sink(name) or \
                    (name is not None and "seed" in name.split(".")[-1]
                     .lower())
                if seedish:
                    for arg in list(node.args) + \
                            [kw.value for kw in node.keywords]:
                        bad = _contains_hash_call(arg)
                        if bad is not None:
                            fn = bad.func.id  # type: ignore[union-attr]
                            yield bad, (f"{fn}() result feeds "
                                        f"{name}() — process-dependent "
                                        f"seeding (use zlib.crc32 or a "
                                        f"SeedSequence spawn key)")
                else:
                    for kw in node.keywords:
                        if kw.arg and "seed" in kw.arg.lower():
                            bad = _contains_hash_call(kw.value)
                            if bad is not None:
                                fn = bad.func.id  # type: ignore
                                yield bad, (f"{fn}() result feeds "
                                            f"{kw.arg}= — process-"
                                            f"dependent seeding")
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                named_seed = any(
                    isinstance(t, ast.Name) and "seed" in t.id.lower()
                    for t in targets)
                if named_seed and node.value is not None:
                    bad = _contains_hash_call(node.value)
                    if bad is not None:
                        fn = bad.func.id  # type: ignore[union-attr]
                        yield bad, (f"{fn}() assigned to a seed "
                                    f"variable — process-dependent")


class StdlibRandom(Rule):
    """stdlib ``random`` in a measurement path.  Its global state leaks
    across components and it cannot thread the repo's
    ``(seed, entity_id, rep)`` tuple convention; use a
    ``np.random.Generator`` keyed by that tuple instead."""
    name = "stdlib-random"
    severity = "error"
    description = ("stdlib random in measurement code "
                   "(use seeded np.random.Generator)")
    scope = MEASUREMENT_SCOPE

    def check(self, sf: SourceFile) -> Iterator[tuple]:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "random":
                        yield node, ("stdlib 'random' imported in a "
                                     "measurement path — use a seeded "
                                     "np.random.Generator")
            elif isinstance(node, ast.ImportFrom):
                if node.module == "random" and node.level == 0:
                    yield node, ("stdlib 'random' imported in a "
                                 "measurement path — use a seeded "
                                 "np.random.Generator")


class UnseededRng(Rule):
    """RNG constructed from OS entropy (or the hidden numpy global
    stream) inside measurement code: repetitions become unreproducible
    and statistically untrackable.  The shipped instance was fresh
    ``default_rng()`` per repetition collapsing CIs."""
    name = "unseeded-rng"
    severity = "error"
    description = ("unseeded RNG / numpy global-stream draw in "
                   "measurement code")
    scope = MEASUREMENT_SCOPE

    def check(self, sf: SourceFile) -> Iterator[tuple]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name is None:
                continue
            leaf = name.split(".")[-1]
            if leaf in ("default_rng", "SeedSequence") and \
                    not node.args and not node.keywords:
                yield node, (f"{leaf}() without a seed draws OS "
                             f"entropy — thread the (seed, entity_id, "
                             f"rep) tuple")
            elif name in ("np.random.seed", "numpy.random.seed",
                          "random.seed"):
                yield node, (f"{name}() mutates a hidden global "
                             f"stream — construct a Generator instead")
            elif name.startswith(("np.random.", "numpy.random.")) and \
                    leaf in NP_GLOBAL_DRAWS:
                yield node, (f"{name}() draws from numpy's global "
                             f"RNG — draw from a seeded Generator")


class SeedConvention(Rule):
    """Seed sinks taking a bare integer literal or ad-hoc arithmetic.
    Arithmetic like ``seed + 1000*(rep+1)`` collides across sweep
    points; constants silently share one stream between entities.  The
    repo's convention is a tuple ``(domain_tag, seed, entity_id, rep)``
    or a ``SeedSequence`` spawn key."""
    name = "seed-convention"
    severity = "warning"
    description = ("seed sink fed a bare literal or seed arithmetic "
                   "instead of the (seed, entity_id, rep) tuple")
    scope = MEASUREMENT_SCOPE

    def check(self, sf: SourceFile) -> Iterator[tuple]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if not _is_seed_sink(name) or not node.args:
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and \
                    isinstance(arg.value, int) and \
                    not isinstance(arg.value, bool):
                yield arg, (f"{name}({arg.value!r}): constant seed "
                            f"shares one stream across entities/reps — "
                            f"key by (seed, entity_id, rep)")
            elif isinstance(arg, ast.BinOp):
                yield arg, (f"{name}(...): ad-hoc seed arithmetic "
                            f"collides across sweep points — use a "
                            f"tuple seed or SeedSequence spawn key")


class WallclockInSim(Rule):
    """Wall-clock reads inside simulated-time code: latencies become a
    function of host load, not of the model.  Real-time backends must
    take an injectable ``clock`` callable (the engine runtime does)."""
    name = "wallclock-in-sim"
    severity = "error"
    description = ("wall-clock call in a simulated path "
                   "(inject a clock callable)")
    scope = ("core/", "vector/", "sweep/", "scenarios/", "analysis/",
             "plan/", "cache/")

    def check(self, sf: SourceFile) -> Iterator[tuple]:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                name = _call_name(node)
                if name in WALLCLOCK_CALLS:
                    yield node, (f"{name}() reads the wall clock in "
                                 f"simulated code — time must come "
                                 f"from the virtual clock")


class AssertInvariant(Rule):
    """``assert`` guarding a runtime invariant in non-test code:
    ``python -O`` strips it, so the guard silently vanishes exactly
    when someone optimizes a long sweep.  Raise ``RuntimeError`` /
    ``ValueError`` instead."""
    name = "assert-invariant"
    severity = "error"
    description = ("assert as runtime invariant in non-test code "
                   "(stripped under python -O)")
    scope = MEASUREMENT_SCOPE

    def check(self, sf: SourceFile) -> Iterator[tuple]:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assert):
                yield node, ("assert is stripped under python -O — "
                             "raise RuntimeError/ValueError for "
                             "runtime invariants")


class BroadExcept(Rule):
    """Bare ``except`` / ``except Exception`` outside the documented
    error-row contract.  A silently noise-free engine backend once hid
    behind exactly this shape; the sweep executor's error-row sites
    are the sanctioned exception and carry explicit suppressions."""
    name = "broad-except"
    severity = "error"
    description = ("bare/broad except outside the error-row contract "
                   "(catch the specific exception)")
    scope = MEASUREMENT_SCOPE

    def check(self, sf: SourceFile) -> Iterator[tuple]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if node.type is None:
                yield node, ("bare except swallows everything "
                             "(including KeyboardInterrupt) — name "
                             "the exception")
                continue
            types = node.type.elts if isinstance(node.type, ast.Tuple) \
                else [node.type]
            for t in types:
                name = dotted_name(t)
                if name in ("Exception", "BaseException"):
                    yield node, (f"except {name} hides unrelated "
                                 f"failures — catch the specific "
                                 f"exception (error-row sites carry "
                                 f"an explicit noqa)")
                    break


RULES = (SeedFromHash(), StdlibRandom(), UnseededRng(), SeedConvention(),
         WallclockInSim(), AssertInvariant(), BroadExcept())
