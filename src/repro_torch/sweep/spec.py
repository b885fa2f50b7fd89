"""Sweep specification: axes, points, repetitions, seeds, metrics.

Copy of ``repro.sweep.spec``.  A ``Sweep`` declares WHAT to run — a
parameter grid over ``Experiment``/``Scenario`` builders, how many
seeded repetitions per point, and which metrics to extract — and leaves
HOW to run it to ``repro_torch.sweep.executor`` (serial or
process-parallel, identical results either way; vector tasks as one
grid on the card).  The same declaration gives the same points, seeds
and streams as the reference's.

Seed derivation
---------------

Repetition seeding is where tail-latency benchmarks silently go wrong
("Tell-Tale Tail Latencies", "Sampling in Cloud Benchmarking"): ad-hoc
arithmetic like ``seed + 1000*(rep+1)`` collides across points (point
seed 0 / rep 1 replays point seed 1000 / rep 0), quietly correlating
supposedly independent repetitions.  The default ``"spawn"`` seeder
derives every (point, rep) seed from
``np.random.SeedSequence(base_seed, spawn_key=(point_index, rep))`` —
the SeedSequence spawn tree guarantees stream independence for every
(point, rep) pair, for any grid shape.

Named seeders (``Sweep.seeder``):

``"spawn"``
    ``(spawn_seed(base, point, rep), rep)`` — the collision-free
    default; the repetition index also threads into the client RNG
    streams so explicitly-seeded clients draw independent arrivals.
``"run-repeated"``
    ``(base + 1000*(rep+1), rep)`` — bit-compatible with the legacy
    ``run_repeated`` helper (which is now a shim over this).
``"fixed"``
    ``(base, 0)`` — the factory owns all per-rep variation (single-run
    figures, or factories that derive their own seeds from ``ctx.rep``).
``"rep"``
    ``(base + rep, 0)`` — the repetition index IS the seed (legacy
    figure scripts that loop ``for seed in range(13)``).

A custom ``(base_seed, point_index, rep) -> (seed, rng_stream)``
callable is also accepted (module-level, so it pickles to workers).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Optional, Sequence, Union

import numpy as np

#: metric names the executor resolves against ``telemetry.overall()``
SUMMARY_METRICS = ("n", "mean", "p50", "p95", "p99")
DEFAULT_METRICS = SUMMARY_METRICS
#: extra metric names with dedicated extractors
EXTRA_METRICS = ("dropped", "slo_frac", "shed", "timeouts", "retries")


# ---------------------------------------------------------------------------
# Seed derivation
# ---------------------------------------------------------------------------
def spawn_seed(base_seed: int, point_index: int, rep: int) -> int:
    """Collision-free (point, rep) seed via the SeedSequence spawn tree."""
    ss = np.random.SeedSequence(base_seed, spawn_key=(point_index, rep))
    return int(ss.generate_state(1, np.uint32)[0])


def _seed_spawn(base: int, index: int, rep: int) -> tuple:
    return spawn_seed(base, index, rep), rep


def _seed_run_repeated(base: int, index: int, rep: int) -> tuple:
    return base + 1000 * (rep + 1), rep


def _seed_fixed(base: int, index: int, rep: int) -> tuple:
    return base, 0


def _seed_rep(base: int, index: int, rep: int) -> tuple:
    return base + rep, 0


SEEDERS: dict[str, Callable[[int, int, int], tuple]] = {
    "spawn": _seed_spawn,
    "run-repeated": _seed_run_repeated,
    "fixed": _seed_fixed,
    "rep": _seed_rep,
}


# ---------------------------------------------------------------------------
# Points
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Axis:
    """One sweepable parameter: a name and its ordered values."""
    name: str
    values: tuple

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(self.values))
        if not self.values:
            raise ValueError(f"axis {self.name!r} has no values")


@dataclass(frozen=True)
class PointCtx:
    """Everything a point factory may consume: the point's parameters,
    its position in the sweep, and the derived seed/RNG stream."""
    params: dict
    index: int          # point index in declaration order
    rep: int            # repetition index
    seed: int           # derived experiment seed (factories may override)
    stream: int         # repetition RNG stream (threads into client RNGs)


def _as_axes(axes) -> tuple:
    out = []
    for ax in axes:
        if isinstance(ax, Axis):
            out.append(ax)
        else:                       # (name, values) pair
            name, values = ax
            out.append(Axis(name, tuple(values)))
    return tuple(out)


# ---------------------------------------------------------------------------
# Sweep
# ---------------------------------------------------------------------------
@dataclass
class Sweep:
    """A declarative experiment grid.

    ``factory(ctx: PointCtx) -> Experiment | Scenario`` builds one run;
    use ``experiment_factory``/``scenario_factory`` for the common
    cases.  Factories must be module-level callables (or partials of
    them) to run on the process executor.

    Point forms (``mode``): ``"grid"`` takes the cartesian product of
    ``axes`` in declaration order (first axis outermost), ``"zip"``
    zips equal-length axes, ``"points"`` uses the explicit ``points``
    dicts.  ``fixed`` parameters merge into every point.

    ``mode="optimize"`` is the gradient-planner entry point
    (``repro_torch.plan.run_plan_sweep``): an ``optimize`` block, no
    axes or points.

    ``runtime`` picks the execution backend: ``"sim"`` (virtual-time
    simulator, the default, as in the reference), ``"engine"``
    (wall-clock ``EngineRuntime`` driving stub engines on a virtual
    clock), or ``"vector"`` (the grid runtime: every (point, rep) cell
    of the sweep advances simultaneously as one array program on the
    card — statistically equivalent to ``sim``).  A point may override
    it via a ``"runtime"`` parameter — the backend itself is a
    sweepable axis (that is how ``fig_batching`` declares its
    sim-vs-engine knees, and how a vector sweep can carry a sim
    control arm in the same frame).
    """
    name: str
    factory: Callable[[PointCtx], object]
    axes: Sequence = ()
    mode: str = "grid"                  # grid | zip | points
    points: Sequence[dict] = ()
    fixed: dict = field(default_factory=dict)
    reps: int = 13                      # the paper's repetition count
    base_seed: int = 0
    seeder: Union[str, Callable[[int, int, int], tuple]] = "spawn"
    metrics: Sequence = DEFAULT_METRICS
    telemetry: bool = False             # capture per-interval series rows
    per_client: bool = False            # capture per-client summaries
    runtime: str = "sim"                # sim | engine (stub replicas)
                                        # | vector (the card's grid)
    optimize: Optional[dict] = None     # mode="optimize": planner knobs

    def __post_init__(self):
        self.axes = _as_axes(self.axes)
        if self.mode not in ("grid", "zip", "points", "optimize"):
            raise ValueError(f"unknown sweep mode: {self.mode!r}")
        if self.mode == "optimize":
            if not self.optimize:
                raise ValueError("mode='optimize' needs an optimize "
                                 "block (at least an 'slo')")
            if self.axes or self.points:
                raise ValueError("mode='optimize' takes no axes/points "
                                 "— the planner owns the search")
            if self.reps < 1:
                raise ValueError("reps must be >= 1")
            return
        if self.optimize:
            raise ValueError(f"optimize block given but "
                             f"mode={self.mode!r} (use mode='optimize')")
        if self.mode == "points" and not self.points:
            raise ValueError("mode='points' needs a non-empty points list")
        if self.mode != "points" and self.points:
            raise ValueError(f"points given but mode={self.mode!r}: they "
                             f"would be silently ignored (use "
                             f"mode='points')")
        if self.mode != "points" and not self.axes:
            # a 1-point sweep (reps only) is legal: one empty point
            self.mode = "points"
            self.points = ({},)
        if self.mode == "zip":
            lens = {len(ax.values) for ax in self.axes}
            if len(lens) > 1:
                raise ValueError(f"zip axes differ in length: {sorted(lens)}")
        if self.reps < 1:
            raise ValueError("reps must be >= 1")
        if self.runtime not in ("sim", "engine", "vector"):
            raise ValueError(f"unknown runtime: {self.runtime!r}")
        if isinstance(self.seeder, str) and self.seeder not in SEEDERS:
            raise ValueError(f"unknown seeder {self.seeder!r}; "
                             f"named: {sorted(SEEDERS)}")

    # ------------------------------------------------------------- points
    def point_dicts(self) -> list[dict]:
        """The sweep's points, in deterministic declaration order."""
        if self.mode == "optimize":
            return []               # the planner owns the search space
        if self.mode == "points":
            pts = [dict(p) for p in self.points]
        elif self.mode == "zip":
            pts = [dict(zip((ax.name for ax in self.axes), combo))
                   for combo in zip(*(ax.values for ax in self.axes))]
        else:                          # grid: first axis outermost
            pts = [dict(zip((ax.name for ax in self.axes), combo))
                   for combo in itertools.product(
                       *(ax.values for ax in self.axes))]
        if self.fixed:
            pts = [{**self.fixed, **p} for p in pts]
        return pts

    def tasks(self) -> list[tuple]:
        """Flat (point_index, params, rep) work list, declaration order."""
        return [(i, params, rep)
                for i, params in enumerate(self.point_dicts())
                for rep in range(self.reps)]

    def seed_for(self, point_index: int, rep: int) -> tuple:
        """-> (experiment seed, repetition RNG stream) for one task."""
        fn = SEEDERS[self.seeder] if isinstance(self.seeder, str) \
            else self.seeder
        seed, stream = fn(self.base_seed, point_index, rep)
        return int(seed), int(stream)

    def describe(self) -> dict:
        """JSON-friendly spec metadata (recorded into the ResultFrame)."""
        return {
            "name": self.name,
            "mode": self.mode,
            "axes": {ax.name: list(ax.values) for ax in self.axes},
            "n_points": len(self.point_dicts()),
            "fixed": dict(self.fixed),
            "reps": self.reps,
            "base_seed": self.base_seed,
            "seeder": (self.seeder if isinstance(self.seeder, str)
                       else getattr(self.seeder, "__name__", "custom")),
            "metrics": [m if isinstance(m, str) else m[0]
                        for m in self.metrics],
            "runtime": self.runtime,
            "telemetry": self.telemetry,
            "per_client": self.per_client,
            **({"optimize": dict(self.optimize)} if self.optimize else {}),
        }


# ---------------------------------------------------------------------------
# Common factories
# ---------------------------------------------------------------------------
#: point-param keys the EXECUTOR consumes (never the point factory) —
#: custom factories building from ``ctx.params`` should go through
#: ``factory_params`` so a sweep stays free to add these axes
EXECUTOR_PARAMS = ("runtime",)


def factory_params(ctx: PointCtx) -> dict:
    """``ctx.params`` minus the executor-consumed keys — what a factory
    may forward verbatim to an ``Experiment``/scenario builder."""
    return {k: v for k, v in ctx.params.items()
            if k not in EXECUTOR_PARAMS}


def _experiment_point(base_exp, ctx: PointCtx):
    from dataclasses import replace
    return replace(base_exp, seed=ctx.seed, **factory_params(ctx))


def experiment_factory(base_exp) -> Callable[[PointCtx], object]:
    """Factory over a base ``Experiment``: point params map onto its
    dataclass fields via ``replace`` and the derived seed is applied
    (a ``"runtime"`` axis goes to the executor, not the dataclass)."""
    return partial(_experiment_point, base_exp)


def _scenario_point(name: str, ctx: PointCtx):
    from repro_torch.scenarios import get
    return get(name, seed=ctx.seed, **factory_params(ctx))


def scenario_factory(name: str) -> Callable[[PointCtx], object]:
    """Factory over a canonical scenario: point params become builder
    keyword overrides (``qps``, ``n_servers``, ``duration``, ...) and
    the derived seed becomes the scenario seed.  A ``"runtime"`` param
    is consumed by the executor, not the builder."""
    return partial(_scenario_point, name)
