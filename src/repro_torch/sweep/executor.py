"""Sweep execution: serial and process-parallel behind one interface.

Copy of ``repro.sweep.executor``, with the vector grid path on the
card.  A ``mode="optimize"`` sweep runs the gradient planner
(``repro_torch.plan.run_plan_sweep``).  With a result cache
(``repro_torch.cache.ResultCache``), rows are looked up before dispatch
and completed ok rows written back, under every executor.

``run_sweep(sweep)`` expands the spec into (point, repetition) tasks,
executes each as an independent deterministic run, and assembles a
``ResultFrame`` whose rows are ordered by (point_index, rep) — NOT by
completion order — so the frame is bit-identical whether it ran
serially, on 2 workers, or on 8 workers, under any OS scheduling.

Every task is hermetic: it derives its own seeds from the spec (no
shared RNG state), builds its own ``Experiment``/runtime, and extracts
its metrics in-worker (simulators never cross process boundaries).  A
task that raises records an error row — the sweep completes and reports
the failure instead of dying with it.

Backends:

* ``"serial"`` — in-process loop (supports lambda factories/metrics);
* ``"process"`` — ``concurrent.futures.ProcessPoolExecutor``; the
  ``Sweep`` must pickle, i.e. factories and metric callables must be
  module-level functions (or ``functools.partial`` of them).

Tasks whose runtime is ``"vector"`` bypass both: they are batched into
ONE in-process grid (``run_vector_tasks``: ``repro_torch.vector.run_cells``,
one scan and one quantile launch per shape bucket on the card, or the
plain PyTorch versions when ``vector_config`` asks for the CPU) — the
grid is the unit of execution there, and the resulting rows are
bit-identical to per-task runs under any executor/worker count by
construction.
"""
from __future__ import annotations

import multiprocessing
import sys
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from typing import Callable, Optional

from repro_torch.sweep.results import ResultFrame, SweepRow
from repro_torch.sweep.spec import (EXTRA_METRICS, SUMMARY_METRICS,
                                   PointCtx, Sweep)


# ---------------------------------------------------------------------------
# One task = one (point, rep) run
# ---------------------------------------------------------------------------
def _build_runtime(sweep: Sweep, exp, ctx: PointCtx, vector_config=None):
    runtime = ctx.params.get("runtime", sweep.runtime)
    if runtime == "sim":
        from repro_torch.core.runtime import SimulatorRuntime
        rt = SimulatorRuntime(exp, rep=ctx.stream)
        rt.run()
        return rt
    if runtime == "engine":
        from repro_torch.core.runtime import EngineRuntime, VirtualClock
        from repro_torch.scenarios.backends import build_stub_engines
        clock = VirtualClock()
        engines, factory = build_stub_engines(exp, clock, exp.seed)
        rt = EngineRuntime.from_experiment(exp, engines,
                                           engine_factory=factory,
                                           rep=ctx.stream, clock=clock,
                                           sleep=clock.sleep)
        rt.run()
        return rt
    if runtime == "vector":
        # single-cell fallback (the grid path in run_sweep batches all
        # vector tasks into one array program; per-cell RNG derivation
        # makes the two paths bit-identical)
        from repro_torch.vector import VectorRuntime
        rt = VectorRuntime(exp, rep=ctx.stream, config=vector_config)
        rt.run()
        return rt
    raise ValueError(f"unknown runtime: {runtime!r}")


def _slo_frac(rt, slo) -> float:
    """Fraction of recorded latencies above the SLO (NaN without one)."""
    if slo is None:
        return float("nan")
    rec = rt.recorder
    if rec is None:                 # vector backend: sampled latencies
        return rt.telemetry.slo_frac()
    if rec.mode == "exact":
        from repro_torch.core.stats import slo_violation_frac
        return slo_violation_frac(rec.all, slo, n_bad=rec.failed_total())
    # streaming mode: aggregate the per-interval violation fractions,
    # weighted by interval request counts — served AND disposed
    # (shed/timeout/failed count as violations; reservoir-approximate)
    num = den = 0.0
    for f in rt.telemetry.frames():
        w = f.n + f.n_shed + f.n_timeout + f.n_failed
        if w and f.slo_violation_frac == f.slo_violation_frac:
            num += f.slo_violation_frac * w
            den += w
    return num / den if den else float("nan")


def _extract_metrics(sweep: Sweep, rt, exp) -> dict:
    s = rt.telemetry.overall()
    out: dict = {}
    for m in sweep.metrics:
        if not isinstance(m, str):          # ("name", callable) pair
            name, fn = m
            out[name] = fn(rt)
        elif m in SUMMARY_METRICS:
            out[m] = getattr(s, m)
        elif m == "dropped":
            out[m] = rt.dropped
        elif m == "slo_frac":
            out[m] = _slo_frac(rt, exp.slo)
        elif m in ("shed", "timeouts", "retries"):
            # resilience counters; 0 on runtimes without the feature
            # (vector exposes shed only — fluid has no per-request
            # timeout/retry mechanics)
            out[m] = int(getattr(rt, m, 0))
        else:
            raise ValueError(f"unknown metric {m!r}; known: "
                             f"{SUMMARY_METRICS + EXTRA_METRICS} or a "
                             f"(name, callable) pair")
    return out


def _series_rows(rt, cid: Optional[int]) -> list:
    key = -1 if cid is None else cid
    return [{"cid": key, "t": t, "n": s.n, "mean": s.mean,
             "p50": s.p50, "p95": s.p95, "p99": s.p99}
            for t, s in rt.telemetry.series(cid).items()]


def run_task(sweep: Sweep, index: int, params: dict, rep: int,
             capture: bool = True) -> SweepRow:
    """Execute one (point, rep) task; exceptions become error rows
    (``capture=False`` lets them propagate for fail-fast callers)."""
    seed, stream = sweep.seed_for(index, rep)
    ctx = PointCtx(params=params, index=index, rep=rep, seed=seed,
                   stream=stream)
    try:
        obj = sweep.factory(ctx)
        exp = obj.compile() if hasattr(obj, "compile") else obj
        rt = _build_runtime(sweep, exp, ctx)
        metrics = _extract_metrics(sweep, rt, exp)
        clients = None
        if sweep.per_client:
            clients = {str(cid): vars(rt.telemetry.client(cid))
                       for cid in rt.telemetry.clients()}
        series = None
        if sweep.telemetry:
            series = _series_rows(rt, None)
            if sweep.per_client:
                for cid in rt.telemetry.clients():
                    series.extend(_series_rows(rt, cid))
        return SweepRow(index=index, params=params, rep=rep,
                        seed=getattr(exp, "seed", seed), stream=stream,
                        metrics=metrics, clients=clients, series=series)
    except Exception as e:  # repro: noqa[broad-except] — error-row contract
        if not capture:
            raise
        return SweepRow(index=index, params=params, rep=rep, seed=seed,
                        stream=stream, error=f"{type(e).__name__}: {e}")


# ---------------------------------------------------------------------------
# Vector grid path: every vector task of the sweep as ONE array program
# ---------------------------------------------------------------------------
class _VectorCellView:
    """Runtime-shaped view of one grid cell (what ``_extract_metrics``
    and the telemetry capture consume)."""

    recorder = None

    def __init__(self, telemetry, dropped: int, shed: int = 0):
        self.telemetry = telemetry
        self.dropped = dropped
        self.shed = shed


def run_vector_tasks(sweep: Sweep, vec_tasks: list,
                     fail_fast: bool = False, config=None,
                     cache=None) -> dict:
    """Execute ``[(k, index, params, rep), ...]`` on the vector backend
    as one batched grid (the whole point of the backend: the grid — not
    the cell — is the unit of execution), on ``config.device``: the card
    unless the ``VectorConfig`` asks for the CPU.  Returns
    ``{k: SweepRow}``.  Results are bit-identical to running each task
    alone through ``run_task`` because every cell derives its own RNG
    from (experiment seed, repetition stream).  A grid that fails (no
    card, a kernel that does not build) becomes error rows, as in the
    reference; callers that need every row call ``raise_errors()`` on
    the frame or pass ``fail_fast=True``.  A ``cache`` serves the cells
    it holds without a launch (``run_cells``)."""
    from repro_torch.vector import (VectorConfig, VectorTelemetry,
                                    compile_experiment, run_cells)
    cfg = config if config is not None else VectorConfig()
    rows: dict = {}
    progs, seeds, metas = [], [], []
    for k, i, params, rep in vec_tasks:
        seed, stream = sweep.seed_for(i, rep)
        ctx = PointCtx(params=params, index=i, rep=rep, seed=seed,
                       stream=stream)
        try:
            obj = sweep.factory(ctx)
            exp = obj.compile() if hasattr(obj, "compile") else obj
            progs.append(compile_experiment(exp, dt=cfg.dt))
        except Exception as e:  # repro: noqa[broad-except] — error-row contract
            if fail_fast:
                raise
            rows[k] = SweepRow(index=i, params=params, rep=rep, seed=seed,
                               stream=stream,
                               error=f"{type(e).__name__}: {e}")
            continue
        seeds.append((exp.seed, stream))
        metas.append((k, i, params, rep, exp, stream))
    try:
        results = run_cells(progs, seeds, cfg, cache=cache)
    except Exception as e:  # repro: noqa[broad-except] — a failing grid
        if fail_fast:       # the sim/engine tasks sharing the sweep
            raise
        for k, i, params, rep, exp, stream in metas:
            rows[k] = SweepRow(index=i, params=params, rep=rep,
                               seed=exp.seed, stream=stream,
                               error=f"vector grid: "
                                     f"{type(e).__name__}: {e}")
        return rows
    for (k, i, params, rep, exp, stream), res in zip(metas, results):
        try:
            shed = (int(round(float(res.shed_ivl.sum())))
                    if res.shed_ivl is not None else 0)
            view = _VectorCellView(VectorTelemetry(res), res.dropped,
                                   shed=shed)
            metrics = _extract_metrics(sweep, view, exp)
            clients = None
            if sweep.per_client:
                clients = {}            # per-client views: not tracked
            series = None
            if sweep.telemetry:
                series = _series_rows(view, None)
            rows[k] = SweepRow(index=i, params=params, rep=rep,
                               seed=exp.seed, stream=stream,
                               metrics=metrics, clients=clients,
                               series=series)
        except Exception as e:  # repro: noqa[broad-except] — error-row contract
            if fail_fast:
                raise
            rows[k] = SweepRow(index=i, params=params, rep=rep,
                               seed=exp.seed, stream=stream,
                               error=f"{type(e).__name__}: {e}")
    return rows


# ---------------------------------------------------------------------------
# Result cache (row level)
# ---------------------------------------------------------------------------
def _row_key(cache, sweep: Sweep, index: int, params: dict, rep: int,
             vector_config=None):
    """Content key for one (point, rep) row: the compiled experiment,
    the derived (seed, stream), the runtime, and everything the row
    extraction depends on (a vector row's device included).  ``None`` =
    not cacheable (lambda metric, factory failure, no card, ...) — the
    task simply runs."""
    seed, stream = sweep.seed_for(index, rep)
    ctx = PointCtx(params=params, index=index, rep=rep, seed=seed,
                   stream=stream)
    try:
        obj = sweep.factory(ctx)
        exp = obj.compile() if hasattr(obj, "compile") else obj
    except Exception:  # repro: noqa[broad-except] — a failing factory
        # must fail identically on the real path (error row), so the
        # task is simply not cacheable
        return None
    runtime = params.get("runtime", sweep.runtime)
    sig = {"runtime": runtime, "metrics": list(sweep.metrics),
           "telemetry": sweep.telemetry, "per_client": sweep.per_client}
    if runtime == "vector":
        from repro_torch.vector import VectorConfig
        try:
            sig["vector"] = cache.vector_sig(vector_config
                                             or VectorConfig())
        except Exception:  # repro: noqa[broad-except] — unresolvable
            # device (no card, an unknown name, a missing index):
            # uncacheable, and the real path raises its own error row
            return None
    return cache.key("row", exp, (int(seed), int(stream)), sig)


def _row_from_payload(index: int, params: dict, rep: int,
                      payload: dict) -> SweepRow:
    return SweepRow(index=index, params=params, rep=rep,
                    seed=payload["seed"], stream=payload["stream"],
                    metrics=payload["metrics"],
                    clients=payload.get("clients"),
                    series=payload.get("series"))


def _row_payload(row: SweepRow) -> dict:
    payload = {"seed": row.seed, "stream": row.stream,
               "metrics": row.metrics}
    if row.clients is not None:
        payload["clients"] = row.clients
    if row.series is not None:
        payload["series"] = row.series
    return payload


# ---------------------------------------------------------------------------
# Executors
# ---------------------------------------------------------------------------
def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def mp_context():
    """Start-method for sweep workers: never ``fork``.

    This process may hold a CUDA context (``run_sweep`` runs the vector
    tasks on the card BEFORE it starts the pool, so a mixed sweep — a
    ``runtime`` axis over ``sim|vector`` — reaches the pool with CUDA
    initialised), and PyTorch's own thread pools; a forked child inherits
    a context it cannot use and locks no thread will release.  So the
    workers start clean: from a ``forkserver`` once CUDA is initialised
    (one helper that never touched the card, forking every later worker
    of the session; ``spawn`` where the forkserver is unavailable), and
    by ``spawn`` otherwise.  Workers never touch the card: vector tasks
    never go to them.  Sweep results are start-method independent; only
    startup cost differs.  (The reference forks unless ``jax`` is
    loaded.)"""
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        try:
            return multiprocessing.get_context("forkserver")
        except ValueError:
            pass
    return multiprocessing.get_context("spawn")


def run_sweep(sweep: Sweep, executor: str = "serial",
              workers: Optional[int] = None,
              progress: Optional[Callable[[str], None]] = _log,
              fail_fast: bool = False,
              vector_config=None, cache=None) -> ResultFrame:
    """Execute a ``Sweep`` and return its ``ResultFrame``.

    ``executor="serial"`` runs in-process; ``"process"`` fans the tasks
    out over a ``ProcessPoolExecutor`` with ``workers`` processes.  Rows
    are assembled in (point, rep) declaration order either way, so the
    two backends produce identical frames.  ``progress`` (default:
    stderr) receives one line per completed task; pass ``None`` to
    silence it.  ``fail_fast=True`` re-raises a task's ORIGINAL
    exception at the first failure instead of recording an error row —
    for shims like ``run_repeated`` whose callers expect the historical
    propagation semantics.  ``vector_config`` (a
    ``repro_torch.vector.VectorConfig``) picks where the vector grid
    runs: the card by default, the CPU with ``device="cpu"``; its other
    knobs are bit-preserving, so it cannot change rows.  A
    ``mode="optimize"`` sweep runs the gradient planner on the same
    device and returns its phase-tagged frame.

    ``cache`` (a ``repro_torch.cache.ResultCache``) is consulted per
    task BEFORE dispatch — in this process, under every executor — and
    completed ok rows are written back here too.  Hit rows land at their
    declaration slot exactly like computed ones, so caching can never
    reorder or change a frame; a task whose key cannot be computed
    simply runs.  A vector row's key names its device, so a CPU row
    never answers a card sweep.
    """
    if sweep.mode == "optimize":
        # gradient-planner entry point: the search is an optimizer loop
        # over the smoothed vector surrogate, not a task grid
        from repro_torch.plan import run_plan_sweep
        return run_plan_sweep(sweep, progress=progress,
                              vector_config=vector_config, cache=cache)
    tasks = sweep.tasks()
    total = len(tasks)
    rows: list = [None] * total

    def note(done: int, row: SweepRow) -> None:
        if progress is None:
            return
        status = "ok" if row.ok else f"ERROR ({row.error})"
        progress(f"sweep[{sweep.name}] {done}/{total} "
                 f"point={row.params} rep={row.rep}: {status}")

    done = 0
    row_keys: list = [None] * total
    cached: set = set()
    if cache is not None:
        for k, (i, params, rep) in enumerate(tasks):
            row_keys[k] = _row_key(cache, sweep, i, params, rep,
                                   vector_config)
            if row_keys[k] is None:
                continue
            payload = cache.get_row(row_keys[k])
            if payload is not None:
                rows[k] = _row_from_payload(i, params, rep, payload)
                cached.add(k)
                done += 1
                note(done, rows[k])

    # vector tasks always run the in-process grid path, whatever the
    # executor: the batched array program IS the parallelism, and the
    # rows are bit-identical to per-task execution by construction —
    # worker counts and executor choice cannot change vector results
    vec_tasks = [(k, i, params, rep)
                 for k, (i, params, rep) in enumerate(tasks)
                 if rows[k] is None
                 and params.get("runtime", sweep.runtime) == "vector"]
    if vec_tasks:
        for k, row in run_vector_tasks(sweep, vec_tasks,
                                       fail_fast=fail_fast,
                                       config=vector_config,
                                       cache=cache).items():
            rows[k] = row
            done += 1
            note(done, row)
    tasks_left = [(k, i, params, rep)
                  for k, (i, params, rep) in enumerate(tasks)
                  if rows[k] is None]

    if executor == "serial":
        for k, i, params, rep in tasks_left:
            rows[k] = run_task(sweep, i, params, rep,
                               capture=not fail_fast)
            done += 1
            note(done, rows[k])
    elif executor == "process":
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=mp_context()) as pool:
            futs = {pool.submit(run_task, sweep, i, params, rep,
                                not fail_fast): k
                    for k, i, params, rep in tasks_left}
            pending = set(futs)
            while pending:
                finished, pending = wait(pending,
                                         return_when=FIRST_COMPLETED)
                for fut in finished:
                    k = futs[fut]
                    i, params, rep = tasks[k]
                    try:
                        rows[k] = fut.result()
                    except Exception as e:  # repro: noqa[broad-except]
                        # worker died, or a fail-fast task re-raised
                        # its original exception
                        if fail_fast:
                            for p in pending:
                                p.cancel()
                            raise
                        # record the death, don't kill the sweep
                        seed, stream = sweep.seed_for(i, rep)
                        rows[k] = SweepRow(index=i, params=params, rep=rep,
                                           seed=seed, stream=stream,
                                           error=f"worker: "
                                                 f"{type(e).__name__}: {e}")
                    done += 1
                    note(done, rows[k])
    else:
        raise ValueError(f"unknown executor {executor!r} "
                         f"(serial | process)")
    if cache is not None:
        # write back every computed ok row (error rows are never
        # cached: a fixed bug must re-run, not replay its failure)
        for k, row in enumerate(rows):
            if k not in cached and row_keys[k] is not None and row.ok:
                cache.put_row(row_keys[k], _row_payload(row))
    return ResultFrame(name=sweep.name, spec={**sweep.describe(),
                                              "executor": executor},
                       rows=rows)
