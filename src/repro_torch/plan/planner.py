"""Gradient-based capacity planning: a handful of Adam steps through
the smoothed surrogate replaces the dense provisioning grid.

Port of ``repro.plan.planner``.  ``run_plan`` drives ``torch.autograd``
of ``plan_loss`` with the port's AdamW (``repro_torch.training
.optimizer``) under box-constraint projection and deterministic
multi-start, then — because the surrogate is never trusted alone —
rounds the continuous capacity to an integer fleet and walks a short
probe ladder on the EXACT (non-soft) vector runtime: a few repetitions
per candidate decide the smallest integer fleet meeting the target, and
the final answer is re-measured at full repetition count.  Every exact
cell is counted; ``PlanResult.cell_evals`` is the number a dense grid
sweep gets compared against (``benchmarks/torch_port/bench_plan.py``).

The surrogate and the exact ladder both run on ``vector_config.device``:
the card by default, the CPU with ``VectorConfig(device="cpu")``.  The
surrogate runs eagerly in f32 (the reference jits it), so gradients
agree with the reference's to rounding and the continuous optimum to a
tolerance; the ladder's integer decisions are the reference's.

``run_plan_sweep`` adapts a ``mode="optimize"`` sweep spec onto the
same entry point so planner runs flow through the ``ResultFrame`` / CSV /
artifact machinery.  A result cache (``repro_torch.cache.ResultCache``,
``cache=``) serves the ladder's exact cells it holds — from an earlier
run, a dense grid of the same question, or an earlier probe of the same
run — and ``cell_evals`` counts only the cells it could not serve.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.plan.model import (OBJECTIVES, PlanConfig, PlanError,
                                    build_plan_data, device_draws,
                                    hard_metrics, plan_loss)

#: default (init, lo, hi) box per learnable parameter
DEFAULT_BOXES = {
    "capacity": (4.0, 1.0, 32.0),
    "hedge_delay": (0.05, 1e-4, 1.0),
    "admit": (1.0, 0.1, 1.0),
    "scale_threshold": (0.7, 0.05, 2.0),
}


@dataclass
class PlanSpec:
    """One planning problem: a scenario, an objective, and the box of
    learnable parameters."""
    scenario: str = "steady"
    objective: str = "p99"              # one of OBJECTIVES
    slo: float = 0.02
    target: Optional[float] = None      # default: slo (0.05 for slo_frac)
    overrides: dict = field(default_factory=dict)
    params: dict = field(default_factory=lambda:
                         {"capacity": DEFAULT_BOXES["capacity"]})
    autoscale: Optional[tuple] = None   # (base, extra) servers
    steps: int = 150
    starts: int = 3
    lr: float = 0.15
    schedule: str = "cosine"            # cosine | constant
    seed: int = 0
    dt: float = 0.005
    samples: int = 16384
    tau: float = 0.05
    band_frac: float = 2e-3
    penalty: float = 25.0
    cost_weight: float = 1.0
    reps: int = 13                      # final-answer verification reps
    probe_reps: int = 5                 # ladder-probe reps
    verify: bool = True

    def config(self) -> PlanConfig:
        return PlanConfig(tau=self.tau, band_frac=self.band_frac,
                          penalty=self.penalty,
                          cost_weight=self.cost_weight)


@dataclass
class PlanResult:
    """Everything one planning run produced."""
    spec: dict
    pooled: bool
    n_ref: float
    starts: list                        # per-start {params, loss, history}
    best_start: int
    params: dict                        # best continuous parameters
    surrogate: dict                     # smoothed metrics at the optimum
    hard: dict                          # hard-twin metrics at the optimum
    n_star: Optional[int] = None        # verified integer fleet
    verified: Optional[dict] = None     # exact-runtime measurement
    probes: list = field(default_factory=list)
    cell_evals: int = 0                 # exact vector cells consumed
    feasible: bool = True

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _metric_of(result, objective: str) -> float:
    """Extract the objective metric from one exact VectorResult."""
    if objective == "slo_frac":
        from repro_torch.vector import VectorTelemetry
        return float(VectorTelemetry(result).slo_frac())
    return float(getattr(result, objective))


def mean_ci95(vals) -> tuple:
    """(mean, 95% CI half-width) of ``vals``; NaN width below 2."""
    vals = np.asarray(vals, float)
    m = float(vals.mean())
    if vals.size < 2:
        return m, float("nan")
    return m, float(1.96 * vals.std(ddof=1) / np.sqrt(vals.size))


class _ExactEvaluator:
    """Runs integer fleet candidates on the exact vector runtime and
    counts every cell.  One compile per candidate; repetitions differ
    only in their (seed, stream) pairs, derived through the sweep
    machinery's SeedSequence spawn tree."""

    def __init__(self, spec: PlanSpec, vector_config=None, cache=None):
        from repro_torch.vector import VectorConfig
        self.spec = spec
        base = vector_config or VectorConfig()
        if base.soft:
            raise PlanError("verification must run the exact runtime "
                            "(vector_config.soft must be False)")
        self.cfg = dataclasses.replace(base, dt=spec.dt)
        self.cells = 0
        self._progs: dict = {}
        # content-addressed reuse: cells repeat across the ladder (the
        # final measurement re-reads the probe of the same fleet) and
        # across runs (disk) — e.g. a planner run after a dense sweep of
        # the same scenario finds nearly every cell already stored.
        # Cells served from the cache are NOT counted: ``cells`` is
        # genuinely new work.
        self.cache = cache

    def _program(self, n: int):
        from repro_torch.scenarios import get
        prog = self._progs.get(n)
        if prog is None:
            try:
                sc = get(self.spec.scenario, seed=int(self.spec.seed),
                         slo=self.spec.slo,
                         **{**self.spec.overrides, "n_servers": int(n)})
            except TypeError as e:
                raise PlanError(
                    f"scenario {self.spec.scenario!r} does not accept an "
                    f"n_servers override — exact capacity verification "
                    f"needs one ({e})") from e
            from repro_torch.vector import compile_experiment
            prog = compile_experiment(sc.compile(), dt=self.spec.dt)
            self._progs[n] = prog
        return prog

    def measure(self, n: int, reps: int) -> list:
        """-> objective-metric value per repetition (exact runtime)."""
        from repro_torch.sweep.spec import spawn_seed
        from repro_torch.vector import run_cells
        prog = self._program(n)
        seeds = [(spawn_seed(self.spec.seed, int(n), rep), rep)
                 for rep in range(reps)]
        if self.cache is None:
            results = run_cells([prog] * reps, seeds, self.cfg)
            self.cells += reps
        else:
            before = self.cache.stats.hits
            results = run_cells([prog] * reps, seeds, self.cfg,
                                cache=self.cache)
            self.cells += reps - (self.cache.stats.hits - before)
        return [_metric_of(r, self.spec.objective) for r in results]


def _spread_inits(box: tuple, start: int, starts: int) -> float:
    """Deterministic multi-start: start 0 takes the declared init, the
    rest spread evenly over the box interior."""
    init, lo, hi = box
    if start == 0:
        return float(init)
    frac = (2 * start + 1) / (2.0 * starts)
    return float(lo + frac * (hi - lo))


def run_plan(spec: PlanSpec, *,
             progress: Optional[Callable[[str], None]] = None,
             vector_config=None, cache=None) -> PlanResult:
    """Execute one planning problem end to end: multi-start Adam on the
    smoothed surrogate, then integer rounding verified on the exact
    vector runtime, both on ``vector_config.device`` (the card unless
    it asks for the CPU).  ``cache`` serves the ladder's exact cells it
    holds; ``cell_evals`` counts the rest."""
    from repro_torch.device import resolve_device
    from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                                init_opt_state)
    from repro_torch.vector import VectorConfig

    if spec.objective not in OBJECTIVES:
        raise PlanError(f"unknown objective {spec.objective!r}")
    if not spec.params:
        raise PlanError("no learnable parameters declared")
    boxes = {}
    for name, box in spec.params.items():
        if name not in DEFAULT_BOXES:
            raise PlanError(f"unknown parameter {name!r}; "
                            f"one of {sorted(DEFAULT_BOXES)}")
        boxes[name] = tuple(float(v) for v in (
            box if box is not None else DEFAULT_BOXES[name]))
    if "scale_threshold" in boxes and spec.autoscale is None:
        raise PlanError("scale_threshold needs autoscale=(base, extra)")
    device = resolve_device((vector_config or VectorConfig()).device)

    def note(msg: str) -> None:
        if progress is not None:
            progress(msg)

    data = build_plan_data(
        spec.scenario, slo=spec.slo, objective=spec.objective,
        target=spec.target, overrides=spec.overrides,
        autoscale=spec.autoscale, seed=spec.seed, dt=spec.dt,
        samples=spec.samples)
    cfg = spec.config()
    draws = device_draws(data, torch.float32, device)

    def value_and_grad(params: dict) -> tuple:
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss, aux = plan_loss(leaves, data, cfg, draws)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
            dict(zip(leaves, grads))

    opt_cfg = OptConfig(lr=spec.lr, weight_decay=0.0, grad_clip=5.0,
                        warmup_steps=max(2, spec.steps // 20),
                        total_steps=spec.steps, m_dtype="float32",
                        schedule=spec.schedule)
    lo = {k: b[1] for k, b in boxes.items()}
    hi = {k: b[2] for k, b in boxes.items()}

    start_rows = []
    for s in range(spec.starts):
        params = {k: torch.tensor(_spread_inits(boxes[k], s, spec.starts),
                                  dtype=torch.float32, device=device)
                  for k in boxes}
        state = init_opt_state(params, opt_cfg)
        history = []
        for _ in range(spec.steps):
            val, _aux, grads = value_and_grad(params)
            with torch.no_grad():
                params, state, _m = adamw_update(params, grads, state,
                                                 opt_cfg)
                params = {k: torch.clamp(v, lo[k], hi[k])
                          for k, v in params.items()}
            history.append(float(val))
        val, aux, _ = value_and_grad(params)
        start_rows.append({
            "params": {k: float(v) for k, v in params.items()},
            "loss": float(val),
            "metrics": {k: float(v) for k, v in aux.items()},
            "history": history,
        })
        note(f"plan[{spec.scenario}] start {s}: loss={float(val):.4f} "
             f"params={start_rows[-1]['params']}")

    best = int(np.argmin([r["loss"] for r in start_rows]))
    best_params = dict(start_rows[best]["params"])
    result = PlanResult(
        spec={**dataclasses.asdict(spec), "target": data.target,
              "params": {k: list(v) for k, v in boxes.items()}},
        pooled=data.pooled, n_ref=data.n_ref,
        starts=start_rows, best_start=best, params=best_params,
        surrogate=start_rows[best]["metrics"],
        hard=hard_metrics(best_params, data, cfg))

    if not (spec.verify and "capacity" in best_params):
        return result

    # ---- integer rounding + exact-runtime ladder ---------------------------
    ev = _ExactEvaluator(spec, vector_config=vector_config, cache=cache)
    lo_n = int(np.ceil(lo["capacity"]))
    hi_n = int(np.floor(hi["capacity"]))
    n = int(np.clip(round(best_params["capacity"]), lo_n, hi_n))

    def probe(k: int) -> bool:
        vals = ev.measure(k, spec.probe_reps)
        mean, ci = mean_ci95(vals)
        ok = mean <= data.target
        result.probes.append({"n": k, "mean": mean, "ci95": ci,
                              "reps": spec.probe_reps, "meets": ok})
        note(f"plan[{spec.scenario}] probe n={k}: "
             f"{spec.objective}={mean:.4g} "
             f"({'meets' if ok else 'misses'} {data.target:.4g})")
        return ok

    if probe(n):
        while n > lo_n and probe(n - 1):
            n -= 1
    else:
        while n < hi_n:
            n += 1
            if probe(n):
                break
    vals = ev.measure(n, spec.reps)
    mean, ci = mean_ci95(vals)
    result.n_star = n
    result.feasible = bool(mean <= data.target or
                           mean - ci <= data.target)
    result.verified = {"n": n, "metric": spec.objective, "values": vals,
                       "mean": mean, "ci95": ci, "reps": spec.reps,
                       "target": data.target}
    result.cell_evals = ev.cells
    note(f"plan[{spec.scenario}] verified n={n}: "
         f"{spec.objective}={mean:.4g} +- {ci:.4g} "
         f"({ev.cells} exact cells)")
    return result


# ---------------------------------------------------------------------------
# Sweep integration (mode="optimize")
# ---------------------------------------------------------------------------
#: PlanSpec fields a sweep's ``optimize`` block may set
_OPTIMIZE_KEYS = ("scenario", "objective", "slo", "target", "params",
                  "autoscale", "steps", "starts", "lr", "schedule",
                  "dt", "samples", "tau", "band_frac", "penalty",
                  "cost_weight", "probe_reps", "verify")


def plan_spec_from_sweep(sweep) -> PlanSpec:
    """Lower a ``mode="optimize"`` sweep onto a ``PlanSpec``: the
    ``optimize`` block carries the planner knobs, ``fixed`` becomes the
    scenario overrides, and reps/base_seed keep their sweep meanings."""
    opt = dict(sweep.optimize or {})
    unknown = set(opt) - set(_OPTIMIZE_KEYS)
    if unknown:
        raise PlanError(f"unknown optimize keys: {sorted(unknown)}; "
                        f"known: {sorted(_OPTIMIZE_KEYS)}")
    if "slo" not in opt:
        raise PlanError("optimize block needs an 'slo'")
    params = opt.pop("params", None)
    if params is not None:
        params = {k: (tuple(v) if v is not None else None)
                  for k, v in params.items()}
        opt["params"] = params
    autoscale = opt.pop("autoscale", None)
    if autoscale is not None:
        opt["autoscale"] = tuple(autoscale)
    return PlanSpec(scenario=opt.pop("scenario", sweep.name),
                    overrides=dict(sweep.fixed), seed=sweep.base_seed,
                    reps=sweep.reps, **opt)


def run_plan_sweep(sweep, *,
                   progress: Optional[Callable[[str], None]] = None,
                   vector_config=None, cache=None):
    """Execute a ``mode="optimize"`` sweep -> ``ResultFrame`` whose rows
    are phase-tagged: one row per optimizer start, one per exact-ladder
    probe, and one final verified row."""
    from repro_torch.sweep.results import ResultFrame, SweepRow

    spec = plan_spec_from_sweep(sweep)
    res = run_plan(spec, progress=progress, vector_config=vector_config,
                   cache=cache)
    rows = []
    for s, row in enumerate(res.starts):
        rows.append(SweepRow(
            index=0, params={"phase": "optimize", "start": s,
                             **row["params"]},
            rep=s, seed=sweep.base_seed, stream=0,
            metrics={"loss": row["loss"], **row["metrics"]}))
    for i, p in enumerate(res.probes):
        rows.append(SweepRow(
            index=1, params={"phase": "probe", "n_servers": p["n"]},
            rep=i, seed=sweep.base_seed, stream=0,
            metrics={spec.objective: p["mean"], "ci95": p["ci95"],
                     "meets": float(p["meets"])}))
    if res.verified is not None:
        rows.append(SweepRow(
            index=2, params={"phase": "final",
                             "n_servers": res.n_star},
            rep=0, seed=sweep.base_seed, stream=0,
            metrics={spec.objective: res.verified["mean"],
                     "ci95": res.verified["ci95"],
                     "cell_evals": float(res.cell_evals),
                     "feasible": float(res.feasible)}))
    return ResultFrame(name=sweep.name,
                       spec={**sweep.describe(), "plan": res.to_dict()},
                       rows=rows)
