"""The planner's objective model: a differentiable surrogate of one
scenario's tail-latency law, plus its hard (tau -> 0) twin.

Port of ``repro.plan.model``.  ``build_plan_data`` compiles a canonical
scenario onto the vector runtime's array program and freezes everything
the optimizer loop does NOT differentiate through: the offered-load
schedule, the service-law moments, and one reparameterized batch of
per-request draws (arrival slot, service demand, queue-indicator
uniform, conditional-wait exponential, and a hedge twin of each) — the
reference's draws, bit for bit.  ``surrogate_metrics`` maps continuous
provisioning parameters to smoothed p50/p95/p99/SLO-violation metrics
through ``repro_torch.vector.soft`` primitives in torch, so
``torch.autograd`` of ``plan_loss`` is the whole planner gradient.

The surrogate's dtype and device follow the parameters: a tensor
parameter sets both (f32 on the card in ``run_plan``, as under JAX's
32-bit default; f64 where the gradient checks run), and Python floats
mean f32 on the CPU.  The frozen NumPy draws are cast to that dtype, as
``jnp.asarray`` casts them under 32-bit JAX, and put on the device once
(``device_draws``): an optimizer loop passes them to every step, so no
step copies from the host.  The fluid backlog, a
``lax.scan`` in the reference, is its Lindley closed form here, computed
in f64 and cast to the surrogate's dtype: one ``cumsum`` and one
``cummin`` on the device instead of a slot loop.

The surrogate models a HOMOGENEOUS fleet at nominal speed (capacity =
x * mean workers-per-server): the surrogate proposes, and the exact
vector runtime decides (``planner.run_plan``'s probe ladder).

Learnable parameters (any subset, each a scalar):

* ``capacity``        — server count relaxed to continuous fleet size;
* ``hedge_delay``     — request-hedging delay (seconds);
* ``admit``           — per-class admission fraction in [0, 1];
* ``scale_threshold`` — autoscale trigger (utilization of the base
  fleet at which ``autoscale=(base, extra)`` spins up the extras).

``hard_metrics`` and ``analytic_capacity`` are the reference's NumPy
code verbatim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.stats import quantiles_partition
from repro_torch.vector.compile import compile_experiment
from repro_torch.vector.soft import (RHO_MAX, smooth_min, smooth_rho,
                                     soft_erlang_c, soft_quantiles, softplus,
                                     stable_sigmoid)

_EPS = 1e-12

#: metrics a plan objective may target
OBJECTIVES = ("p50", "p95", "p99", "mean", "slo_frac")

#: quantile order shared with the vector runtime's extraction head
PLAN_QS = (50.0, 95.0, 99.0)


class PlanError(ValueError):
    """The scenario/spec cannot be lowered onto the planner's model."""


@dataclass(frozen=True)
class PlanConfig:
    """Smoothing and loss-shaping knobs (NOT learnable)."""
    tau: float = 0.05           # shared relaxation temperature
    band_frac: float = 2e-3     # soft-quantile kernel bandwidth fraction
    cmax: int = 64              # Erlang-C truncation (matches runtime)
    penalty: float = 25.0       # SLO-violation softplus weight
    slo_scale: float = 0.05     # softplus width, as a fraction of target
    cost_weight: float = 1.0    # fleet-size cost weight
    reject_weight: float = 2.0  # admission-rejection cost weight
    hedge_weight: float = 0.5   # duplicate-load cost weight


@dataclass
class PlanData:
    """Frozen scenario data the surrogate closes over."""
    scenario: str
    objective: str
    slo: float
    target: float               # threshold for the chosen objective
    duration: float
    dt: float
    pooled: bool                # request-level routing -> pooled Erlang
    unit_c: float               # concurrency slots per server
    n_ref: float                # scenario's reference server count
    m_bar: float                # E[service work] (noise folded in)
    e2_bar: float               # E[work^2]
    lam: np.ndarray             # [T] offered QPS per slot
    centers: np.ndarray         # [T] slot centers (s)
    scale_base: float = 0.0     # autoscale base fleet (servers)
    scale_extra: float = 0.0    # autoscale extra fleet (servers)
    # one reparameterized draw batch (primary + hedge twin)
    ts: np.ndarray = None       # [K] arrival slot index
    svc: np.ndarray = None      # [K] service demand (s)
    u: np.ndarray = None        # [K] queue-indicator uniform
    g: np.ndarray = None        # [K] conditional-wait exponential
    svc2: np.ndarray = None
    u2: np.ndarray = None
    g2: np.ndarray = None


def build_plan_data(scenario: str, *, slo: float, objective: str = "p99",
                    target: Optional[float] = None, overrides=None,
                    autoscale=None, seed: int = 0, dt: float = 0.005,
                    samples: int = 16384) -> PlanData:
    """Compile ``scenario`` and freeze the surrogate's inputs.

    The draw batch is reparameterized: gradients flow through the
    deterministic map from parameters to latency at FIXED noise, so
    every optimizer step sees the same stochastic landscape.
    """
    from repro_torch.scenarios import get

    if objective not in OBJECTIVES:
        raise PlanError(f"unknown objective {objective!r}; "
                        f"one of {OBJECTIVES}")
    if not slo or slo <= 0.0:
        raise PlanError("capacity planning needs a positive SLO")
    exp = get(scenario, seed=int(seed), **dict(overrides or {})).compile()
    prog = compile_experiment(exp, dt=dt)
    if prog.batched:
        raise PlanError("the surrogate models scalar service laws only "
                        "(batched serving has no smoothed law yet)")
    lam = prog.rate_conn.sum(axis=1) + prog.rate_free
    if float(lam.sum()) * dt <= 0.0:
        raise PlanError(f"scenario {scenario!r} offers no load")
    # fold the mean multiplicative execution-noise factor into demand
    nf1 = float(np.mean(np.exp(prog.noise_sigma ** 2 / 2.0)))
    m_bar = float(np.mean(prog.work_mean))
    e2_bar = float(np.mean(prog.work_var + prog.work_mean ** 2))
    centers = (np.arange(prog.n_slots) + 0.5) * dt

    rng = np.random.default_rng((0x9A71, int(seed), 0))
    w = np.maximum(lam, 0.0) * dt
    cum = np.cumsum(w)
    K = int(samples)
    ts = np.searchsorted(cum, rng.random(K) * cum[-1], side="right")
    ts = np.minimum(ts, prog.n_slots - 1).astype(np.int64)
    svc = prog.profile.sample_batch(rng, K) * nf1
    u = rng.random(K)
    g = rng.standard_exponential(K)
    svc2 = prog.profile.sample_batch(rng, K) * nf1
    u2 = rng.random(K)
    g2 = rng.standard_exponential(K)

    if target is None:
        target = 0.05 if objective == "slo_frac" else float(slo)
    base, extra = (0.0, 0.0) if autoscale is None \
        else (float(autoscale[0]), float(autoscale[1]))
    return PlanData(
        scenario=scenario, objective=objective, slo=float(slo),
        target=float(target), duration=prog.duration, dt=dt,
        pooled=bool(prog.rate_free.sum() > 0.0),
        unit_c=float(prog.workers.mean()), n_ref=float(prog.n_servers),
        m_bar=m_bar, e2_bar=e2_bar, lam=lam, centers=centers,
        scale_base=base, scale_extra=extra,
        ts=ts, svc=svc, u=u, g=g, svc2=svc2, u2=u2, g2=g2)


# ---------------------------------------------------------------------------
# Smoothed forward pass (torch)
# ---------------------------------------------------------------------------
def _frame(params: dict) -> tuple:
    """(dtype, device) of the surrogate: the first tensor parameter's,
    or f32 on the CPU when every parameter is a Python number."""
    for v in params.values():
        if torch.is_tensor(v):
            return v.dtype, v.device
    return torch.float32, torch.device("cpu")


def _clip(x, lo: float, hi: float):
    """``jnp.clip(x, lo, hi)``: ``minimum(hi, maximum(lo, x))``, so the
    gradient splits evenly at either bound as jnp's does."""
    x = torch.as_tensor(x)
    return torch.minimum(x.new_full((), hi),
                         torch.maximum(x.new_full((), lo), x))


def device_draws(data: PlanData, dtype: torch.dtype,
                 device) -> dict:
    """``data``'s frozen arrays as tensors of the surrogate's ``dtype``
    on ``device`` (the slot index ``ts`` int64), with each draw's
    arrival instant ``arrive = centers[ts]`` — what
    ``surrogate_metrics`` reads, made once per optimizer loop."""
    def put(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    ts = torch.as_tensor(data.ts, device=device)
    out = {k: put(getattr(data, k))
           for k in ("lam", "svc", "u", "g", "svc2", "u2", "g2")}
    out["ts"] = ts
    out["arrive"] = put(data.centers)[ts]
    return out


def fluid_backlog(work: torch.Tensor, cap: torch.Tensor,
                  dt: float) -> torch.Tensor:
    """[T] fluid backlog of the Lindley recursion ``U_t = max(U_{t-1} +
    (work_t - cap_t) dt, 0)`` from ``U = 0``, in closed form:
    ``U_t = S_t - min(0, min_{s<=t} S_s)`` with ``S`` the running sum of
    ``(work - cap) dt``.  Computed in f64, returned in ``work``'s dtype;
    differentiable through ``cumsum`` and ``cummin``."""
    S = torch.cumsum((work.to(torch.float64) - cap.to(torch.float64))
                     * dt, dim=0)
    low = torch.cummin(S, dim=0).values
    U = S - torch.minimum(low, S.new_zeros(()))
    return U.to(work.dtype)


def _capacity_profile(params: dict, data: PlanData, cfg: PlanConfig,
                      lam: torch.Tensor) -> torch.Tensor:
    """[T] fleet capacity (work-seconds per second) from the learnable
    parameters — constant for a ``capacity`` plan, load-tracking for an
    autoscale-threshold plan."""
    thr = params.get("scale_threshold")
    if thr is not None:
        base = data.scale_base * data.unit_c
        extra = data.scale_extra * data.unit_c
        util = lam * data.m_bar / max(base, _EPS)
        return base + extra * stable_sigmoid(torch, (util - thr) / cfg.tau)
    return params["capacity"] * data.unit_c + 0.0 * lam


def surrogate_metrics(params: dict, data: PlanData, cfg: PlanConfig,
                      draws: Optional[dict] = None) -> dict:
    """Smoothed metrics as 0-d tensors — differentiable in every entry
    of ``params``.  Keys: p50/p95/p99/mean/slo_frac plus the fleet/rho
    diagnostics the loss and reports consume.  ``draws`` is
    ``device_draws(data, ...)`` in the parameters' dtype and device;
    without it they are made for this call."""
    dtype, device = _frame(params)
    if draws is None:
        draws = device_draws(data, dtype, device)

    lam = draws["lam"]
    admit = params.get("admit")
    if admit is not None:
        lam = lam * _clip(admit, 0.0, 1.0)
    cap = _capacity_profile(params, data, cfg, lam)
    work = lam * data.m_bar
    rho = smooth_rho(torch, work / torch.clamp(cap, min=_EPS), cfg.tau)
    if data.pooled:
        c_eff = smooth_min(torch, cap, float(cfg.cmax), cfg.tau * cfg.cmax)
        cap_wait = cap
    else:
        c_one = min(data.unit_c, float(cfg.cmax))
        c_eff = torch.full_like(cap, c_one)
        cap_wait = torch.full_like(cap, data.unit_c)
    pC = soft_erlang_c(torch, c_eff, rho, cfg.cmax, cfg.tau)
    resid = data.e2_bar / (2.0 * data.m_bar)
    w_cond = resid / torch.clamp(cap_wait * (1.0 - rho), min=_EPS)
    wait_fluid = fluid_backlog(work, cap, data.dt) \
        / torch.clamp(cap, min=_EPS)

    ts = draws["ts"]
    wf_ts, pC_ts, wc_ts = wait_fluid[ts], pC[ts], w_cond[ts]
    lat = (wf_ts
           + stable_sigmoid(torch, (pC_ts - draws["u"]) / cfg.tau)
           * draws["g"] * wc_ts
           + draws["svc"])
    hedge = params.get("hedge_delay")
    dup_frac = torch.zeros((), dtype=dtype, device=device)
    if hedge is not None:
        lat2 = (wf_ts
                + stable_sigmoid(torch, (pC_ts - draws["u2"]) / cfg.tau)
                * draws["g2"] * wc_ts
                + draws["svc2"])
        width = cfg.tau * data.m_bar + _EPS
        dup_frac = torch.mean(stable_sigmoid(torch, (lat - hedge) / width))
        lat = smooth_min(torch, lat, hedge + lat2, width)
    arrive = draws["arrive"]
    w_keep = stable_sigmoid(
        torch, (data.duration - (arrive + lat)) / (4.0 * data.dt))
    qs = soft_quantiles(lat[None, :], w_keep[None, :], qs=PLAN_QS,
                        band_frac=cfg.band_frac)[0]
    n_eff = torch.clamp(torch.sum(w_keep), min=_EPS)
    mean = torch.sum(w_keep * lat) / n_eff
    width = cfg.slo_scale * data.slo
    slo_frac = torch.sum(
        w_keep * stable_sigmoid(torch, (lat - data.slo) / width)) / n_eff
    return {"p50": qs[0], "p95": qs[1], "p99": qs[2], "mean": mean,
            "slo_frac": slo_frac, "n_eff": n_eff,
            "fleet": torch.mean(cap) / data.unit_c,
            "rho_max": torch.max(rho), "dup_frac": dup_frac}


def plan_loss(params: dict, data: PlanData, cfg: PlanConfig,
              draws: Optional[dict] = None) -> tuple:
    """Scalar planning loss -> ``(loss, metrics)``: provisioning cost
    plus a softplus barrier on the objective metric exceeding its
    target, so the minimum sits where the metric just meets the
    target.  ``draws`` as in ``surrogate_metrics``."""
    m = surrogate_metrics(params, data, cfg, draws)
    scale = cfg.slo_scale * max(data.target, 1e-6)
    over = softplus(torch, (m[data.objective] - data.target) / scale)
    cost = cfg.cost_weight * m["fleet"] / data.n_ref
    admit = params.get("admit")
    if admit is not None:
        cost = cost + cfg.reject_weight * (1.0 - _clip(admit, 0.0, 1.0))
    if "hedge_delay" in params:
        cost = cost + cfg.hedge_weight * m["dup_frac"]
    return cost + cfg.penalty * over, m


# ---------------------------------------------------------------------------
# Hard twin (numpy) + the analytic oracle
# ---------------------------------------------------------------------------
_HARD_TAU = 1e-4


def hard_metrics(params: dict, data: PlanData,
                 cfg: Optional[PlanConfig] = None) -> dict:
    """The same sample model with HARD operators (the tau -> 0 limit of
    ``surrogate_metrics``): hard Bernoulli queue indicator, clipped
    utilization, exact percentile extraction, hard censoring.  NumPy,
    and the reference the agreement tests and the analytic bisection
    oracle run against."""
    cfg = cfg or PlanConfig()
    lam = np.asarray(data.lam, float)
    admit = params.get("admit")
    if admit is not None:
        lam = lam * np.clip(float(admit), 0.0, 1.0)
    thr = params.get("scale_threshold")
    if thr is not None:
        base = data.scale_base * data.unit_c
        extra = data.scale_extra * data.unit_c
        util = lam * data.m_bar / max(base, _EPS)
        cap = base + extra * (util > float(thr))
    else:
        cap = float(params["capacity"]) * data.unit_c + 0.0 * lam
    work = lam * data.m_bar
    rho = np.clip(work / np.maximum(cap, _EPS), 1e-9, RHO_MAX)
    if data.pooled:
        c_eff = np.minimum(cap, float(cfg.cmax))
        cap_wait = cap
    else:
        c_eff = np.full_like(cap, min(data.unit_c, float(cfg.cmax)))
        cap_wait = np.full_like(cap, data.unit_c)
    pC = soft_erlang_c(np, c_eff, rho, cfg.cmax, _HARD_TAU)
    resid = data.e2_bar / (2.0 * data.m_bar)
    w_cond = resid / np.maximum(cap_wait * (1.0 - rho), _EPS)
    U = np.zeros_like(work)
    acc = 0.0
    for t in range(work.size):
        acc = max(acc + (work[t] - cap[t]) * data.dt, 0.0)
        U[t] = acc
    wait_fluid = U / np.maximum(cap, _EPS)

    ts = data.ts
    lat = (wait_fluid[ts] + (data.u < pC[ts]) * data.g * w_cond[ts]
           + data.svc)
    hedge = params.get("hedge_delay")
    if hedge is not None:
        lat2 = (wait_fluid[ts] + (data.u2 < pC[ts]) * data.g2 * w_cond[ts]
                + data.svc2)
        lat = np.minimum(lat, float(hedge) + lat2)
    keep = (data.centers[ts] + lat) <= data.duration
    kept = lat[keep]
    if kept.size == 0:
        nanq = float("nan")
        return {"p50": nanq, "p95": nanq, "p99": nanq, "mean": nanq,
                "slo_frac": nanq, "n_eff": 0.0}
    q = quantiles_partition(kept, PLAN_QS)
    return {"p50": float(q[0]), "p95": float(q[1]), "p99": float(q[2]),
            "mean": float(kept.mean()),
            "slo_frac": float(np.mean(kept > data.slo)),
            "n_eff": float(kept.size)}


def analytic_capacity(data: PlanData, cfg: Optional[PlanConfig] = None,
                      lo: float = 0.5, hi: float = 64.0,
                      tol: float = 1e-3, iters: int = 60) -> float:
    """Smallest continuous capacity whose HARD objective metric meets
    the target — bisection on ``hard_metrics`` (the metric is monotone
    non-increasing in capacity under the frozen draws)."""
    cfg = cfg or PlanConfig()

    def metric(x: float) -> float:
        return hard_metrics({"capacity": x}, data, cfg)[data.objective]

    if metric(hi) > data.target:
        return hi                   # infeasible inside the box
    for _ in range(iters):
        if hi - lo <= tol:
            break
        mid = 0.5 * (lo + hi)
        if metric(mid) <= data.target:
            hi = mid
        else:
            lo = mid
    return hi
