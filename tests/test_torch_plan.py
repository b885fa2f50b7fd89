"""The port's gradient capacity planner (``repro_torch.plan``) against
the JAX package's (``repro.plan``), on the CPU.

Parity contracts, each with its tolerance:

* ``build_plan_data`` arrays, ``hard_metrics`` and
  ``analytic_capacity`` bit-identical to the reference's;
* ``surrogate_metrics`` and ``plan_loss`` at f32 within rtol 1e-4 of
  JAX's (x32), at capacities 2.0, 3.5, 6.0 and with ``hedge_delay``,
  ``admit`` and ``scale_threshold`` plans; their gradients within rtol
  1e-3 of ``jax.grad``'s.  At capacity 2.0 (deep overload, a loss of
  ~8e4) the two f32 gradients lie on opposite sides of the f64 one,
  5e-4 and 7e-4 from it (1.2e-3 apart, observed): there the port's is
  held to the reference's f64 gradient within 1e-3;
* f64 gradients against central differences under the reference's own
  tolerances (``tests/test_plan.py``) and within rtol 1e-6 of the
  reference's f64 gradients, computed in a subprocess with
  ``jax.config.update("jax_enable_x64", True)``;
* the fluid backlog's Lindley closed form against a sequential f64 loop
  (rtol 1e-12) and JAX's f32 ``lax.scan`` (rtol 1e-5, plus an atol of
  1e-5 x the largest backlog where a queue empties and restarts: the
  scan's f32 rounding is absolute there);
* ``run_plan`` without verification at the reference test's size
  (steps 60, starts 2, samples 4096): final parameters within 1e-2
  servers of JAX's (observed 2e-6) and loss histories within rtol 1e-3
  (observed 7e-6);
* ``run_plan`` with the exact ladder at bench_plan's smoke size: the
  same probes ``(n, meets)``, ``n_star`` and ``cell_evals`` as JAX's,
  verified values within rtol 1e-6 of JAX ``impl="ref"`` (observed
  bit-identical);
* ``run_sweep(mode="optimize")`` frames against ``repro.sweep``'s: row
  order and phases equal, metrics within the tolerances above.

Plus: bad specs raise ``PlanError``, ``cache=`` serves the ladder's cells
(``cell_evals`` counts only the rest), the optimizer against ``repro.training
.optimizer``, and the CLI with ``--device cpu`` in a subprocess (and
without a card and without it, a refusal).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import plan as jplan  # noqa: E402
from repro.sweep import Sweep as JSweep  # noqa: E402
from repro.sweep import run_sweep as jax_run_sweep  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.vector import VectorConfig as JaxConfig  # noqa: E402

from repro_torch import plan  # noqa: E402
from repro_torch.plan import model  # noqa: E402
from repro_torch.sweep import Sweep, run_sweep  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.vector import VectorConfig  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(REPO, "src")
CPU = VectorConfig(device="cpu")
JAX_REF = JaxConfig(backend="jax", impl="ref")

#: the reference test's steady problem
STEADY_OV = {"duration": 6.0, "qps": 2600.0, "policy": "jsq",
             "n_clients": 8}
#: bench_plan's smoke problem
SMOKE_OV = {"duration": 5.0, "qps": 2600.0, "policy": "jsq",
            "n_clients": 8}
SMOKE_KW = dict(scenario="steady", objective="p99", slo=0.02,
                overrides=SMOKE_OV, steps=50, starts=1, samples=2048,
                probe_reps=2, reps=3)

_DATA_CASES = {
    "steady-jsq": dict(scenario="steady", slo=0.02, overrides=STEADY_OV,
                       samples=4096),
    "steady-rr-slo_frac": dict(scenario="steady", slo=0.05,
                               objective="slo_frac",
                               overrides={"duration": 4.0}, samples=1024,
                               seed=3),
    "steady-autoscale": dict(scenario="steady", slo=0.02,
                             overrides=STEADY_OV, samples=4096,
                             autoscale=(3, 3)),
    "flash-crowd": dict(scenario="flash-crowd", slo=0.05,
                        overrides={"duration": 9.0}, samples=2048, seed=1),
}


def _data(case: str, pkg):
    kw = dict(_DATA_CASES[case])
    return pkg.build_plan_data(kw.pop("scenario"), **kw)


@pytest.mark.parametrize("case", sorted(_DATA_CASES))
def test_build_plan_data_bit_identical(case):
    got, want = _data(case, plan), _data(case, jplan)
    for f in want.__dataclass_fields__:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f
        else:
            assert g == w, f


#: plans held against the reference (learnable values at f32)
PLANS = {
    "capacity-2.0": {"capacity": 2.0},
    "capacity-3.5": {"capacity": 3.5},
    "capacity-6.0": {"capacity": 6.0},
    "hedge": {"capacity": 4.0, "hedge_delay": 0.01},
    "admit": {"capacity": 3.5, "admit": 0.9},
    "admit-at-bound": {"capacity": 4.0, "admit": 1.0},
    "scale_threshold": {"scale_threshold": 0.7},
}


def _plan_data(name: str, pkg):
    auto = (3, 3) if name == "scale_threshold" else None
    return pkg.build_plan_data("steady", slo=0.02, overrides=STEADY_OV,
                               samples=4096, autoscale=auto)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_hard_metrics_bit_identical(name):
    p = PLANS[name]
    assert model.hard_metrics(p, _plan_data(name, plan)) == \
        jplan.hard_metrics(p, _plan_data(name, jplan))


def test_analytic_capacity_bit_identical():
    got = model.analytic_capacity(_plan_data("capacity-3.5", plan))
    want = jplan.analytic_capacity(_plan_data("capacity-3.5", jplan))
    assert got == want
    data = _plan_data("capacity-3.5", plan)
    below = model.hard_metrics({"capacity": 0.8 * got}, data)["p99"]
    at = model.hard_metrics({"capacity": got}, data)["p99"]
    assert at <= data.target < below


@pytest.mark.parametrize("name", sorted(PLANS))
def test_surrogate_and_loss_match_jax_f32(name):
    p = PLANS[name]
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    tp = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
          for k, v in p.items()}
    jdata, tdata = _plan_data(name, jplan), _plan_data(name, plan)
    cfg = jplan.PlanConfig()
    (jl, jm), jg = jax.value_and_grad(
        lambda q: jplan.plan_loss(q, jdata, cfg), has_aux=True)(jp)
    tl, tm = plan.plan_loss(tp, tdata, model.PlanConfig())
    tg = torch.autograd.grad(tl, list(tp.values()))
    assert tl.dtype == torch.float32
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-4)
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k].detach()) == pytest.approx(float(jm[k]),
                                                      rel=1e-4,
                                                      abs=1e-12), k
    sm = plan.surrogate_metrics({k: v.detach() for k, v in tp.items()},
                                tdata, model.PlanConfig())
    for k in sm:
        assert float(sm[k]) == float(tm[k].detach())
    if name == "capacity-2.0":
        return          # held to the f64 gradient instead (module doc)
    for k, g in zip(tp, tg):
        assert float(g) == pytest.approx(float(jg[k]), rel=1e-3), k


@pytest.mark.parametrize("name", sorted(PLANS))
def test_device_draws_made_once_are_bit_identical(name):
    """``run_plan`` puts the frozen draws on the device once and passes
    them to every step: the loss, metrics and gradients equal those of
    a call that makes its own, bit for bit, on two successive steps."""
    data = _plan_data(name, plan)
    cfg = model.PlanConfig()
    draws = model.device_draws(data, torch.float32, torch.device("cpu"))
    assert all(v.dtype == (torch.int64 if k == "ts" else torch.float32)
               for k, v in draws.items())
    for scale in (1.0, 1.1):
        tp = {k: torch.tensor(v * scale, dtype=torch.float32,
                              requires_grad=True)
              for k, v in PLANS[name].items()}
        own_l, own_m = plan.plan_loss(tp, data, cfg)
        own_g = torch.autograd.grad(own_l, list(tp.values()))
        l, m = plan.plan_loss(tp, data, cfg, draws)
        g = torch.autograd.grad(l, list(tp.values()))
        assert float(l) == float(own_l)
        assert {k: float(v) for k, v in m.items()} == \
            {k: float(v) for k, v in own_m.items()}
        assert [float(x) for x in g] == [float(x) for x in own_g]


# ---------------------------------------------------------------------------
# f64: central differences and the reference's own f64 gradients
# ---------------------------------------------------------------------------
FD_X = (2.0, 3.5, 6.0)
_REF64 = """
import json, sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from repro.plan import PlanConfig, build_plan_data, plan_loss
ov = {ov!r}
out = {{}}
d = build_plan_data("steady", slo=0.02, overrides=ov, samples=2048)
for x in {xs!r}:
    out[f"capacity@{{x}}"] = float(jax.grad(
        lambda c: plan_loss({{"capacity": c}}, d, PlanConfig())[0])(
            jnp.asarray(x, jnp.float64)))
h = build_plan_data("steady", slo=0.02, overrides=ov, samples=2048)
g = jax.grad(lambda p: plan_loss(p, h, PlanConfig())[0])(
    {{"capacity": jnp.asarray(4.0, jnp.float64),
      "hedge_delay": jnp.asarray(0.01, jnp.float64),
      "admit": jnp.asarray(0.9, jnp.float64)}})
for k, v in g.items():
    out[f"multi:{{k}}"] = float(v)
print(json.dumps(out))
"""
FD_OV = {"duration": 4.0, "qps": 2200.0, "policy": "jsq", "n_clients": 8}


@pytest.fixture(scope="module")
def ref_f64_grads():
    code = _REF64.format(ov=FD_OV, xs=FD_X)
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC,
                                  JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _loss64(data, **params):
    p = {k: torch.tensor(v, dtype=torch.float64, requires_grad=True)
         for k, v in params.items()}
    val = plan.plan_loss(p, data, model.PlanConfig())[0]
    assert val.dtype == torch.float64
    return val, p


def test_fd_plan_loss_end_to_end_f64(ref_f64_grads):
    """d(plan_loss)/d(capacity) in f64 against central differences
    through fluid backlog, Erlang head, censoring and the quantile
    surrogate (the reference's eps 1e-4, rtol 2e-2), and within rtol
    1e-6 of the reference's f64 gradient."""
    data = plan.build_plan_data("steady", slo=0.02, overrides=FD_OV,
                                samples=2048)
    for x0 in FD_X:
        val, p = _loss64(data, capacity=x0)
        g = float(torch.autograd.grad(val, [p["capacity"]])[0])
        eps = 1e-4
        with torch.no_grad():
            fd = (float(_loss64(data, capacity=x0 + eps)[0])
                  - float(_loss64(data, capacity=x0 - eps)[0])) / (2 * eps)
        assert abs(g - fd) <= 2e-2 * max(abs(fd), abs(g)) + 1e-8, (x0, g, fd)
        assert g == pytest.approx(ref_f64_grads[f"capacity@{x0}"],
                                  rel=1e-6)


def test_f64_gradients_of_a_multi_parameter_plan(ref_f64_grads):
    data = plan.build_plan_data("steady", slo=0.02, overrides=FD_OV,
                                samples=2048)
    val, p = _loss64(data, capacity=4.0, hedge_delay=0.01, admit=0.9)
    grads = torch.autograd.grad(val, list(p.values()))
    for k, g in zip(p, grads):
        assert float(g) == pytest.approx(ref_f64_grads[f"multi:{k}"],
                                         rel=1e-6), k


def test_capacity_2_gradient_against_reference_f64(ref_f64_grads):
    """The f32 gradient in deep overload, held to the f64 one (module
    doc)."""
    data = plan.build_plan_data("steady", slo=0.02, overrides=FD_OV,
                                samples=2048)
    c = torch.tensor(2.0, requires_grad=True)
    val = plan.plan_loss({"capacity": c}, data, model.PlanConfig())[0]
    g = float(torch.autograd.grad(val, [c])[0])
    assert g == pytest.approx(ref_f64_grads["capacity@2.0"], rel=1e-3)


# ---------------------------------------------------------------------------
# The fluid backlog: Lindley closed form
# ---------------------------------------------------------------------------
def _scan_f32(work: np.ndarray, cap: np.ndarray, dt: float) -> np.ndarray:
    """The reference surrogate's ``lax.scan`` backlog, in f32."""
    def step(carry, xs):
        w_in, cp = xs
        u = jnp.maximum(carry + (w_in - cp) * dt, 0.0)
        return u, u
    _, U = jax.lax.scan(step, jnp.zeros((), jnp.float32),
                        (jnp.asarray(work), jnp.asarray(cap)))
    return np.asarray(U)


def _backlog_cases():
    d = plan.build_plan_data("steady", slo=0.02, overrides=STEADY_OV,
                             samples=64)
    lam = d.lam.astype(np.float32) * np.float32(d.m_bar)
    t = np.arange(2400)
    r = np.random.default_rng(7)
    wave = (1.0 + 0.5 * np.sin(2 * np.pi * t / 600)
            + 0.05 * r.standard_normal(t.size)).astype(np.float32)
    return {"steady@2.0": (lam, np.full_like(lam, 2.0), d.dt),
            "steady@3.5": (lam, np.full_like(lam, 3.5), d.dt),
            "steady@6.0": (lam, np.full_like(lam, 6.0), d.dt),
            "wave": (wave, np.full_like(wave, 1.02), 0.005)}


@pytest.mark.parametrize("case", sorted(_backlog_cases()))
def test_fluid_backlog_closed_form(case):
    work, cap, dt = _backlog_cases()[case]
    w64, c64 = work.astype(np.float64), cap.astype(np.float64)
    seq = np.zeros_like(w64)
    acc = 0.0
    for t in range(w64.size):
        acc = max(acc + (w64[t] - c64[t]) * dt, 0.0)
        seq[t] = acc
    U64 = model.fluid_backlog(torch.from_numpy(w64), torch.from_numpy(c64),
                              dt).numpy()
    np.testing.assert_allclose(U64, seq, rtol=1e-12, atol=0.0)
    U32 = model.fluid_backlog(torch.from_numpy(work), torch.from_numpy(cap),
                              dt).numpy()
    assert U32.dtype == np.float32
    J = _scan_f32(work, cap, dt)
    restarts = bool(((J[1:] > 0) & (J[:-1] == 0)).sum() > 1)
    atol = 1e-5 * float(J.max()) if restarts else 0.0
    np.testing.assert_allclose(U32, J, rtol=1e-5, atol=atol)
    assert np.array_equal(U32 == 0, J == 0)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------
def test_lr_schedule_constant_vs_cosine():
    const = opt.OptConfig(lr=0.1, warmup_steps=10, total_steps=100,
                          schedule="constant")
    cosine = opt.OptConfig(lr=0.1, warmup_steps=10, total_steps=100,
                           schedule="cosine")
    step = torch.tensor(80, dtype=torch.int32)
    assert float(opt.lr_at(const, step)) == pytest.approx(0.1)
    assert float(opt.lr_at(cosine, step)) < 0.1
    early = torch.tensor(5, dtype=torch.int32)
    assert float(opt.lr_at(const, early)) == pytest.approx(0.05)
    with pytest.raises(ValueError):
        opt.lr_at(opt.OptConfig(schedule="linear"), step)
    for s in (0, 1, 5, 10, 37, 99, 100, 130):
        for c in (const, cosine):
            jc = jopt.OptConfig(**c.__dict__)   # lr_at reads no other field
            assert float(opt.lr_at(c, torch.tensor(s, dtype=torch.int32))) \
                == pytest.approx(float(jopt.lr_at(
                    jc, jnp.asarray(s, jnp.int32))), rel=1e-6)


def test_adamw_matches_reference():
    """Twenty clipped AdamW steps over a dict of 0-d f32 parameters on
    fixed gradients: the reference's update within rtol 1e-6."""
    # the planner's choices: no decay, both moments in f32
    cfg = opt.OptConfig(lr=0.15, grad_clip=5.0, warmup_steps=3,
                        total_steps=20, weight_decay=0.0, m_dtype="float32",
                        v_dtype="float32")
    jcfg = jopt.OptConfig(**cfg.__dict__)
    init = {"capacity": 4.0, "admit": 0.9, "hedge_delay": 0.05}
    tp = {k: torch.tensor(v) for k, v in init.items()}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in init.items()}
    ts, js = opt.init_opt_state(tp, cfg), jopt.init_opt_state(jp, jcfg)
    r = np.random.default_rng(11)
    for _ in range(20):
        g = {k: np.float32(r.normal(scale=4.0)) for k in init}
        tp, ts, tmet = opt.adamw_update(tp, {k: torch.tensor(v)
                                             for k, v in g.items()}, ts, cfg)
        jp, js, jmet = jopt.adamw_update(jp, {k: jnp.asarray(v)
                                              for k, v in g.items()},
                                         js, jcfg)
        for k in init:
            assert float(tp[k]) == pytest.approx(float(jp[k]), rel=1e-6)
        assert float(tmet["grad_norm"]) == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 20


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------
def test_run_plan_continuous_phase_matches_reference():
    """verify=False at the reference test's size: each start's final
    parameters within 1e-2 servers of JAX's, loss histories within rtol
    1e-3; the reference test's own contracts hold."""
    kw = dict(scenario="steady", objective="p99", slo=0.02,
              overrides=STEADY_OV, steps=60, starts=2, samples=4096,
              verify=False)
    got = plan.run_plan(plan.PlanSpec(**kw), vector_config=CPU)
    want = jplan.run_plan(jplan.PlanSpec(**kw))
    assert got.best_start == want.best_start
    for g, w in zip(got.starts, want.starts):
        assert abs(g["params"]["capacity"] - w["params"]["capacity"]) <= 1e-2
        np.testing.assert_allclose(g["history"], w["history"], rtol=1e-3)
        assert g["loss"] == pytest.approx(w["loss"], rel=1e-3)
    data = plan.build_plan_data("steady", slo=0.02, overrides=STEADY_OV,
                                samples=4096)
    x_a = plan.analytic_capacity(data)
    x = got.params["capacity"]
    assert abs(x - x_a) <= max(0.75, 0.25 * x_a), (x, x_a)
    hist = got.starts[got.best_start]["history"]
    assert hist[-1] < hist[0]
    assert got.verified is None and got.cell_evals == 0
    assert got.spec["target"] == 0.02


def test_run_plan_ladder_matches_reference():
    """bench_plan's smoke problem end to end: the integer ladder on the
    exact runtime makes the reference's decisions."""
    got = plan.run_plan(plan.PlanSpec(**SMOKE_KW), vector_config=CPU)
    want = jplan.run_plan(jplan.PlanSpec(**SMOKE_KW), vector_config=JAX_REF)
    assert [(p["n"], p["meets"]) for p in got.probes] == \
        [(p["n"], p["meets"]) for p in want.probes]
    assert got.n_star == want.n_star and got.feasible == want.feasible
    assert got.cell_evals == want.cell_evals == \
        len(got.probes) * SMOKE_KW["probe_reps"] + SMOKE_KW["reps"]
    np.testing.assert_allclose(got.verified["values"],
                               want.verified["values"], rtol=1e-6)
    for g, w in zip(got.probes, want.probes):
        assert g["mean"] == pytest.approx(w["mean"], rel=1e-6)
    assert abs(got.params["capacity"] - want.params["capacity"]) <= 1e-2
    # below the answer was probed and missed
    below = [p for p in got.probes if p["n"] == got.n_star - 1]
    assert below and not below[-1]["meets"]


def test_run_plan_rejects_bad_specs():
    with pytest.raises(model.PlanError):
        plan.run_plan(plan.PlanSpec(params={"warp": (1.0, 0.0, 2.0)}),
                      vector_config=CPU)
    with pytest.raises(model.PlanError):
        plan.run_plan(plan.PlanSpec(params={"scale_threshold": None}),
                      vector_config=CPU)
    with pytest.raises(model.PlanError):
        plan.run_plan(plan.PlanSpec(objective="p42"), vector_config=CPU)
    with pytest.raises(model.PlanError):
        plan.run_plan(plan.PlanSpec(params={}), vector_config=CPU)
    with pytest.raises(model.PlanError):
        plan.build_plan_data("steady", slo=0.02, objective="p42")
    with pytest.raises(model.PlanError):
        plan.build_plan_data("steady", slo=0.0)
    with pytest.raises(model.PlanError):    # no smoothed law for batched
        plan.build_plan_data("batched-serving", slo=0.5,
                             overrides={"duration": 4.0})
    from repro_torch.plan.planner import _ExactEvaluator
    with pytest.raises(model.PlanError, match="exact runtime"):
        _ExactEvaluator(plan.PlanSpec(),
                        VectorConfig(device="cpu", soft=True))


def test_cache_is_not_ported_yet(tmp_path):
    """``cache=`` once raised here; it now serves the ladder's exact
    cells.  Cold, a cache changes no decision and saves only the cells
    the ladder repeats (the final measurement re-reads its fleet's
    probe); warm, every cell is a hit and ``cell_evals`` is 0."""
    from repro_torch.cache import ResultCache
    spec = plan.PlanSpec(**{**SMOKE_KW, "steps": 12, "samples": 512})
    plain = plan.run_plan(spec, vector_config=CPU)
    cold = ResultCache(cache_dir=str(tmp_path))
    res1 = plan.run_plan(spec, vector_config=CPU, cache=cold)
    assert cold.stats.hits == SMOKE_KW["probe_reps"]
    assert res1.cell_evals == plain.cell_evals - SMOKE_KW["probe_reps"]
    warm = ResultCache(cache_dir=str(tmp_path))
    res2 = plan.run_plan(spec, vector_config=CPU, cache=warm)
    assert res2.cell_evals == 0 and warm.stats.misses == 0
    for res in (res1, res2):
        assert res.n_star == plain.n_star
        assert json.dumps(res.probes) == json.dumps(plain.probes)
        assert res.verified["values"] == plain.verified["values"]
    sweep = Sweep(name="plan-steady", factory=None, mode="optimize",
                  optimize={"scenario": "steady", "slo": 0.02, "steps": 12,
                            "starts": 1, "samples": 512,
                            "probe_reps": SMOKE_KW["probe_reps"]},
                  fixed=dict(SMOKE_OV), reps=SMOKE_KW["reps"], base_seed=0)
    frame = plan.run_plan_sweep(sweep, cache=warm, vector_config=CPU)
    assert frame.spec["plan"]["cell_evals"] == 0
    assert frame.spec["plan"]["n_star"] == plain.n_star


def test_objectives_cover_the_vector_summary():
    from repro_torch.vector import VectorResult
    fields = set(VectorResult.__dataclass_fields__)
    for o in plan.OBJECTIVES:
        assert o == "slo_frac" or o in fields
    assert plan.DEFAULT_BOXES == jplan.DEFAULT_BOXES
    assert plan.OBJECTIVES == jplan.OBJECTIVES
    assert model.PlanConfig() == model.PlanConfig(**jplan.PlanConfig(
    ).__dict__)


# ---------------------------------------------------------------------------
# Sweep integration (mode="optimize")
# ---------------------------------------------------------------------------
def _optimize_sweep(cls, **opt_kw):
    block = {"scenario": "steady", "slo": 0.02, "steps": 30, "starts": 1,
             "samples": 2048, "verify": False,
             "params": {"capacity": [4.0, 1.0, 24.0]}, **opt_kw}
    return cls(name="plan-steady", factory=None, mode="optimize",
               optimize=block, fixed=dict(STEADY_OV), reps=3, base_seed=0)


def test_sweep_optimize_spec_validation():
    sweep = _optimize_sweep(Sweep)
    assert sweep.point_dicts() == []
    spec = plan.plan_spec_from_sweep(sweep)
    assert spec.scenario == "steady" and spec.reps == 3
    assert spec.overrides == STEADY_OV
    assert spec.__dict__ == jplan.plan_spec_from_sweep(
        _optimize_sweep(JSweep)).__dict__
    with pytest.raises(model.PlanError):
        plan.plan_spec_from_sweep(_optimize_sweep(Sweep, warp=1))
    bad = _optimize_sweep(Sweep)
    del bad.optimize["slo"]
    with pytest.raises(model.PlanError):
        plan.plan_spec_from_sweep(bad)


@pytest.mark.parametrize("verify", [False, True])
def test_sweep_optimize_frame_matches_reference(verify, tmp_path):
    opt_kw = {"verify": verify}
    fixed = STEADY_OV
    if verify:
        opt_kw.update(steps=50, probe_reps=2)
        fixed = SMOKE_OV
    sw, jsw = _optimize_sweep(Sweep, **opt_kw), _optimize_sweep(JSweep,
                                                                 **opt_kw)
    sw.fixed, jsw.fixed = dict(fixed), dict(fixed)
    frame = run_sweep(sw, progress=None, vector_config=CPU)
    want = jax_run_sweep(jsw, progress=None, vector_config=JAX_REF)
    assert not frame.errors
    assert [(r.index, r.rep, r.seed, r.stream) for r in frame.rows] == \
        [(r.index, r.rep, r.seed, r.stream) for r in want.rows]
    phases = [r.params["phase"] for r in frame.rows]
    assert phases == [r.params["phase"] for r in want.rows]
    assert set(phases) == ({"optimize", "probe", "final"} if verify
                           else {"optimize"})
    for g, w in zip(frame.rows, want.rows):
        assert set(g.params) == set(w.params)
        assert set(g.metrics) == set(w.metrics)
        if g.params["phase"] == "optimize":
            assert abs(g.params["capacity"] - w.params["capacity"]) <= 1e-2
            for k in w.metrics:
                assert g.metrics[k] == pytest.approx(w.metrics[k],
                                                     rel=1e-3, abs=1e-9), k
        else:
            assert g.params == w.params
            for k in w.metrics:
                assert g.metrics[k] == pytest.approx(w.metrics[k],
                                                     rel=1e-6), k
    assert frame.spec["plan"]["n_star"] == want.spec["plan"]["n_star"]
    path = tmp_path / "plan.json"
    frame.to_json(str(path))
    from repro_torch.sweep.results import ResultFrame
    back = ResultFrame.from_json(str(path))
    assert back.spec["plan"]["params"] == frame.spec["plan"]["params"]


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------
def _run(args, env=None, cwd=None):
    env = env or dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, *args], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_plan_cli_on_the_cpu(tmp_path):
    out = _run(["-m", "repro_torch.plan", "steady", "--slo", "0.02",
                "--set", "policy=jsq", "--set", "qps=2600",
                "--set", "duration=5", "--capacity", "4,1,24",
                "--steps", "40", "--starts", "1", "--samples", "2048",
                "--probe-reps", "2", "--reps", "3", "--device", "cpu",
                "--out", str(tmp_path), "--quiet"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "verified fleet: n=4" in out.stdout
    rec = json.loads((tmp_path / "plan_steady.json").read_text())
    assert rec["n_star"] == 4 and rec["feasible"]
    assert rec["cell_evals"] == 2 * len(rec["probes"]) + 3


def test_plan_cli_needs_a_card_or_device_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    out = _run(["-m", "repro_torch.plan", "steady", "--slo", "0.02",
                "--no-verify", "--out", str(tmp_path)], env=env)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert not (tmp_path / "plan_steady.json").exists()


def test_sweep_cli_runs_an_optimize_declaration(tmp_path):
    decl = {"name": "plan-cli", "scenario": "steady", "reps": 3,
            "fixed": dict(SMOKE_OV),
            "optimize": {"slo": 0.02, "steps": 30, "starts": 1,
                         "samples": 1024, "probe_reps": 2,
                         "params": {"capacity": [4.0, 1.0, 24.0]}}}
    path = tmp_path / "decl.json"
    path.write_text(json.dumps(decl))
    out = _run(["-m", "repro_torch.sweep", "--file", str(path), "--device",
                "cpu", "--out", str(tmp_path), "--quiet"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("plan=plan-cli objective=p99 target=0.02")
    assert "verified fleet: n=4" in out.stdout
    assert (tmp_path / "plan-cli.json").exists()
