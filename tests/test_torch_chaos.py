"""The chaos scenarios on the port's vector runtime (CPU) against the
JAX package's, and against the port's own ``sim`` backend.

* Programs: every chaos scenario (and its variants) compiles, through
  the port's scenario layer and compiler, to a ``VectorProgram`` equal
  to the reference's field for field: the standby columns, the
  admission-thinned rates and the controller actions of the fluid
  control pre-pass (``control_actions``) included.
* Rows: the CPU rows equal JAX ``impl="ref"`` rows within rtol 1e-6 (the
  canonical scenarios' tolerances); observed bit-identical.
* ``unsupported``: retries and breakers are recorded, exactly as the
  reference records them.
* Closed loop and fluid equivalence: the port's mirrors of the
  reference's vector-against-``sim`` tests, with their bounds.
"""
from __future__ import annotations

import dataclasses

import pytest

pytest.importorskip("jax")

from repro import scenarios as jsc  # noqa: E402
from repro.vector import compile_experiment as jax_compile  # noqa: E402
from repro.vector import run_cells as jax_run  # noqa: E402
from test_torch_vector_parity import (CPU, JAX_REF,  # noqa: E402
                                      _assert_programs_equal,
                                      _assert_rows_close)

from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.core.harness import ServerSpec  # noqa: E402
from repro_torch.core.runtime import run_scenario  # noqa: E402
from repro_torch.core.scenario import (ClientArrival, Scenario,  # noqa: E402
                                       SetAdmission, SetScale)
from repro_torch.vector import compile_experiment, run_cells  # noqa: E402

CHAOS = [("retry-storm", {}), ("retry-storm", dict(mode="backoff")),
         ("correlated-failure", {}), ("gray-failure", {}),
         ("gray-failure", dict(breaker=True)),
         ("flash-crowd-autoscale", {}),
         ("flash-crowd-autoscale", dict(controller="admission_shedder",
                                        peak_qps=4000.0))]
SHEDDER = dict(controller="admission_shedder", peak_qps=4000.0)


def _programs(name, **kw):
    return (compile_experiment(tsc.get(name, **kw).compile()),
            jax_compile(jsc.get(name, **kw).compile()))


def _vector(sc):
    return run_scenario(sc, "vector", vector_config=CPU)


@pytest.mark.parametrize("name,kw", CHAOS)
def test_program_equal_to_reference(name, kw):
    port, ref = _programs(name, seed=3, **kw)
    _assert_programs_equal(port, ref)
    assert port.control_actions == ref.control_actions
    # the retry and breaker specs of ``unsupported``, field for field
    assert ([dataclasses.asdict(i) for i in port.unsupported]
            == [dataclasses.asdict(i) for i in ref.unsupported])


@pytest.mark.parametrize("kw,kinds", [({}, ["set_scale"] * 2),
                                      (SHEDDER, ["set_admission"] * 8)])
def test_control_actions_at_seed_3(kw, kinds):
    """The controller's actions at full duration: the autoscaler opens
    one standby column and closes it again; the shedder thins admission
    eight times.  Control seqs order them after injections."""
    port, _ = _programs("flash-crowd-autoscale", seed=3, **kw)
    assert [k for _, k, _ in port.control_actions] == kinds
    assert (port.n_slots, port.n_servers) == (9000, 6)
    ts = [t for t, _, _ in port.control_actions]
    assert ts == sorted(ts)
    if not kw:
        assert [p["n"] for _, _, p in port.control_actions] == [3, 2]
        # four standby columns start closed; the first scale opens one
        assert (port.active[0] == [1, 1, 0, 0, 0, 0]).all()
        k = int(ts[0] / port.dt)
        assert (port.active[k] == [1, 1, 1, 0, 0, 0]).all()
    else:
        assert port.admit is not None and port.admit.min() < 1.0
        assert port.shed_rate.max() > 0.0


@pytest.mark.parametrize("name,kw", CHAOS)
def test_rows_match_reference(name, kw):
    port, ref = _programs(name, seed=3, **kw)
    got = run_cells([port], [(3, 1)], CPU)
    want = jax_run([ref], [(3, 1)], JAX_REF)
    _assert_rows_close(got, want)
    g, w = got[0], want[0]
    assert (g.n, g.mean, g.p50, g.p95, g.p99, g.dropped) == \
        (w.n, w.mean, w.p50, w.p95, w.p99, w.dropped)


def test_chaos_grid_rows_match_reference():
    """A grid of the three card grids' scenarios in one ``run_cells``
    call: mixed shapes (T 6000-9000, S 3-6), two reps each."""
    port, ref, seeds = [], [], []
    for i, (name, kw) in enumerate([("flash-crowd-autoscale", {}),
                                    ("flash-crowd-autoscale", SHEDDER),
                                    ("correlated-failure", {}),
                                    ("gray-failure", {})]):
        for rep in range(2):
            seed = 100 * i + rep
            p, r = _programs(name, seed=seed, **kw)
            port.append(p)
            ref.append(r)
            seeds.append((seed, rep))
    _assert_rows_close(run_cells(port, seeds, CPU),
                       jax_run(ref, seeds, JAX_REF))


@pytest.mark.parametrize("name,kw,kinds", [
    ("retry-storm", {}, ["set_retry"]),
    ("retry-storm", dict(mode="backoff"), ["set_retry"]),
    ("gray-failure", dict(breaker=True), ["set_retry", "set_breaker"]),
    ("gray-failure", {}, [])])
def test_unsupported_recorded_as_reference(name, kw, kinds):
    sc = tsc.get(name, seed=3, duration=8.0, **kw)
    vec = _vector(sc)
    assert [i.kind for i in vec.unsupported] == kinds
    ref = jax_compile(jsc.get(name, seed=3, duration=8.0, **kw).compile())
    assert [i.kind for i in ref.unsupported] == kinds
    for a, b in zip(vec.unsupported, ref.unsupported):
        spec_a = next(iter(a.params.values()))
        spec_b = next(iter(b.params.values()))
        assert vars(spec_a) == vars(spec_b)


def test_correlated_failure_lowers_to_ordered_same_t_injections():
    exp = tsc.get("correlated-failure", seed=3).compile()
    fails = [i for i in exp.injections if i.kind == "server_fail"]
    assert [i.params["server_id"] for i in fails] == [2, 3]
    assert fails[0].at == fails[1].at and fails[0].seq < fails[1].seq
    prog = compile_experiment(exp)
    k = int(fails[0].at / prog.dt)
    assert list(prog.fail_slot) == [-1, -1, k, k, -1, -1]
    assert (prog.active[k:, 2:4] == 0).all()


# ---------------------------------------------------------------------------
# Mirrors of the reference's closed-loop and fluid-equivalence tests
# ---------------------------------------------------------------------------
def test_autoscaler_runs_closed_loop_on_sim():
    rt = run_scenario(tsc.get("flash-crowd-autoscale", seed=3), "sim")
    assert "set_scale" in {k for _, k, _ in rt.control_log}
    assert max(p["n"] for _, k, p in rt.control_log if k == "set_scale") > 2
    rt2 = run_scenario(tsc.get("flash-crowd-autoscale", seed=3), "sim")
    assert rt.control_log == rt2.control_log
    assert rt.recorder.all == rt2.recorder.all


def test_autoscaler_runs_closed_loop_on_vector():
    sc = tsc.get("flash-crowd-autoscale", seed=3)
    vec = _vector(sc)
    assert not vec.unsupported
    assert "set_scale" in {k for _, k, _ in vec.control_log}
    sim = run_scenario(sc, "sim")
    # fluid-limit equivalence: served mass within a few percent; both
    # loops react to the same burst within a couple of ticks
    assert vec.telemetry.overall().n == \
        pytest.approx(sim.telemetry.overall().n, rel=0.05)
    assert abs(vec.control_log[0][0] - sim.control_log[0][0]) <= 2.0
    assert vec.control_log[0][1:] == sim.control_log[0][1:]


def test_shedder_closed_loop_on_sim_and_vector():
    sc = tsc.get("flash-crowd-autoscale", seed=3, **SHEDDER)
    sim = run_scenario(sc, "sim")
    assert sim.shed > 0
    assert any(k == "set_admission" for _, k, _ in sim.control_log)
    vec = _vector(sc)
    assert not vec.unsupported
    assert vec.shed > 0
    assert vec.shed == pytest.approx(sim.shed, rel=0.35)


def test_fluid_shed_statistical_equivalence():
    sc = Scenario(
        name="thin", duration=20.0, seed=7, slo=0.1,
        servers=(ServerSpec(0, workers=2),),
        events=[ClientArrival(0.0, 300.0, count=2),
                SetAdmission(5.0, admit=0.6)])
    sim = run_scenario(sc, "sim")
    vec = _vector(sc)
    assert not vec.unsupported
    assert sim.shed > 100
    assert vec.shed == pytest.approx(sim.shed, rel=0.1)
    assert vec.telemetry.overall().n == \
        pytest.approx(sim.telemetry.overall().n, rel=0.05)


def test_fluid_scale_statistical_equivalence():
    servers = (ServerSpec(0), ServerSpec(1, standby=True),
               ServerSpec(2, standby=True))
    sc = Scenario(
        name="scale", duration=18.0, seed=7, policy="jsq",
        servers=servers,
        events=[ClientArrival(0.0, 500.0, count=2),
                SetScale(6.0, 3), SetScale(12.0, 1)])
    sim = run_scenario(sc, "sim")
    vec = _vector(sc)
    assert not vec.unsupported
    assert sim.telemetry.overall().n > 0
    assert vec.telemetry.overall().n == \
        pytest.approx(sim.telemetry.overall().n, rel=0.05)
    sim_util = [f.util for f in sim.telemetry.frames() if f.t == 9]
    assert sim_util and len(sim_util[0]) >= 3


def test_gray_failure_on_vector_without_breaker():
    sc = tsc.get("gray-failure", seed=3, duration=15.0)
    vec = _vector(sc)
    assert not vec.unsupported
    sim = run_scenario(sc, "sim")
    assert vec.telemetry.overall().n == \
        pytest.approx(sim.telemetry.overall().n, rel=0.05)


def test_retry_storm_naive_congests_backoff_recovers():
    naive = run_scenario(tsc.get("retry-storm", seed=3), "sim")
    backoff = run_scenario(tsc.get("retry-storm", seed=3, mode="backoff"),
                           "sim")
    assert naive.retries > 5 * backoff.retries
    assert naive.timeouts > backoff.timeouts > 0
    assert backoff.telemetry.overall().n > 1.5 * naive.telemetry.overall().n
    served_plus_lost = backoff.telemetry.overall().n + backoff.dropped
    assert backoff.retries < 0.2 * served_plus_lost


def test_gray_failure_breaker_routes_around_slow_server():
    plain = run_scenario(tsc.get("gray-failure", seed=3), "sim")
    guarded = run_scenario(tsc.get("gray-failure", seed=3, breaker=True),
                           "sim")
    assert plain.telemetry.overall().p99 > \
        5 * guarded.telemetry.overall().p99
    assert guarded.timeouts > 0
    assert guarded.telemetry.overall().n > \
        0.95 * plain.telemetry.overall().n
