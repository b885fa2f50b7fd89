"""Control on the port's engine backend (CPU) against the JAX package's.

* Parity: stub engines on a ``VirtualClock`` are deterministic, so the
  same scenario, seed and rep run through ``repro``'s
  ``build_stub_engines`` + ``EngineRuntime`` and through the port's must
  give equal results, not close ones: the telemetry rows, ``overall()``
  (n, mean, p50, p95, p99), dropped / shed / timeouts / retries, the
  attempts handed to engines, ``control_log`` and the ``unsupported``
  kinds.  The cases: the retry storm in both modes, the correlated
  failure, the gray failure with and without its breaker, the flash
  crowd under both controllers (and with the streaming recorder), the
  same-timestamp admission order and the token-bucket shed.
* The reference's own engine checks, carried across as the port's:
  the autoscaler's closed loop and its determinism
  (``tests/test_control.py``), the retry storm's naive-against-backoff
  shape and the backend-parametrised determinism cases with ``engine``
  in them (``tests/test_chaos.py``).
* The control injections and specs ``EngineRuntime`` accepts, recorded
  as the reference records them.
"""
from __future__ import annotations

import math

import pytest

pytest.importorskip("jax")

from repro import scenarios as jsc  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro.core import scenario as jscn  # noqa: E402
from repro.core.harness import ServerSpec as JServerSpec  # noqa: E402
from repro.scenarios import backends as jbackends  # noqa: E402

from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.core import scenario as tscn  # noqa: E402
from repro_torch.core.harness import ServerSpec  # noqa: E402
from repro_torch.scenarios import backends as tbackends  # noqa: E402
from repro_torch.vector import VectorConfig  # noqa: E402

SHEDDER = dict(controller="admission_shedder", peak_qps=4000.0)
CHAOS_CASES = [
    ("retry-storm", dict(mode="naive", duration=15.0)),
    ("retry-storm", dict(mode="backoff", duration=15.0)),
    ("correlated-failure", dict(duration=15.0)),
    ("gray-failure", dict(duration=15.0)),
    ("gray-failure", dict(duration=15.0, breaker=True)),
    ("flash-crowd-autoscale", dict(duration=30.0)),
    ("flash-crowd-autoscale", dict(duration=30.0, **SHEDDER)),
    # the streaming recorder: the controller reads its reservoir windows
    ("flash-crowd-autoscale", dict(duration=30.0, stats_mode="streaming")),
]


def stub_run(mod_rt, backends, scenario, rep: int = 0):
    """One run of ``scenario`` on stub engines in virtual time, as the
    scenario CLI and the sweep run it."""
    exp = scenario.compile()
    clock = mod_rt.VirtualClock()
    engines, factory = backends.build_stub_engines(exp, clock, exp.seed)
    rt = mod_rt.EngineRuntime.from_experiment(
        exp, engines, engine_factory=factory, rep=rep, clock=clock,
        sleep=clock.sleep)
    rt.run()
    return rt


def _port(sc, rep: int = 0):
    return stub_run(trt, tbackends, sc, rep)


def _ref(sc, rep: int = 0):
    return stub_run(jrt, jbackends, sc, rep)


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def assert_engine_runs_equal(port, ref) -> None:
    """The contract: everything the two runs report is equal."""
    want, got = ref.telemetry.to_rows(), port.telemetry.to_rows()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        diff = {k: (g[k], w[k]) for k in g if not _same(g[k], w[k])}
        assert not diff, diff
    po, ro = port.telemetry.overall(), ref.telemetry.overall()
    assert (po.n, po.mean, po.p50, po.p95, po.p99) == \
        (ro.n, ro.mean, ro.p50, ro.p95, ro.p99)
    assert port.recorder.mode == ref.recorder.mode
    if ref.recorder.mode == "exact":
        assert port.recorder.all == ref.recorder.all
    assert port.recorder.failures == ref.recorder.failures
    assert (port.dropped, port.shed, port.timeouts, port.retries) == \
        (ref.dropped, ref.shed, ref.timeouts, ref.retries)
    # the reference counts attempts only by request id: its next id is
    # the number of attempts it handed to engines
    assert port.submitted == next(ref._rid)
    assert port.control_log == ref.control_log
    assert [(i.at, i.kind) for i in port.unsupported] == \
        [(i.at, i.kind) for i in ref.unsupported]


@pytest.mark.parametrize("name,kw", CHAOS_CASES)
def test_chaos_engine_run_equal_to_reference(name, kw):
    port = _port(tsc.get(name, seed=3, **kw))
    ref = _ref(jsc.get(name, seed=3, **kw))
    assert_engine_runs_equal(port, ref)
    # every attempt handed to an engine is served, retried, timed out or
    # lost with a failed server, and nothing is left in flight
    assert port.submitted == (port.telemetry.overall().n + port.retries
                              + port.timeouts
                              + port.recorder.failures["failed"])
    assert not port._meta and not port._retry_q and \
        not port._pending_actions


@pytest.mark.parametrize("name,kw,rep", [
    ("retry-storm", dict(mode="backoff", duration=12.0), 1),
    ("gray-failure", dict(duration=12.0, breaker=True), 2),
    ("flash-crowd-autoscale", dict(duration=30.0), 1)])
def test_engine_rep_streams_equal_to_reference(name, kw, rep):
    """Repetitions draw their own arrival and resilience streams (the
    ``(RESILIENCE_STREAM, seed, rep)`` jitter included)."""
    port = _port(tsc.get(name, seed=5, **kw), rep)
    ref = _ref(jsc.get(name, seed=5, **kw), rep)
    assert_engine_runs_equal(port, ref)
    rep0 = _port(tsc.get(name, seed=5, **kw))
    assert port.recorder.all != rep0.recorder.all


# ---------------------------------------------------------------------------
# Same-timestamp order and the token-bucket shed (tests/test_control.py)
# ---------------------------------------------------------------------------
def _same_t_scenario(scn, spec_cls, order: str, duration: float = 6.0):
    """Two admission settings at one instant: the declaration order
    decides which wins."""
    evs = [scn.SetAdmission(2.0, admit=0.0),
           scn.SetAdmission(2.0, admit=1.0)]
    a, b = evs if order == "open-last" else evs[::-1]
    return scn.Scenario(
        name="tie", duration=duration, seed=5, servers=(spec_cls(0),),
        events=[scn.ClientArrival(0.0, 300.0, count=1), a, b])


def _bucket_scenario(scn, spec_cls):
    return scn.Scenario(
        name="bucket", duration=6.0, seed=5, servers=(spec_cls(0),),
        events=[scn.ClientArrival(0.0, 50.0, count=1),
                scn.SetAdmission(1.0, rate=20.0, burst=5.0)])


@pytest.mark.parametrize("order", ["open-last", "shut-last"])
def test_same_timestamp_order_equal_to_reference(order):
    port = _port(_same_t_scenario(tscn, ServerSpec, order))
    ref = _ref(_same_t_scenario(jscn, JServerSpec, order))
    assert_engine_runs_equal(port, ref)
    sim = trt.run_scenario(_same_t_scenario(tscn, ServerSpec, order), "sim")
    assert (port.shed, port.telemetry.overall().n) == \
        (sim.shed, sim.telemetry.overall().n)
    # admit=1.0 declared last wins; admit=0.0 declared last sheds the rest
    assert (port.shed > 0) == (order == "shut-last")


def test_token_bucket_shed_equal_to_reference():
    port = _port(_bucket_scenario(tscn, ServerSpec))
    ref = _ref(_bucket_scenario(jscn, JServerSpec))
    assert_engine_runs_equal(port, ref)
    sim = trt.run_scenario(_bucket_scenario(tscn, ServerSpec), "sim")
    assert sim.shed > 0
    assert (port.shed, port.telemetry.overall().n) == \
        (sim.shed, sim.telemetry.overall().n)


# ---------------------------------------------------------------------------
# The reference's engine checks, as the port's own
# ---------------------------------------------------------------------------
def test_autoscaler_runs_closed_loop_on_engine():
    sc = tsc.get("flash-crowd-autoscale", seed=3, duration=30.0)
    rt = _port(sc)
    assert "set_scale" in {k for _, k, _ in rt.control_log}
    sim = trt.run_scenario(tsc.get("flash-crowd-autoscale", seed=3,
                                   duration=30.0), "sim")
    # closed loops amplify small telemetry differences, so the traces of
    # two backends may part; both react to the burst within a couple of
    # ticks and drain back toward the base fleet
    assert abs(rt.control_log[0][0] - sim.control_log[0][0]) <= 2.0
    assert rt.control_log[0][1:] == sim.control_log[0][1:]
    assert rt.control_log[-1][2]["n"] <= 3
    # determinism on the engine itself: same seed, same trace
    assert _port(sc).control_log == rt.control_log


def test_retry_storm_on_engine_matches_shape():
    """The storm reproduces on the wall-clock engine: the naive retries
    multiply, the budgeted backoff serves more."""
    naive = _port(tsc.get("retry-storm", seed=3, mode="naive",
                          duration=15.0))
    backoff = _port(tsc.get("retry-storm", seed=3, mode="backoff",
                            duration=15.0))
    assert naive.timeouts > 0
    assert naive.retries > 5 * backoff.retries
    assert backoff.telemetry.overall().n > naive.telemetry.overall().n


def _once(name, backend, rep=0, **kw):
    sc = tsc.get(name, **kw)
    if backend == "engine":
        return _port(sc, rep)
    if backend == "vector":
        return trt.run_scenario(sc, "vector", rep=rep,
                                vector_config=VectorConfig(device="cpu"))
    return trt.run_scenario(sc, backend, rep=rep)


@pytest.mark.parametrize("backend", ["sim", "engine", "vector"])
def test_correlated_failure_deterministic_on_every_backend(backend):
    kw = dict(seed=4, duration=15.0)
    a = _once("correlated-failure", backend, **kw)
    b = _once("correlated-failure", backend, **kw)
    sa, sb = a.telemetry.overall(), b.telemetry.overall()
    assert sa.n > 0
    assert (sa.n, sa.mean, sa.p99, a.dropped) == \
        (sb.n, sb.mean, sb.p99, b.dropped)
    if backend != "vector":
        assert a.recorder.all == b.recorder.all
        # reps are independent streams, not replays
        c = _once("correlated-failure", backend, rep=1, **kw)
        assert a.recorder.all != c.recorder.all


@pytest.mark.parametrize("backend", ["sim", "engine"])
def test_gray_failure_deterministic(backend):
    kw = dict(seed=7, duration=15.0, breaker=True)
    a = _once("gray-failure", backend, **kw)
    b = _once("gray-failure", backend, **kw)
    assert a.recorder.all == b.recorder.all
    assert (a.timeouts, a.retries) == (b.timeouts, b.retries)


# ---------------------------------------------------------------------------
# What EngineRuntime accepts
# ---------------------------------------------------------------------------
def test_control_injections_apply_as_reference():
    """Each control injection, on a fleet of one active and two standby
    stub replicas, changes what the reference's changes: the admission
    controller, the active set, the retry policy and budget, the
    breaker."""
    from repro.control import BreakerSpec as JBreaker
    from repro.control import RetryPolicy as JRetry

    from repro_torch.control import BreakerSpec, RetryPolicy
    servers = (0, 1, 2)
    steps = [("set_admission", {"admit": 0.5}, {"admit": 0.5}),
             ("set_admission", {"rate": 20.0, "burst": 5.0},
              {"rate": 20.0, "burst": 5.0}),
             ("set_scale", {"n": 3}, {"n": 3}),
             ("set_scale", {"n": 1}, {"n": 1}),
             ("set_retry", {"policy": RetryPolicy(timeout=0.5,
                                                  max_retries=2)},
              {"policy": JRetry(timeout=0.5, max_retries=2)}),
             ("set_breaker", {"spec": BreakerSpec(window=10)},
              {"spec": JBreaker(window=10)}),
             ("set_retry", {"policy": None}, {"policy": None}),
             ("set_breaker", {"spec": None}, {"spec": None}),
             ("set_admission", {"admit": 1.0}, {"admit": 1.0})]

    def fleet(mod_rt, backends, scn, spec_cls):
        sc = scn.Scenario(
            name="inject", duration=2.0, seed=1,
            servers=tuple(spec_cls(i, standby=i > 0) for i in servers),
            events=[scn.ClientArrival(0.0, 10.0, count=1)])
        exp = sc.compile()
        clock = mod_rt.VirtualClock()
        engines, _ = backends.build_stub_engines(exp, clock)
        return mod_rt.EngineRuntime.from_experiment(
            exp, engines, clock=clock, sleep=clock.sleep)

    port = fleet(trt, tbackends, tscn, ServerSpec)
    ref = fleet(jrt, jbackends, jscn, JServerSpec)
    for kind, p_params, r_params in steps:
        port._apply_injection(tscn.Injection(1.0, kind, p_params))
        ref._apply_injection(jscn.Injection(1.0, kind, r_params))
        for attr in ("_admission", "_breaker", "_retry_budget"):
            p, r = getattr(port, attr), getattr(ref, attr)
            assert (p is None) == (r is None), (kind, attr)
            if p is not None:
                assert vars(p).keys() == vars(r).keys()
        assert (port._retry is None) == (ref._retry is None)
        if port._admission is not None:
            assert port._admission.level == ref._admission.level
        assert [h.server_id for h in port._alive] == \
            [h.server_id for h in ref._alive], kind
        assert [(h.draining, h.accepting) for h in port.handles.values()] \
            == [(h.draining, h.accepting) for h in ref.handles.values()]


@pytest.mark.parametrize("name", ["retry-storm", "gray-failure",
                                  "flash-crowd-autoscale",
                                  "correlated-failure"])
def test_cli_engine_stub_report_equal_to_reference(name, capsys):
    """``python -m repro_torch.scenarios <chaos> --backend engine
    --stub`` prints the reference's report, its ``resilience:`` line
    included; the port's first line adds where it ran."""
    from repro.scenarios.__main__ import main as jax_main

    from repro_torch.scenarios.__main__ import main
    args = [name, "--backend", "engine", "--stub", "--duration", "8",
            "--seed", "3"]
    assert main(args) == 0
    port_out = capsys.readouterr().out.splitlines()
    assert jax_main(args) == 0
    ref_out = capsys.readouterr().out.splitlines()
    assert port_out[0] == ref_out[0] + " device=host"
    assert port_out[1:] == ref_out[1:]
    if name == "retry-storm":
        assert port_out[1].startswith("  resilience: shed=0 timeouts=")


def test_run_engine_experiment_shim_warns_and_returns_recorder():
    """The deprecated entry point, as the reference keeps it: a
    ``DeprecationWarning``, then ``EngineRuntime`` on the wall clock."""
    from repro_torch.core.client import ClientConfig, ConstantQPS
    from repro_torch.core.harness import run_engine_experiment
    from repro_torch.core.profiles import FixedProfile
    from repro_torch.core.stats import LatencyRecorder
    from repro_torch.serving.engine import StubEngine
    engines = [StubEngine(FixedProfile("fixed", 0.002), workers=2, seed=i)
               for i in range(2)]
    with pytest.warns(DeprecationWarning, match="EngineRuntime"):
        rec = run_engine_experiment(
            engines, [ClientConfig(0, ConstantQPS(200.0))],
            policy="jsq", duration=0.3, seed=4)
    assert isinstance(rec, LatencyRecorder)
    assert rec.overall().n > 0
    assert issubclass(trt.EngineRuntime, trt.Runtime)
    assert issubclass(trt.SimulatorRuntime, trt.Runtime)
