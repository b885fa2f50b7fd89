"""The port's spec checks (``repro_torch.analysis.check``) against the JAX
package's (``repro.analysis.check``), and the capability matrix against
the port's own runtimes.

* every registered scenario x backend (None, sim, engine, vector): the
  port's findings equal the reference's, ``to_dict()`` for ``to_dict()``;
* the sweeps (the sweep CLI's smoke sweep and the reference's seeder
  cases) and the load model (``offered_rho``) equal the reference's;
* the contract that matters: what ``unsupported_on`` names is exactly
  what the port's vector compiler (``VectorProgram.unsupported``, which
  ``VectorRuntime.unsupported`` surfaces) and engine runtime
  (``EngineRuntime.unsupported``) skip, or, for ``legacy_mode`` on
  ``vector``, refuse — for every injection kind and flag, and for every
  registered scenario;
* the CLI, in process and once through ``python -m``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from repro import scenarios as ref_scenarios
from repro.analysis import check as ref_check
from repro.analysis.__main__ import main as ref_main
from repro.analysis.check.schedule import offered_rho as ref_offered_rho
from repro.sweep import __main__ as ref_sweep_cli
from repro.sweep.spec import Sweep as RefSweep
from repro.sweep.spec import scenario_factory as ref_factory
from repro.vector.compile import compile_experiment as ref_compile
from repro_torch import scenarios
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.check import (
    CAPABILITIES,
    INJECTION_KINDS,
    check_scenario,
    check_sweep,
    has_errors,
    skipped_kinds,
    unsupported_on,
)
from repro_torch.analysis.check.schedule import offered_rho
from repro_torch.analysis.check.seeds import check_sweep_seeds
from repro_torch.control import BreakerSpec, ControlSpec, RetryPolicy
from repro_torch.core.harness import ServerSpec
from repro_torch.core.runtime import (EngineRuntime, SimulatorRuntime,
                                      VirtualClock)
from repro_torch.core.scenario import (ClientArrival, Injection, Scenario,
                                       ServerFail, ServerSlowdown,
                                       SetAdmission, SetBreaker, SetHedge,
                                       SetPolicy, SetRetry, SetScale)
from repro_torch.scenarios.backends import build_stub_engines
from repro_torch.sweep import __main__ as sweep_cli
from repro_torch.sweep.spec import Sweep, scenario_factory
from repro_torch.vector import VectorConfig, VectorRuntime
from repro_torch.vector.compile import VectorCompileError, compile_experiment

ROOT = Path(__file__).resolve().parent.parent
NAMES = ref_scenarios.names()
BACKENDS = (None, "sim", "engine", "vector")


def _dicts(findings) -> list:
    return [f.to_dict() for f in findings]


def test_registered_scenarios_equal_reference():
    assert list(scenarios.names()) == list(NAMES)
    assert len(NAMES) == 11


@pytest.mark.parametrize("backend", BACKENDS, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_scenario_findings_equal_reference(name, backend):
    got = check_scenario(scenarios.get(name), backend=backend)
    want = ref_check.check_scenario(ref_scenarios.get(name),
                                    backend=backend)
    assert _dicts(got) == _dicts(want)
    rejected = {"engine": {"churn-storm", "gray-failure"},
                "vector": {"churn-storm", "retry-storm"}}.get(backend, ())
    assert has_errors(got) == (name in rejected)


# ---------------------------------------------------------------------------
# Sweeps and the load model
# ---------------------------------------------------------------------------
def _sweeps(seeder, points=3, reps=3):
    kw = dict(name="t", axes=[("qps", [100.0 * (i + 1)
                                       for i in range(points)])],
              fixed={"duration": 2.0}, reps=reps, seeder=seeder)
    return (Sweep(factory=scenario_factory("steady"), **kw),
            RefSweep(factory=ref_factory("steady"), **kw))


@pytest.mark.parametrize("seeder", ["spawn", "run-repeated", "fixed"])
def test_sweep_findings_equal_reference(seeder):
    port, ref = _sweeps(seeder)
    got = check_sweep(port)
    assert _dicts(got) == _dicts(ref_check.check_sweep(ref))
    assert _dicts(check_sweep_seeds(port)) == \
        _dicts(ref_check.check_sweep_seeds(ref))
    assert has_errors(got) == (seeder == "run-repeated")


def test_smoke_and_hedged_sweeps_equal_reference():
    port = sweep_cli._sweep_from_decl(dict(sweep_cli.SMOKE))
    ref = ref_sweep_cli._sweep_from_decl(dict(ref_sweep_cli.SMOKE))
    assert _dicts(check_sweep(port)) == _dicts(ref_check.check_sweep(ref))
    kw = dict(name="h", axes=[("client_qps", [50.0, 100.0])],
              fixed={"duration": 4.0}, reps=2, runtime="vector")
    got = check_sweep(Sweep(factory=scenario_factory("churn-storm"), **kw))
    want = ref_check.check_sweep(RefSweep(
        factory=ref_factory("churn-storm"), **kw))
    assert _dicts(got) == _dicts(want)
    assert [f.target for f in got if f.rule == "capability"] == \
        ["h[0]", "h[1]"]


@pytest.mark.parametrize("name,over", [(n, {}) for n in NAMES] + [
    ("steady", dict(qps=100000.0, n_servers=1, duration=5.0)),
    ("batched-serving", dict(qps=100000.0, duration=5.0))],
    ids=list(NAMES) + ["steady-overload", "batched-overload"])
def test_offered_rho_equals_reference(name, over):
    got = offered_rho(compile_experiment(
        scenarios.get(name, **over).compile(), dt=0.05))
    want = ref_offered_rho(ref_compile(
        ref_scenarios.get(name, **over).compile(), dt=0.05))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# The capability matrix against the port's runtimes
# ---------------------------------------------------------------------------
SERVERS = (ServerSpec(0), ServerSpec(1), ServerSpec(2, standby=True))
EVENTS = {
    "server_fail": ServerFail(1.0, 1),
    "server_speed": ServerSlowdown(1.0, 1, 4.0),
    "set_policy": SetPolicy(1.0, "jsq"),
    "set_hedge": SetHedge(1.0, 0.01),
    "set_admission": SetAdmission(1.0, admit=0.5),
    "set_scale": SetScale(1.0, 3),
    "set_retry": SetRetry(1.0, RetryPolicy(timeout=0.5, max_retries=1)),
    "set_breaker": SetBreaker(1.0, BreakerSpec()),
}
#: joins and drains declared as events lower onto the server specs; as
#: injections (a runtime's own scale actions) they are these
INJECTIONS = {
    "server_join": Injection(1.0, "server_join",
                             {"server_id": 3, "workers": 1, "speed": 1.0,
                              "service_noise": 0.0, "max_batch": None}),
    "server_drain": Injection(1.0, "server_drain", {"server_id": 1}),
}
FLAGS = {"hedge_delay": 0.01,
         "retry": RetryPolicy(timeout=0.5, max_retries=1),
         "breaker": BreakerSpec(),
         "control": ControlSpec.make("admission_shedder"),
         "legacy_mode": True}


def _base(events=()):
    return Scenario(name="caps", duration=3.0, seed=5, servers=SERVERS,
                    events=[ClientArrival(0.0, 40.0, count=2), *events])


def _minimal_experiments() -> dict:
    out = {}
    for kind in INJECTION_KINDS:
        if kind in EVENTS:
            exp = _base([EVENTS[kind]]).compile()
        else:
            exp = replace(_base().compile(), injections=[INJECTIONS[kind]])
        assert [i.kind for i in exp.injections] == [kind]
        out[f"injection:{kind}"] = exp
    for flag, value in FLAGS.items():
        out[flag] = replace(_base().compile(), **{flag: value})
    for name in NAMES:
        out[name] = scenarios.get(name).compile()
    return out


EXPERIMENTS = _minimal_experiments()


def _kinds(features) -> set:
    return skipped_kinds(f for f, _ in features)


@pytest.mark.parametrize("case", list(EXPERIMENTS))
def test_capability_matches_port_runtimes(case):
    exp = EXPERIMENTS[case]
    # vector: the compiler's skip list, as VectorRuntime surfaces it
    vec = unsupported_on(exp, "vector")
    if exp.legacy_mode:
        assert [f for f, _ in vec] == ["legacy_mode"]
        with pytest.raises(VectorCompileError):
            compile_experiment(exp)
    else:
        rt = VectorRuntime(exp, config=VectorConfig(device="cpu"))
        assert {i.kind for i in rt.unsupported} == _kinds(vec)
    # engine: the wall-clock runtime's skip list, hedging included
    clock = VirtualClock()
    engines, factory = build_stub_engines(exp, clock, exp.seed)
    rt = EngineRuntime.from_experiment(exp, engines, engine_factory=factory,
                                       clock=clock, sleep=clock.sleep)
    assert {i.kind for i in rt.unsupported} == \
        _kinds(unsupported_on(exp, "engine"))
    # sim: everything, and the simulator builds it
    assert unsupported_on(exp, "sim") == []
    SimulatorRuntime(exp)
    # and the reference's check names the same features on the reference
    # package's twin of each registered scenario
    if case in NAMES:
        twin = ref_scenarios.get(case).compile()
        for backend in CAPABILITIES:
            assert unsupported_on(exp, backend) == \
                ref_check.unsupported_on(twin, backend)


def test_batched_control_is_rejected_where_the_compiler_skips_it():
    """The one pairing where the port's check departs from the
    reference's: a controller on a batched service model, which both
    vector compilers skip, is a check-time error on ``vector`` here and
    passes the reference's check."""
    sc = scenarios.get("batched-serving")
    exp = replace(sc.compile(), control=FLAGS["control"])
    assert {i.kind for i in compile_experiment(exp).unsupported} == \
        {"control"}
    assert [f for f, _ in unsupported_on(exp, "vector")] == ["control"]
    twin = replace(ref_scenarios.get("batched-serving").compile(),
                   control=ControlSpec.make("admission_shedder"))
    assert {i.kind for i in ref_compile(twin).unsupported} == {"control"}
    assert ref_check.unsupported_on(twin, "vector") == []
    found = check_scenario(exp, backend="vector")
    assert has_errors(found)
    matrix = found[0].message.splitlines()[-1].split()
    assert matrix == ["control", "x", "x", "."]


def test_capability_matrix_gates_resilience_features():
    exp = Scenario(
        name="caps", duration=5.0, servers=(ServerSpec(0),),
        retry=RetryPolicy(timeout=0.5, max_retries=1),
        breaker=BreakerSpec(),
        events=[ClientArrival(0.0, 10.0, count=1),
                SetAdmission(1.0, admit=0.5)]).compile()
    assert unsupported_on(exp, "sim") == []
    assert unsupported_on(exp, "engine") == []
    vec_missing = {f for f, _ in unsupported_on(exp, "vector")}
    assert vec_missing == {"retry", "breaker"}
    ctrl = Scenario(
        name="caps2", duration=5.0, servers=(ServerSpec(0),),
        control=ControlSpec.make("admission_shedder"),
        events=[ClientArrival(0.0, 10.0, count=1)]).compile()
    for backend in ("sim", "engine", "vector"):
        assert unsupported_on(ctrl, backend) == []


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def _both(capsys, argv) -> tuple:
    rc = main(argv)
    out = capsys.readouterr().out
    ref_rc = ref_main(argv)
    return (rc, out), (ref_rc, capsys.readouterr().out)


def test_cli_check_default_equals_reference(capsys):
    got, want = _both(capsys, ["check"])
    assert got == want
    assert got == (0, "checked 12 declaration(s): 0 error(s), "
                      "0 warning(s)\n")


def test_cli_check_rejects_vector_hedge(capsys):
    got, want = _both(capsys, ["check", "--scenario", "churn-storm",
                               "--backend", "vector"])
    assert got == want and got[0] == 1
    assert "capability matrix" in got[1] and "set_hedge" in got[1]


def test_cli_check_json_equals_reference(capsys):
    got, want = _both(capsys, ["check", "--backend", "vector", "--json"])
    assert got[0] == want[0] == 1
    doc = json.loads(got[1])
    assert doc == json.loads(want[1])
    assert {f["target"] for f in doc["findings"]} == \
        {"churn-storm", "retry-storm"}


def test_cli_check_sweep_file_equals_reference(capsys, tmp_path):
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps({
        "name": "file", "scenario": "steady", "seeder": "run-repeated",
        "axes": {"qps": [200.0, 400.0]}, "fixed": {"duration": 2.0},
        "reps": 2}))
    got, want = _both(capsys, ["check", "--scenario", "steady",
                               "--sweep-file", str(path), "--json"])
    assert got[0] == want[0] == 1
    assert json.loads(got[1]) == json.loads(want[1])
    assert any(f["rule"] == "seed-collision"
               for f in json.loads(got[1])["findings"])


def test_cli_module_entry_point_imports_neither_jax_nor_repro(tmp_path):
    """``python -m repro_torch.analysis check`` (run as ``-m`` runs it)
    over every scenario, the smoke sweep and a sweep file, then lint: the
    lazy imports inside the CLI and the checks load none of ``repro``,
    ``jax`` or ``jaxlib``."""
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps({"scenario": "churn-storm",
                                "runtime": "vector", "reps": 1,
                                "fixed": {"duration": 4.0}}))
    code = (
        "import runpy, sys\n"
        "def run(*argv):\n"
        "    sys.argv = ['repro_torch.analysis', *argv]\n"
        "    try:\n"
        "        runpy.run_module('repro_torch.analysis', "
        "run_name='__main__', alter_sys=True)\n"
        "    except SystemExit as e:\n"
        "        return e.code\n"
        "rcs = [run('check', '--backend', 'engine'),\n"
        f"       run('check', '--scenario', 'steady', '--sweep-file', "
        f"{str(path)!r}),\n"
        "       run('--strict', 'src/repro_torch')]\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('rcs', rcs, 'bad', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "injection:server_speed not supported on 'engine'" in out.stdout
    assert "churn-storm[0]: error: capability" in out.stdout
    assert out.stdout.splitlines()[-1] == "rcs [1, 1, 0] bad []"
