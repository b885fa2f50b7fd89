"""The port's remaining benchmark and example twins against the
reference scripts, on the CPU.

* ``bench_control``: the smoke record (the frontier's four arms and
  their summary, the retry storm, the thresholds and the five gates)
  equal to the reference's, value for value; both run ``sim``.
* ``bench_sweep``: the smoke declaration and the serial frame equal to
  the reference's, and the process executor's frame equal to the serial
  one.
* ``bench_simulator``: the exact-mode equivalence check equal to the
  reference's, and ``--single`` rows at small sizes equal in
  ``completed``, ``events`` and ``p99_ms``.
* ``engine_serving`` and ``examples/torch_port/serve_e2e.py`` with
  ``--device cpu``: every request served; without a card and without
  ``--device cpu`` they refuse to run.
* the ``sim`` example twins (``quickstart``, ``elastic_scaleout``,
  ``scenario_flash_crowd``): stdout equal to the reference example's,
  line for line.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

pytest.importorskip("jax")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmarks import bench_control as ref_control  # noqa: E402
from benchmarks import bench_simulator as ref_simulator  # noqa: E402
from benchmarks import bench_sweep as ref_sweep  # noqa: E402
from benchmarks.torch_port import bench_control  # noqa: E402
from benchmarks.torch_port import bench_simulator  # noqa: E402
from benchmarks.torch_port import bench_sweep  # noqa: E402
from benchmarks.torch_port import engine_serving  # noqa: E402


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), REPO]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _captured(module, monkeypatch) -> dict:
    """The dict that ``module``'s record will land in: its
    ``write_record`` keeps the record in memory instead of writing it."""
    got = {}
    monkeypatch.setattr(module, "write_record",
                        lambda name, payload, smoke: got.update(payload))
    return got


def test_bench_control_twin_reproduces_the_reference(monkeypatch):
    mine = _captured(bench_control, monkeypatch)
    theirs = _captured(ref_control, monkeypatch)
    assert bench_control.main(["--smoke", "--check"]) == 0
    ref_control.main(["--smoke"])
    assert mine["scale"] == theirs["scale"] == "smoke"
    for key in ("frontier", "retry_storm", "thresholds", "gates"):
        assert mine[key] == theirs[key], key
    assert len(mine["frontier"]["arms"]) == 8
    assert all(mine["gates"].values())


def test_bench_sweep_twin_frames(monkeypatch):
    sweep, ref = bench_sweep.build_sweep(True), ref_sweep.build_sweep(True)
    assert sweep.describe() == ref.describe()
    frame, _ = bench_sweep.timed(sweep, "serial")
    want, _ = ref_sweep.timed(ref, "serial")
    assert bench_sweep.rows_dump(frame) == ref_sweep.rows_dump(want)
    par, _ = bench_sweep.timed(sweep, "process", 2)
    assert not par.errors
    assert bench_sweep.rows_dump(par) == bench_sweep.rows_dump(frame)


def test_bench_sweep_twin_record(monkeypatch):
    rec = _captured(bench_sweep, monkeypatch)
    assert bench_sweep.main(["--smoke", "--workers", "2"]) == 0
    assert rec["benchmark"] == "bench_sweep"
    assert rec["rows_bit_identical"] is True
    assert rec["serial"]["rows"] == rec["parallel"]["rows"] == 16
    assert rec["serial"]["errors"] == rec["parallel"]["errors"] == 0
    assert rec["grid"]["tasks"] == 16


def test_bench_simulator_equivalence_check_is_the_reference_one():
    got = bench_simulator.equivalence_check()
    assert got == ref_simulator.equivalence_check()
    assert got["identical"] is True


@pytest.mark.parametrize("engine,servers,mode", [
    ("calendar", 10, "exact"), ("seed", 10, "exact"),
    ("batched", 10, "exact"), ("calendar", 100, "streaming")])
def test_bench_simulator_single_rows_match(engine, servers, mode):
    rows = []
    for script in ("benchmarks/torch_port/bench_simulator.py",
                   "benchmarks/bench_simulator.py"):
        out = subprocess.run(
            [sys.executable, os.path.join(REPO, script), "--single", engine,
             str(servers), "20000", mode], cwd=REPO, env=_env(),
            capture_output=True, text=True, timeout=120, check=True)
        rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
    mine, theirs = rows
    for k in ("engine", "servers", "clients", "requests", "completed",
              "events", "p99_ms", "stats_mode"):
        assert mine[k] == theirs[k], k
    assert mine["completed"] == 20000


def test_engine_serving_twin_on_cpu(capsys):
    rows = engine_serving.run(device="cpu")
    assert [r["qps"] for r in rows] == [20, 60]
    for r in rows:
        assert r["n"] == r["submitted"] > 0
        assert 0 < r["p50_ms"] <= r["p95_ms"] <= r["p99_ms"]
    assert engine_serving.main(["--device", "cpu"]) == "ok"
    assert capsys.readouterr().out.startswith("engine_serving,")


def test_card_twins_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        engine_serving.run()
    spec = importlib.util.spec_from_file_location(
        "serve_e2e_twin", os.path.join(REPO, "examples", "torch_port",
                                       "serve_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main([])


def test_serve_e2e_twin_on_cpu():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch_port",
                                      "serve_e2e.py"), "--device", "cpu"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    served = next(ln for ln in lines if ln.startswith("served n="))
    assert int(served.split()[1].split("=")[1]) > 0
    assert sum(ln.startswith("replica ") for ln in lines) == 2


@pytest.mark.parametrize("name", ["quickstart", "elastic_scaleout",
                                  "scenario_flash_crowd"])
def test_sim_example_twin_prints_the_reference_output(name):
    outs = []
    for script in (os.path.join("examples", "torch_port", name + ".py"),
                   os.path.join("examples", name + ".py")):
        out = subprocess.run([sys.executable, os.path.join(REPO, script)],
                             cwd=REPO, env=_env(), capture_output=True,
                             text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        outs.append(out.stdout.splitlines())
    assert outs[0] == outs[1]
    assert len(outs[0]) > 3
