"""The port's sweep layer (``repro_torch.sweep``) and ``run_repeated``,
on the CPU, against the JAX package's.

* The reference's own sweep tests (``tests/test_sweep.py``), ported:
  spec expansion, seed derivation, executor determinism, failure
  capture, artifact round-trip, the runtime axis, ``run_repeated`` and
  the CLI.
* Cross-package parity, from the same declarations through both
  ``run_sweep``s: ``sim`` and ``engine`` rows bit-identical to the
  reference's (``SweepRow.to_dict``); ``vector`` rows on
  ``device="cpu"`` within rtol 1e-6 of JAX ``impl="ref"`` (``n`` within
  1, ``dropped`` equal; observed bit-identical); ``run_repeated``
  bit-identical, failures included.
* ``cache=`` (``repro_torch.cache``, once the surface here that raised)
  serves rows: a cold run misses and stores, a warm one hits with the
  same frame, and a ``mode="optimize"`` sweep hands the cache to the
  planner (``tests/test_torch_cache.py`` holds the rest);
  a ``batched-serving`` point on the engine runtime is an ordinary row,
  equal to the reference's.
* The CLI in a subprocess: ``--smoke`` and a positional vector sweep on
  ``--device cpu``, neither importing ``jax`` nor ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from dataclasses import replace

import pytest

pytest.importorskip("jax")

from repro.core import harness as jharness  # noqa: E402
from repro.core.client import ClientConfig as JClientConfig  # noqa: E402
from repro.core.client import ConstantQPS as JConstantQPS  # noqa: E402
from repro.sweep import run_sweep as jax_run_sweep  # noqa: E402
from repro.sweep.__main__ import SMOKE as JAX_SMOKE  # noqa: E402
from repro.sweep.__main__ import \
    _sweep_from_decl as jax_sweep_from_decl  # noqa: E402
from repro.vector import VectorConfig as JaxConfig  # noqa: E402

from repro_torch.core.client import ClientConfig, ConstantQPS  # noqa: E402
from repro_torch.core.harness import (Experiment, ServerSpec,  # noqa: E402
                                      run, run_repeated)
from repro_torch.sweep import (SEEDERS, Axis, ResultFrame,  # noqa: E402
                               Sweep, experiment_factory, run_sweep,
                               scenario_factory, spawn_seed)
from repro_torch.sweep.__main__ import SMOKE, _sweep_from_decl  # noqa: E402
from repro_torch.vector import VectorConfig  # noqa: E402

CPU = VectorConfig(device="cpu")
JAX_REF = JaxConfig(backend="jax", impl="ref")
RTOL = 1e-6
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")

BASE = Experiment(clients=(ClientConfig(0, ConstantQPS(150), seed=2),
                           ClientConfig(1, ConstantQPS(150), seed=7)),
                  servers=(ServerSpec(0), ServerSpec(1)),
                  app="masstree", duration=2.0, seed=2)


def _grid_sweep(**kw) -> Sweep:
    opts = dict(name="grid", factory=experiment_factory(BASE),
                axes=(Axis("policy", ("round_robin", "jsq")),
                      Axis("duration", (1.0, 2.0))),
                reps=2, base_seed=5,
                metrics=("n", "mean", "p50", "p95", "p99", "dropped"))
    opts.update(kw)
    return Sweep(**opts)


def _rows(frame) -> list:
    return [r.to_dict() for r in frame.rows]


# ---------------------------------------------------------------------------
# Spec expansion
# ---------------------------------------------------------------------------
def test_grid_points_order():
    sw = _grid_sweep()
    pts = sw.point_dicts()
    assert pts == [{"policy": "round_robin", "duration": 1.0},
                   {"policy": "round_robin", "duration": 2.0},
                   {"policy": "jsq", "duration": 1.0},
                   {"policy": "jsq", "duration": 2.0}]
    assert len(sw.tasks()) == 8          # 4 points x 2 reps


def test_zip_and_points_modes():
    sw = _grid_sweep(mode="zip")
    assert sw.point_dicts() == [{"policy": "round_robin", "duration": 1.0},
                                {"policy": "jsq", "duration": 2.0}]
    with pytest.raises(ValueError):
        _grid_sweep(mode="zip",
                    axes=(Axis("a", (1, 2)), Axis("b", (1, 2, 3))))
    sw = Sweep(name="p", factory=experiment_factory(BASE), mode="points",
               points=({"policy": "jsq"},), reps=1)
    assert sw.point_dicts() == [{"policy": "jsq"}]
    # no axes / no points: a legal 1-point (reps-only) sweep
    sw = Sweep(name="r", factory=experiment_factory(BASE), reps=3)
    assert sw.point_dicts() == [{}]
    # points under a non-points mode would be silently dropped: reject
    with pytest.raises(ValueError, match="points"):
        Sweep(name="bad", factory=experiment_factory(BASE),
              points=({"policy": "jsq"},), reps=1)


def test_fixed_params_merge():
    sw = _grid_sweep(fixed={"app": "xapian"})
    assert all(p["app"] == "xapian" for p in sw.point_dicts())


# ---------------------------------------------------------------------------
# Seed derivation
# ---------------------------------------------------------------------------
def test_spawn_seeder_never_collides():
    """The failure mode of seed + 1000*(rep+1): point 0/rep 1 replays
    point 1000/rep 0.  The SeedSequence spawn never collides."""
    seen = {spawn_seed(base, point, rep)
            for base in (0, 1000, 2000) for point in range(20)
            for rep in range(10)}
    assert len(seen) == 3 * 20 * 10
    legacy = [base + 1000 * (r + 1)
              for base in (0, 1000, 2000) for r in range(10)]
    assert len(set(legacy)) < len(legacy)


def test_named_seeders():
    from repro.sweep import SEEDERS as JAX_SEEDERS
    from repro.sweep import spawn_seed as jax_spawn_seed
    assert SEEDERS["run-repeated"](7, 3, 2) == (7 + 3000, 2)
    assert SEEDERS["fixed"](7, 3, 2) == (7, 0)
    assert SEEDERS["rep"](7, 3, 2) == (9, 0)
    seed, stream = SEEDERS["spawn"](7, 3, 2)
    assert stream == 2 and seed == spawn_seed(7, 3, 2)
    with pytest.raises(ValueError):
        _grid_sweep(seeder="nope")
    # the reference derives the same seeds and streams
    assert sorted(SEEDERS) == sorted(JAX_SEEDERS)
    for name in SEEDERS:
        for args in ((0, 0, 0), (1, 8, 12), (0x6A7E, 3, 5)):
            assert SEEDERS[name](*args) == JAX_SEEDERS[name](*args)
    assert spawn_seed(1, 4, 7) == jax_spawn_seed(1, 4, 7)


# ---------------------------------------------------------------------------
# Executor determinism (the core contract)
# ---------------------------------------------------------------------------
def test_serial_and_process_executors_identical():
    """Same Sweep on serial, 2-worker, and 8-worker executors ->
    identical ResultFrame rows (bit-for-bit, any scheduling order)."""
    sw = _grid_sweep()
    frames = [run_sweep(sw, executor="serial", progress=None),
              run_sweep(sw, executor="process", workers=2, progress=None),
              run_sweep(sw, executor="process", workers=8, progress=None)]
    dumps = [json.dumps(_rows(f)) for f in frames]
    assert dumps[0] == dumps[1] == dumps[2]
    assert all(r.ok for r in frames[0].rows)
    # and the sweep rows replay the exact runs the harness would produce
    row = frames[0].rows[0]
    sim = run(replace(BASE, seed=row.seed, **row.params), rep=row.stream)
    assert sim.recorder.overall().p99 == row.metrics["p99"]


def test_poisoned_point_records_error_row():
    """A raising point must not kill the sweep: it records an error row
    while every other (point, rep) completes."""
    sw = _grid_sweep(axes=(Axis("policy", ("round_robin",
                                           "does-not-exist")),))
    for executor in ("serial", "process"):
        frame = run_sweep(sw, executor=executor, progress=None)
        assert len(frame.rows) == 4
        bad = [r for r in frame.rows
               if r.params["policy"] == "does-not-exist"]
        good = [r for r in frame.rows if r.params["policy"] == "round_robin"]
        assert len(bad) == 2 and all(not r.ok and "KeyError" in r.error
                                     for r in bad)
        assert len(good) == 2 and all(r.ok and r.metrics["n"] > 0
                                      for r in good)
    agg = {a["params"]["policy"]: a for a in frame.aggregate("p99")}
    assert agg["does-not-exist"]["n_failed"] == 2
    assert agg["does-not-exist"]["mean"] != agg["does-not-exist"]["mean"]
    assert agg["round_robin"]["n_reps"] == 2
    with pytest.raises(RuntimeError, match="2 failed rows"):
        frame.raise_errors()


def test_result_frame_json_roundtrip_exact(tmp_path):
    sw = _grid_sweep(telemetry=True, per_client=True, reps=1)
    frame = run_sweep(sw, progress=None)
    rt = ResultFrame.from_json(frame.to_json())
    assert json.dumps(rt.to_dict()) == json.dumps(frame.to_dict())
    assert rt.rows[0].metrics["p99"] == frame.rows[0].metrics["p99"]
    assert rt.rows[0].series == frame.rows[0].series
    assert rt.rows[0].clients == frame.rows[0].clients
    # the streamed file form: byte-identical text, rows read one by one
    path = frame.to_json(str(tmp_path / "f.json"))
    with open(path) as f:
        assert f.read() == json.dumps(frame.to_dict(), indent=1)
    assert [r.to_dict() for r in ResultFrame.iter_json_rows(path)] == \
        _rows(frame)
    assert ResultFrame.from_json(path).to_dict() == frame.to_dict()


def test_csv_emission(tmp_path):
    sw = _grid_sweep(reps=2)
    frame = run_sweep(sw, progress=None)
    flat = tmp_path / "flat.csv"
    agg = tmp_path / "agg.csv"
    frame.to_csv(str(flat))
    frame.to_csv(str(agg), aggregated="p99")
    lines = flat.read_text().strip().splitlines()
    assert len(lines) == 1 + len(frame.rows)
    assert lines[0].startswith("policy,duration,rep,seed,n,")
    alines = agg.read_text().strip().splitlines()
    assert len(alines) == 1 + len(frame.points())
    assert "ci95" in alines[0]


def test_compare_welch():
    """Per-point Welch compare: a sweep against itself retains H0."""
    sw = _grid_sweep(reps=4, axes=(Axis("policy", ("jsq",)),))
    a = run_sweep(sw, progress=None)
    b = run_sweep(sw, progress=None)
    w = a.compare(b, "p99", policy="jsq")
    assert w.retained and w.n_a == w.n_b == 4 and abs(w.t_stat) < 1e-12


# ---------------------------------------------------------------------------
# Runtime-backend axis + scenario factories
# ---------------------------------------------------------------------------
def test_runtime_axis_runs_both_backends():
    sw = Sweep(name="backends", factory=scenario_factory("steady"),
               axes=(Axis("runtime", ("sim", "engine")),),
               fixed={"duration": 2.0, "qps": 150.0, "n_servers": 1,
                      "n_clients": 2},
               reps=1, metrics=("n", "p99"))
    frame = run_sweep(sw, progress=None)
    by_rt = {r.params["runtime"]: r for r in frame.rows}
    assert by_rt["sim"].ok and by_rt["engine"].ok
    assert by_rt["sim"].metrics["n"] > 0
    assert by_rt["engine"].metrics["n"] >= by_rt["sim"].metrics["n"]


def test_runtime_axis_with_experiment_factory():
    """The 'runtime' axis is executor-owned: an Experiment-based factory
    must not choke on it (it is not an Experiment field)."""
    sw = Sweep(name="exp-backends", factory=experiment_factory(BASE),
               axes=(Axis("runtime", ("sim", "engine", "vector")),),
               reps=1, metrics=("n", "p99"))
    frame = run_sweep(sw, progress=None, vector_config=CPU)
    assert all(r.ok for r in frame.rows), [r.error for r in frame.rows]
    assert {r.params["runtime"] for r in frame.rows} == {"sim", "engine",
                                                        "vector"}


def test_error_text_csv_quoting(tmp_path):
    """Free-form exception text (commas and all) survives the CSV."""
    import csv as _csv
    sw = _grid_sweep(axes=(Axis("policy", ("round_robin",)),), reps=1,
                     mode="zip")
    frame = run_sweep(sw, progress=None)
    frame.rows[0].error = 'Boom: a, b, and "c"'
    path = tmp_path / "err.csv"
    frame.to_csv(str(path))
    with open(path, newline="") as f:
        recs = list(_csv.DictReader(f))
    assert recs[0]["error"] == 'Boom: a, b, and "c"'


# ---------------------------------------------------------------------------
# run_repeated: a 1-point sweep, bit-compatible with the reference
# ---------------------------------------------------------------------------
def _jax_base(**kw):
    """``BASE`` built from the reference's classes."""
    return replace(jharness.Experiment(
        clients=(JClientConfig(0, JConstantQPS(150), seed=2),
                 JClientConfig(1, JConstantQPS(150), seed=7)),
        servers=(jharness.ServerSpec(0), jharness.ServerSpec(1)),
        app="masstree", duration=2.0, seed=2), **kw)


def test_run_repeated_shim_bit_compatible():
    exp = replace(BASE, duration=3.0)
    (mean, ci), vals = run_repeated(exp, reps=4)
    expected = []
    for rep in range(4):
        sim = run(replace(exp, seed=exp.seed + 1000 * (rep + 1)), rep=rep)
        expected.append(sim.recorder.overall().p99)
    assert vals == expected
    assert ci > 0.0


@pytest.mark.parametrize("metric", [None, "mean"])
def test_run_repeated_equals_reference(metric):
    kw = {} if metric is None else {
        "metric": lambda r: getattr(r.overall(), metric)}
    got = run_repeated(replace(BASE, duration=3.0, policy="jsq"), reps=3,
                       **kw)
    want = jharness.run_repeated(_jax_base(duration=3.0, policy="jsq"),
                                 reps=3, **kw)
    assert got == want


def test_run_repeated_propagates_failures():
    """fail_fast: the first failing repetition raises its ORIGINAL
    exception, as the reference's does."""
    with pytest.raises(KeyError, match="does-not-exist") as got:
        run_repeated(replace(BASE, policy="does-not-exist"), reps=2)
    with pytest.raises(KeyError, match="does-not-exist") as want:
        jharness.run_repeated(_jax_base(policy="does-not-exist"), reps=2)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Cross-package parity: the same declarations through both run_sweeps
# ---------------------------------------------------------------------------
SIM_DECLS = {
    "smoke": SMOKE,
    "runtime-axis": {"name": "backends", "scenario": "steady", "reps": 2,
                     "axes": {"runtime": ["sim", "engine"],
                              "qps": [150.0, 300.0]},
                     "fixed": {"duration": 2.0, "n_servers": 1,
                               "n_clients": 2},
                     "metrics": ["n", "mean", "p50", "p95", "p99",
                                 "dropped"]},
    "telemetry": {"name": "tele", "scenario": "server-failure", "reps": 2,
                  "axes": {"policy": ["round_robin", "jsq"]},
                  "fixed": {"duration": 4.0, "slo": 0.02},
                  "metrics": ["n", "p99", "dropped", "slo_frac", "shed",
                              "timeouts", "retries"],
                  "telemetry": True, "per_client": True},
    "chaos": {"name": "chaos", "scenario": "retry-storm", "reps": 2,
              "fixed": {"duration": 4.0},
              "metrics": ["n", "p99", "dropped", "timeouts", "retries"]},
}


@pytest.mark.parametrize("decl", sorted(SIM_DECLS))
def test_sim_frame_equals_reference(decl):
    """A declaration without a runtime means ``sim`` in both packages,
    and the frames are equal row for row, bit for bit."""
    d = SIM_DECLS[decl]
    if decl == "smoke":
        assert d == JAX_SMOKE
    port = _sweep_from_decl(dict(d))
    ref = jax_sweep_from_decl(dict(d))
    assert port.runtime == ref.runtime == "sim"
    assert port.describe() == ref.describe()
    got = run_sweep(port, progress=None)
    want = jax_run_sweep(ref, progress=None)
    assert not got.errors and not want.errors
    assert got.spec == want.spec
    assert json.dumps(_rows(got)) == json.dumps(_rows(want))


def _assert_vector_rows_close(got, want):
    assert len(got.rows) == len(want.rows)
    for g, w in zip(got.rows, want.rows):
        assert (g.index, g.params, g.rep, g.seed, g.stream) == \
            (w.index, w.params, w.rep, w.seed, w.stream)
        assert g.ok and w.ok, (g.error, w.error)
        assert g.metrics.keys() == w.metrics.keys()
        for m, v in w.metrics.items():
            if m == "n":
                assert abs(g.metrics[m] - v) <= 1
            elif m == "dropped":
                assert g.metrics[m] == v
            elif isinstance(v, float) and math.isnan(v):
                assert math.isnan(g.metrics[m]), m
            else:
                assert math.isclose(g.metrics[m], v, rel_tol=RTOL), m
        assert (g.series is None) == (w.series is None)
        for gs, ws in zip(g.series or (), w.series or ()):
            assert gs.keys() == ws.keys()
            for k, v in ws.items():
                assert gs[k] == v or math.isclose(gs[k], v, rel_tol=RTOL) \
                    or (math.isnan(v) and math.isnan(gs[k])), k
        assert g.clients == w.clients


VECTOR_DECLS = {
    "steady-grid": {"name": "vsteady", "scenario": "steady", "reps": 3,
                    "runtime": "vector",
                    "axes": {"qps": [400.0, 1200.0], "n_servers": [1, 3]},
                    "fixed": {"duration": 3.0, "policy": "jsq",
                              "slo": 0.01},
                    "metrics": ["n", "mean", "p50", "p95", "p99",
                                "dropped", "slo_frac", "shed"],
                    "telemetry": True, "per_client": True},
    "failure-points": {"name": "vfail", "runtime": "vector",
                       "scenario": "server-failure", "reps": 2,
                       "mode": "points",
                       "points": [{"duration": 6.0},
                                  {"duration": 4.0, "qps": 600.0}],
                       "metrics": ["n", "p99", "dropped", "shed"]},
    "batched": {"name": "vbatched", "runtime": "vector",
                "scenario": "batched-serving", "reps": 2,
                "axes": {"qps": [100.0, 200.0]},
                "fixed": {"duration": 4.0},
                "metrics": ["n", "mean", "p99", "dropped"]},
    "chaos-autoscale": {"name": "vchaos", "runtime": "vector",
                        "scenario": "flash-crowd-autoscale", "reps": 2,
                        "fixed": {"duration": 12.0},
                        "seed": 1,
                        "metrics": ["n", "mean", "p99", "dropped", "shed"]},
}


@pytest.mark.parametrize("decl", sorted(VECTOR_DECLS))
def test_vector_frame_matches_reference(decl):
    """``runtime="vector"`` on ``device="cpu"`` against the reference's
    grid path on JAX ``impl="ref"``: one grid each, rows within rtol
    1e-6 (``n`` within 1, ``dropped`` equal)."""
    d = VECTOR_DECLS[decl]
    port = _sweep_from_decl(dict(d))
    ref = jax_sweep_from_decl(dict(d))
    assert port.describe() == ref.describe()
    got = run_sweep(port, progress=None, vector_config=CPU)
    want = jax_run_sweep(ref, progress=None, vector_config=JAX_REF)
    _assert_vector_rows_close(got, want)
    # rows leave as plain Python numbers: the frame round-trips exactly
    assert ResultFrame.from_json(got.to_json()).to_dict() == got.to_dict()
    for r in got.rows:
        assert all(type(v) in (int, float) for v in r.metrics.values())


def test_batched_serving_engine_point_is_error_row():
    """A ``batched-serving`` point on the engine runtime runs on
    ``BatchedStubEngine`` replicas: an ordinary row, equal bit for bit to
    the reference's, beside the vector point of the same sweep."""
    from repro.sweep import Axis as JAxis
    from repro.sweep import Sweep as JSweep
    from repro.sweep import scenario_factory as jax_scenario_factory
    decl = dict(name="batched", axes=(("runtime", ("engine", "vector")),),
                fixed={"duration": 3.0, "n_servers": 1}, reps=1,
                metrics=("n", "p99"))
    sw = Sweep(factory=scenario_factory("batched-serving"),
               **{**decl, "axes": tuple(Axis(*a) for a in decl["axes"])})
    ref = JSweep(factory=jax_scenario_factory("batched-serving"),
                 **{**decl, "axes": tuple(JAxis(*a) for a in decl["axes"])})
    frame = run_sweep(sw, progress=None, vector_config=CPU)
    want = jax_run_sweep(ref, progress=None, vector_config=JAX_REF)
    eng, vec = frame.rows
    assert eng.ok and eng.error is None
    assert eng.metrics["n"] > 0
    assert json.dumps(eng.to_dict()) == json.dumps(want.rows[0].to_dict())
    assert vec.ok and vec.metrics["n"] > 0


def test_not_ported_surfaces_raise(tmp_path):
    """``cache=`` once raised here; it now serves rows.  A cold run
    misses and stores every row, a warm one (a new cache on the same
    directory) hits every row, and both frames are the uncached one.  An
    optimize sweep hands the cache to the planner: its second run spends
    no exact cell."""
    from repro_torch.cache import ResultCache
    sw = _grid_sweep()
    plain = run_sweep(sw, progress=None)
    cold = ResultCache(cache_dir=str(tmp_path))
    first = run_sweep(sw, progress=None, cache=cold)
    assert (cold.stats.hits, cold.stats.misses, cold.stats.stores) == \
        (0, 8, 8)
    warm = ResultCache(cache_dir=str(tmp_path))
    second = run_sweep(sw, progress=None, cache=warm)
    assert (warm.stats.hits, warm.stats.misses, warm.stats.stores) == \
        (8, 0, 0)
    assert _rows(first) == _rows(second) == _rows(plain)
    opt = Sweep(name="opt", factory=None, mode="optimize",
                optimize={"scenario": "steady", "slo": 0.02, "steps": 4,
                          "starts": 1, "samples": 256, "probe_reps": 1,
                          "params": {"capacity": [4.0, 1.0, 6.0]}},
                fixed={"duration": 2.0, "qps": 2000.0, "policy": "jsq"},
                reps=2)
    cache = ResultCache(cache_dir=None)
    evals = []
    for _ in range(2):
        frame = run_sweep(opt, progress=None, vector_config=CPU,
                          cache=cache)
        final = [r for r in frame.rows if r.params["phase"] == "final"]
        evals.append(final[0].metrics["cell_evals"])
    assert evals[0] > 0 and evals[1] == 0.0
    # the optimize spec validates as the reference's does
    with pytest.raises(ValueError, match="optimize block"):
        Sweep(name="opt", factory=None, mode="optimize")
    with pytest.raises(ValueError, match="use mode='optimize'"):
        _grid_sweep(optimize={"slo": 0.01})


def test_mixed_frame_process_equals_serial():
    """A ``runtime`` axis over ``sim|vector``: the vector tasks run as
    one grid in-process, the ``sim`` tasks on the pool; the frame is
    the serial one."""
    sw = Sweep(name="mixed", factory=scenario_factory("steady"),
               axes=(Axis("runtime", ("sim", "vector")),
                     Axis("qps", (300.0, 900.0))),
               fixed={"duration": 3.0}, reps=2, runtime="vector",
               metrics=("n", "mean", "p99", "dropped", "shed"))
    serial = run_sweep(sw, progress=None, vector_config=CPU)
    proc = run_sweep(sw, executor="process", workers=2,
                     progress=None, vector_config=CPU)
    assert not serial.errors
    assert json.dumps(_rows(proc)) == json.dumps(_rows(serial))
    assert proc.spec == {**serial.spec, "executor": "process"}


def test_cuda_is_the_default_and_a_missing_card_is_error_rows(monkeypatch):
    """Without ``vector_config`` the grid goes to the card; without a
    card that is an error row per vector task (the reference's
    failing-grid contract), and ``fail_fast`` raises instead."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sw = Sweep(name="nocard", factory=scenario_factory("steady"),
               axes=(Axis("runtime", ("sim", "vector")),),
               fixed={"duration": 1.0}, reps=1, metrics=("n",))
    frame = run_sweep(sw, progress=None)
    sim, vec = frame.rows
    assert sim.ok
    assert vec.error.startswith("vector grid: RuntimeError") and \
        "cuda" in vec.error
    with pytest.raises(RuntimeError, match="cuda"):
        run_sweep(sw, progress=None, fail_fast=True)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def test_cli_named_sweep(tmp_path, capsys):
    from repro_torch.sweep.__main__ import main
    rc = main(["steady", "--axis", "qps=100,200", "--reps", "1",
               "--set", "duration=1.5", "--quiet", "--device", "cpu",
               "--out", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "sweep=steady" in out and "errors=0" in out
    frame = ResultFrame.from_json(str(tmp_path / "steady.json"))
    assert len(frame.rows) == 2 and all(r.ok for r in frame.rows)
    assert frame.spec["runtime"] == "vector"
    assert (tmp_path / "steady.csv").exists()


def test_cli_file_declaration(tmp_path):
    from repro_torch.sweep.__main__ import main
    decl = {"name": "filedecl", "scenario": "steady", "reps": 1,
            "axes": {"qps": [120.0]}, "fixed": {"duration": 1.5},
            "metrics": ["n", "p99"]}
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(decl))
    rc = main(["--file", str(path), "--quiet", "--out", str(tmp_path)])
    assert rc == 0
    frame = ResultFrame.from_json(str(tmp_path / "filedecl.json"))
    assert frame.spec["axes"] == {"qps": [120.0]}
    assert frame.spec["runtime"] == "sim"
    assert frame.rows[0].metrics["n"] > 0


#: ``python -m repro_torch.sweep <args>`` in a fresh interpreter, then the
#: modules it loaded: neither JAX nor the reference package
_CLI = (
    "import runpy, sys\n"
    "sys.argv = ['repro_torch.sweep'] + sys.argv[1:]\n"
    "try:\n"
    "    runpy.run_module('repro_torch.sweep', run_name='__main__',\n"
    "                     alter_sys=True)\n"
    "    rc = 0\n"
    "except SystemExit as e:\n"
    "    rc = e.code\n"
    "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
    "('jax', 'jaxlib', 'repro'))\n"
    "print('LOADED', bad)\n"
    "sys.exit(rc)\n")


@pytest.mark.parametrize("args,name,runtime", [
    (["--smoke"], "smoke", "sim"),
    (["steady", "--axis", "qps=300,900", "--reps", "2",
      "--set", "duration=2.0"], "steady", "vector"),
])
def test_cli_subprocess_on_cpu(tmp_path, args, name, runtime):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _CLI, *args,
                          "--device", "cpu", "--quiet",
                          "--out", str(tmp_path)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    assert f"sweep={name}" in out.stdout and "errors=0" in out.stdout
    frame = ResultFrame.from_json(str(tmp_path / f"{name}.json"))
    assert frame.spec["runtime"] == runtime      # the CLI's defaults
    assert frame.rows and all(r.ok for r in frame.rows)


def test_workers_never_fork(monkeypatch):
    """Workers start from ``spawn``, or from a forkserver once CUDA is
    initialised: a process with a CUDA context (or PyTorch's threads)
    never forks."""
    import torch

    from repro_torch.sweep.executor import mp_context
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert mp_context().get_start_method() == "spawn"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert mp_context().get_start_method() == "forkserver"
