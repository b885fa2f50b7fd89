"""The port's benchmark twins (``benchmarks/torch_port/``) against the
reference scripts (``benchmarks/``), on the CPU.

* Every figure twin declares the reference's ``SWEEP`` (``describe()``
  equal, the runtime included); the ``fig1_qps_latency`` and
  ``hedging`` twins give the reference's frames row for row (both run
  ``sim``).
* The ``bench_vector`` twin builds the reference's fig1 grid, with the
  same shape buckets (one scan launch of 117 cells at full size), and
  without a card and without ``--device cpu`` it exits non-zero rather
  than running on the host.
* The ``bench_plan`` twin poses the reference's FULL and SMOKE
  problems; its ``--smoke --device cpu --check`` run passes every gate
  and gives the reference twin's smoke answers (its dense grid and its
  planner, run in-process here because the reference script's own
  gradient check needs ``jax.experimental.enable_x64``): the grid's
  optimum and p99 means (rtol 1e-6), ``n_star``, the probe sequence
  and ``cell_evals``.  Without a card and without ``--device cpu`` it
  exits 2.
* The ``bench_cache`` twin poses the reference's thresholds and planner
  problems; its ``--smoke --device cpu --check`` run passes every gate
  (warm re-run all hits and bit-identical, planner cells within the
  budget, pipelined chunks bit-identical; the pipelining time gate is
  the card's, n/a on the CPU) and its planner
  reuse gives the reference twin's smoke answers (``n_star``, probes,
  cache hits, ``cell_evals``).  Without a card and without ``--device
  cpu`` it exits 2.
* The ``fig_batching`` twin declares the reference's grid (the
  ``runtime`` axis over ``sim`` and ``engine``), gives its ``--quick``
  frame row for row and passes its knee gate with the same knees.
* The twins, the example twins, the port and ``chip_smoke.py`` import
  neither ``jax``, ``repro`` nor ``ml_dtypes``.
"""
from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from repro.sweep import run_sweep as jax_run_sweep  # noqa: E402
from repro.vector import VectorConfig as JaxConfig  # noqa: E402

from repro_torch.sweep import run_sweep  # noqa: E402

FIGURES = ["fig1_qps_latency", "fig4_equivalence", "fig5_multiserver",
           "fig6_interleaved", "fig7_dynamic_qps", "fig8_balancing",
           "hedging"]


def _pair(name: str):
    return (importlib.import_module(f"benchmarks.torch_port.{name}"),
            importlib.import_module(f"benchmarks.{name}"))


@pytest.mark.parametrize("name", FIGURES)
def test_figure_twin_declares_the_reference_sweep(name):
    port, ref = _pair(name)
    assert port.SWEEP.describe() == ref.SWEEP.describe()
    assert port.SWEEP.tasks() == ref.SWEEP.tasks()
    assert [port.SWEEP.seed_for(i, rep) for i, _, rep in port.SWEEP.tasks()] \
        == [ref.SWEEP.seed_for(i, rep) for i, _, rep in ref.SWEEP.tasks()]


@pytest.mark.parametrize("name", ["fig1_qps_latency", "hedging"])
def test_figure_twin_frame_equals_reference(name):
    port, ref = _pair(name)
    got = run_sweep(port.SWEEP, progress=None).raise_errors()
    want = jax_run_sweep(ref.SWEEP, progress=None).raise_errors()
    assert got.spec == want.spec
    assert json.dumps([r.to_dict() for r in got.rows]) == \
        json.dumps([r.to_dict() for r in want.rows])


@pytest.mark.parametrize("smoke,hist", [
    (True, {"scalar:1280x1": 12}), (False, {"scalar:3072x1": 117})])
def test_bench_vector_twin_grid_and_buckets(smoke, hist):
    port, ref = _pair("bench_vector")
    for runtime in ("sim", "vector"):
        p, r = port.build_grid(smoke, runtime), ref.build_grid(smoke, runtime)
        assert p.describe() == r.describe()
        assert p.tasks() == r.tasks()
    sweep = port.build_grid(smoke, "vector")
    got = port.bucket_histogram(sweep)
    assert got == ref.bucket_histogram(ref.build_grid(smoke, "vector"),
                                       JaxConfig()) == hist


@pytest.mark.parametrize("quick", [True, False])
def test_fig_batching_twin_declares_the_reference_grid(quick):
    port, ref = _pair("fig_batching")
    p, r = port.build_sweep(quick), ref.build_sweep(quick)
    assert p.describe() == r.describe()
    assert p.tasks() == r.tasks()
    assert [port.point_qps(mb, f) for mb in port.MAX_BATCHES
            for f in (0.3, 1.0, 1.3)] == \
        [ref.point_qps(mb, f) for mb in ref.MAX_BATCHES
         for f in (0.3, 1.0, 1.3)]


def test_fig_batching_twin_quick_frame_and_gate_equal_reference(tmp_path):
    """``--quick``: the frame equals the reference's row for row, on
    ``sim`` and on the stub ``engine`` alike, and the knee gate passes
    with the reference's knees."""
    port, ref = _pair("fig_batching")
    got = run_sweep(port.build_sweep(True), progress=None).raise_errors()
    want = jax_run_sweep(ref.build_sweep(True), progress=None).raise_errors()
    assert {r.params["runtime"] for r in got.rows} == {"sim", "engine"}
    assert json.dumps([r.to_dict() for r in got.rows]) == \
        json.dumps([r.to_dict() for r in want.rows])
    outs = []
    for script in (os.path.join("benchmarks", "torch_port",
                                "fig_batching.py"),
                   os.path.join("benchmarks", "fig_batching.py")):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(REPO, "src"), REPO]))
        out = subprocess.run([sys.executable, os.path.join(REPO, script),
                              "--quick"], env=env, capture_output=True,
                             text=True, timeout=300, cwd=tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        line = out.stdout.strip().splitlines()[-1]
        name, _, derived = line.split(",", 2)
        assert name == "fig_batching"
        outs.append((derived, out.stderr.strip().splitlines()))
    assert outs[0] == outs[1]
    assert "within_15pct=True" in outs[0][0]


def _no_card_env() -> dict:
    """The environment of a run without a card: CUDA hidden."""
    return dict(os.environ, CUDA_VISIBLE_DEVICES="",
                PYTHONPATH=os.path.join(REPO, "src"))


def test_bench_vector_twin_needs_a_card_or_device_cpu(tmp_path):
    """Without a card the default run exits non-zero before it runs any
    grid."""
    script = os.path.join(REPO, "benchmarks", "torch_port", "bench_vector.py")
    out = subprocess.run([sys.executable, script, "--smoke"],
                         env=_no_card_env(), capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "serial event engine" not in out.stderr


def test_bench_plan_twin_poses_the_reference_problems():
    port, ref = _pair("bench_plan")
    assert port.FULL == ref.FULL and port.SMOKE == ref.SMOKE
    assert (port.SEED, port.ANALYTIC_TOL, port.ANALYTIC_REL,
            port.MIN_CELL_SPEEDUP) == (ref.SEED, ref.ANALYTIC_TOL,
                                       ref.ANALYTIC_REL, ref.MIN_CELL_SPEEDUP)


def test_bench_plan_twin_smoke_gates_and_answers_equal_reference():
    port, ref = _pair("bench_plan")
    script = os.path.join(REPO, "benchmarks", "torch_port", "bench_plan.py")
    out = subprocess.run([sys.executable, script, "--smoke", "--device",
                          "cpu", "--check"],
                         env=dict(os.environ, PYTHONPATH=os.path.join(
                             REPO, "src")),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    from benchmarks.torch_port._record import record_paths
    with open(record_paths("plan")[1]) as f:
        rec = json.load(f)
    assert rec["scale"] == "smoke" and rec["device"] == {"platform": "cpu"}
    assert all(v is not False for v in rec["gates"].values()), rec["gates"]
    grid = ref.dense_grid(ref.SMOKE)
    assert rec["grid"]["cells"] == grid["cells"]
    assert rec["grid"]["n_opt"] == grid["n_opt"]
    for g, w in zip(rec["grid"]["rows"], grid["rows"]):
        assert g["n"] == w["n"] and g["meets"] == w["meets"]
        assert g["p99_mean"] == pytest.approx(w["p99_mean"], rel=1e-6)
    res, _ = ref.run_planner(ref.SMOKE)
    got = rec["planner"]
    assert got["n_star"] == res.n_star
    assert got["cell_evals"] == res.cell_evals
    assert [(p["n"], p["meets"]) for p in got["probes"]] == \
        [(p["n"], p["meets"]) for p in res.probes]
    np.testing.assert_allclose(got["verified"]["values"],
                               res.verified["values"], rtol=1e-6)
    assert abs(got["continuous_capacity"] - res.params["capacity"]) <= 1e-2


def test_bench_plan_twin_needs_a_card_or_device_cpu(tmp_path):
    script = os.path.join(REPO, "benchmarks", "torch_port", "bench_plan.py")
    out = subprocess.run([sys.executable, script, "--smoke"],
                         env=_no_card_env(), capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 2
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "dense grid" not in out.stdout


def test_bench_cache_twin_poses_the_reference_thresholds():
    port, ref = _pair("bench_cache")
    assert port.PLAN_FULL == ref.PLAN_FULL
    assert port.PLAN_SMOKE == ref.PLAN_SMOKE
    assert (port.MIN_WARM_SPEEDUP, port.MIN_HIT_FRAC, port.MAX_PLANNER_CELLS,
            port.MAX_PIPELINE_RATIO, port.SEED) == \
        (ref.MIN_WARM_SPEEDUP, ref.MIN_HIT_FRAC, ref.MAX_PLANNER_CELLS,
         ref.MAX_PIPELINE_RATIO, ref.SEED)


def test_bench_cache_twin_smoke_gates_and_answers_equal_reference(tmp_path):
    port, ref = _pair("bench_cache")
    script = os.path.join(REPO, "benchmarks", "torch_port", "bench_cache.py")
    out = subprocess.run([sys.executable, script, "--smoke", "--device",
                          "cpu", "--check"],
                         env=dict(os.environ, PYTHONPATH=os.path.join(
                             REPO, "src")),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    from benchmarks.torch_port._record import record_paths
    with open(record_paths("cache")[1]) as f:
        rec = json.load(f)
    assert rec["scale"] == "smoke" and rec["device"] == {"platform": "cpu"}
    gates = dict(rec["gates"])
    # the pipelining gate times an overlap with the card: n/a on the CPU
    assert gates.pop("pipeline_not_slower") is None
    assert rec["pipeline"]["sync_wall_s"] > 0
    assert gates and all(gates.values()), gates
    sweep = rec["sweep"]
    assert sweep["tasks"] == 12 and sweep["warm_hits"] == 12
    assert sweep["warm_misses"] == 0 and sweep["stored_cells"] == 12
    assert rec["pipeline"]["chunks"] == port.PIPELINE_CHUNKS
    want = ref.planner_section(True, str(tmp_path))
    got = rec["planner"]
    for k in ("grid_cells", "n_star", "feasible", "cell_evals_with_cache",
              "cache_hits", "cache_misses"):
        assert got[k] == want[k], k


def test_bench_cache_twin_needs_a_card_or_device_cpu(tmp_path):
    script = os.path.join(REPO, "benchmarks", "torch_port", "bench_cache.py")
    out = subprocess.run([sys.executable, script, "--smoke"],
                         env=_no_card_env(), capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 2
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "fig1 grid" not in out.stderr


#: what the port, its twins and chip_smoke must never import
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: str) -> set:
    import ast
    tree = ast.parse(open(path).read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_twins_and_chip_smoke_import_neither_jax_nor_repro():
    """Imported, the twins, the training modules, the launch and
    distribution tooling, the NumPy vector backend's modules, the
    analysis layer and ``chip_smoke.py`` load none of ``FORBIDDEN``; and no import
    statement anywhere in the
    port, the twins, the example twins (scripts: read, not run) or
    ``chip_smoke.py`` names one."""
    twins = FIGURES + ["fig_batching", "bench_vector", "bench_plan",
                       "bench_cache", "bench_control", "bench_sweep",
                       "bench_simulator", "_seed_sim", "engine_serving",
                       "roofline_table", "run", "common", "_record"]
    modules = ["repro_torch.training.data", "repro_torch.training.optimizer",
               "repro_torch.training.train_step",
               "repro_torch.checkpoint.store", "repro_torch.launch.train",
               "repro_torch.launch.mesh", "repro_torch.launch.specs",
               "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
               "repro_torch.launch.perf", "repro_torch.launch.render",
               "repro_torch.distributed.sharding",
               "repro_torch.core.profiles", "repro_torch.vector.runtime",
               "repro_torch.analysis.__main__", "repro_torch.analysis.check",
               "repro_torch.analysis.lint", "repro_torch.configs.all"]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for n in {twins!r}:\n"
        "    importlib.import_module('benchmarks.torch_port.' + n)\n"
        f"for n in {modules!r}:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], env=_no_card_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    files = [os.path.join(REPO, "chip_smoke.py")]
    for top in ("src/repro_torch", "benchmarks/torch_port",
                "examples/torch_port"):
        for d, _, names in os.walk(os.path.join(REPO, top)):
            files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert any("examples/torch_port/train_lm.py" in f for f in files)
    for f in files:
        bad = _imported_roots(f) & set(FORBIDDEN)
        assert not bad, (f, bad)
