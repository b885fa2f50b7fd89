"""The port's vector runtime on the CPU against the JAX package's.

* Programs: every canonical scenario compiles, through the port's own
  scenario layer and compiler, to a ``VectorProgram`` whose arrays are
  equal to the reference's.
* Rows: the same programs and (seed, stream) pairs run through
  ``repro_torch.vector.run_cells(device="cpu")`` and
  ``repro.vector.run_cells(backend="jax", impl="ref")`` give the same
  rows.  The draws are the same NumPy draws, so any gap comes from the
  f32 scan: on x86-64 every scenario and the mixed grid below match bit
  for bit.  The tolerances (``dropped`` equal, ``n`` within 1, stats and
  interval series rtol 1e-6) leave room only for XLA's jitted
  FMA contraction in the reference scan; no scenario needs more.
* Carrying a program across: ``program_from_numpy`` rebuilds the port's
  program from the reference program's fields, ``control_actions`` and
  the retry, breaker and control specs of ``unsupported`` included.
* The package: imports neither JAX nor ``repro``, runs on the card by
  default and raises where there is none, and its CLI runs on the CPU
  (and ``--backend sim`` on the host).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro import scenarios as jsc  # noqa: E402
from repro.sweep.spec import spawn_seed  # noqa: E402
from repro.vector import VectorConfig as JaxConfig  # noqa: E402
from repro.vector import VectorTelemetry as JaxTelemetry  # noqa: E402
from repro.vector import compile_experiment as jax_compile  # noqa: E402
from repro.vector import run_cells as jax_run  # noqa: E402

from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.core.runtime import run_scenario  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.vector import (VectorCompileError, VectorConfig,  # noqa: E402
                                VectorTelemetry, compile_experiment,
                                program_from_numpy, run_cells)

CANONICAL = ["steady", "flash-crowd", "diurnal-fleet", "server-failure",
             "elastic-autoscale", "batched-serving", "churn-storm"]
CPU = VectorConfig(device="cpu")
JAX_REF = JaxConfig(backend="jax", impl="ref")
RTOL = 1e-6
SRC = os.path.join(os.path.dirname(__file__), os.pardir, "src")


def _programs(name: str, **kw):
    return (compile_experiment(tsc.get(name, **kw).compile()),
            jax_compile(jsc.get(name, **kw).compile()))


def _as_fields(value):
    """A reference program field as plain numbers, lists and arrays."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return dataclasses.asdict(value)
    if isinstance(value, list):
        return [_as_fields(v) for v in value]
    return value


def _reference_fields(prog) -> dict:
    return {f.name: _as_fields(getattr(prog, f.name))
            for f in dataclasses.fields(prog)}


def _assert_programs_equal(port, ref):
    want = _reference_fields(ref)
    got = _reference_fields(port)
    assert got.keys() == want.keys()
    for name, value in want.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[name], value, err_msg=name)
            assert got[name].dtype == value.dtype, name
        else:
            assert got[name] == value, name
    for obj in ("profile", "service", "lengths"):
        assert (type(getattr(port, obj)).__name__
                == type(getattr(ref, obj)).__name__), obj


def _assert_rows_close(got, want):
    for g, w in zip(got, want):
        assert g.dropped == w.dropped
        assert abs(g.n - w.n) <= 1
        for m in ("mean", "p50", "p95", "p99"):
            np.testing.assert_allclose(getattr(g, m), getattr(w, m),
                                       rtol=RTOL, err_msg=m)
        for m in ("n_ivl", "util_ivl", "occ_ivl", "qdepth_ivl"):
            np.testing.assert_allclose(getattr(g, m), getattr(w, m),
                                       rtol=RTOL, atol=1e-9, err_msg=m)
        assert (g.tokens_ivl is None) == (w.tokens_ivl is None)
        if w.tokens_ivl is not None:
            np.testing.assert_allclose(g.tokens_ivl, w.tokens_ivl,
                                       rtol=RTOL, atol=1e-9)


@pytest.mark.parametrize("name", CANONICAL)
def test_program_equal_to_reference(name):
    port, ref = _programs(name, duration=5.0, seed=3)
    _assert_programs_equal(port, ref)
    assert ([(i.at, i.kind, i.params) for i in port.unsupported]
            == [(i.at, i.kind, i.params) for i in ref.unsupported])


def test_unsupported_hedge_recorded():
    port, _ = _programs("churn-storm", duration=5.0)
    assert [i.kind for i in port.unsupported] == ["set_hedge"]


@pytest.mark.parametrize("name", CANONICAL)
def test_rows_match_reference(name):
    port, ref = _programs(name, duration=5.0, seed=3)
    got = run_cells([port], [(3, 1)], CPU)
    want = jax_run([ref], [(3, 1)], JAX_REF)
    _assert_rows_close(got, want)
    rows_got = VectorTelemetry(got[0]).to_rows()
    rows_want = JaxTelemetry(want[0]).to_rows()
    assert len(rows_got) == len(rows_want)
    for a, b in zip(rows_got, rows_want):
        assert a.keys() == b.keys()
        np.testing.assert_allclose([a[k] for k in a], [b[k] for k in b],
                                   rtol=RTOL, atol=1e-9)


def _mixed_grid():
    """Two scalar shape buckets (5 s and 3 s) and one batched bucket,
    every cell with its own sweep-derived seed."""
    cases = [("steady", dict(duration=5.0, qps=900.0)),
             ("server-failure", dict(duration=3.0)),
             ("batched-serving", dict(duration=5.0))]
    port, ref, seeds = [], [], []
    for i, (name, kw) in enumerate(cases):
        for rep in range(2):
            seed = spawn_seed(7, i, rep)
            p, r = _programs(name, seed=seed, **kw)
            port.append(p)
            ref.append(r)
            seeds.append((seed, rep))
    return port, ref, seeds


def test_mixed_grid_rows_match_reference():
    port, ref, seeds = _mixed_grid()
    got = run_cells(port, seeds, CPU)
    want = jax_run(ref, seeds, JAX_REF)
    _assert_rows_close(got, want)


def test_chunking_and_pipeline_never_change_rows():
    """One chunk per cell, launched double-buffered or strictly in turn,
    gives the rows of the whole grid in one chunk."""
    port, seeds = [], []
    for i, (name, duration) in enumerate((("steady", 1.5), ("steady", 1.0),
                                          ("batched-serving", 1.5))):
        port.append(compile_experiment(
            tsc.get(name, seed=i, duration=duration).compile()))
        seeds.append((i, 0))
    whole = run_cells(port, seeds, CPU)
    for pipeline in (True, False):
        cfg = VectorConfig(device="cpu", max_slot_elems=1,
                           pipeline=pipeline)
        for a, b in zip(run_cells(port, seeds, cfg), whole):
            assert (a.n, a.mean, a.p50, a.p95, a.p99, a.dropped) == \
                (b.n, b.mean, b.p50, b.p95, b.p99, b.dropped)
            np.testing.assert_array_equal(a.samples, b.samples)


@pytest.mark.parametrize("name", ["server-failure", "batched-serving",
                                  "churn-storm"])
def test_program_from_numpy_carries_reference_program(name):
    port, ref = _programs(name, duration=5.0, seed=5)
    carried = program_from_numpy(_reference_fields(ref))
    _assert_programs_equal(carried, ref)
    a = run_cells([carried], [(5, 0)], CPU)[0]
    b = run_cells([port], [(5, 0)], CPU)[0]
    assert (a.n, a.mean, a.p50, a.p95, a.p99, a.dropped) == \
        (b.n, b.mean, b.p50, b.p95, b.p99, b.dropped)


@pytest.mark.parametrize("name,kw", [
    ("flash-crowd-autoscale", {}),
    ("flash-crowd-autoscale", dict(controller="admission_shedder",
                                   peak_qps=4000.0)),
    ("retry-storm", {}),
    ("gray-failure", dict(breaker=True))])
def test_program_from_numpy_carries_control_actions(name, kw):
    """A reference program with ``control_actions`` and with retry and
    breaker specs in ``unsupported`` is carried across field for field,
    the specs rebuilt as the port's own dataclasses, and runs as the
    port's own program does."""
    from repro_torch.control import BreakerSpec, RetryPolicy
    port, ref = _programs(name, duration=9.0, seed=3, **kw)
    carried = program_from_numpy(_reference_fields(ref))
    _assert_programs_equal(carried, ref)
    assert carried.control_actions == ref.control_actions
    assert (len(carried.control_actions) > 0) == (name ==
                                                  "flash-crowd-autoscale")
    for inj in carried.unsupported:
        spec = next(iter(inj.params.values()))
        assert isinstance(spec, {"set_retry": RetryPolicy,
                                 "set_breaker": BreakerSpec}[inj.kind])
    assert [(i.at, i.kind, i.params, i.seq) for i in carried.unsupported] \
        == [(i.at, i.kind, i.params, i.seq) for i in port.unsupported]
    a = run_cells([carried], [(3, 0)], CPU)[0]
    b = run_cells([port], [(3, 0)], CPU)[0]
    assert (a.n, a.mean, a.p50, a.p95, a.p99, a.dropped) == \
        (b.n, b.mean, b.p50, b.p95, b.p99, b.dropped)


def test_program_from_numpy_refuses_control_actions():
    """``control_actions`` came across once the pre-pass was ported; what
    is still refused is a non-empty field the port's program lacks."""
    _, ref = _programs("steady", duration=2.0)
    fields = _reference_fields(ref)
    fields["control_actions"] = [(1.0, "set_scale", {"n": 2})]
    assert program_from_numpy(fields).control_actions == \
        [(1.0, "set_scale", {"n": 2})]
    fields["soft_band"] = [0.5]
    with pytest.raises(VectorCompileError, match="not ported"):
        program_from_numpy(fields)
    fields["soft_band"] = []
    assert program_from_numpy(fields).n_servers == ref.n_servers


def test_program_from_numpy_carries_control_spec():
    """A batched service under ``control`` records the spec as
    ``unsupported``; it comes across as the port's ``ControlSpec``."""
    from repro_torch.control import ControlSpec
    port, ref = _programs("batched-serving", duration=2.0, seed=1)
    spec = dict(name="admission_shedder", interval=1.0, lag=2.0,
                cooldown=4.0, params=(("target_qdepth", 8.0),))
    fields = _reference_fields(ref)
    fields["unsupported"] = fields["unsupported"] + [
        dict(at=0.0, kind="control", params={"spec": spec}, seq=0)]
    carried = program_from_numpy(fields)
    got = carried.unsupported[-1].params["spec"]
    assert got == ControlSpec.make("admission_shedder", interval=1.0,
                                   lag=2.0, cooldown=4.0,
                                   target_qdepth=8.0)
    assert hash(got) == hash(ControlSpec(**dict(
        spec, params=(("target_qdepth", 8.0),))))


def test_imports_neither_jax_nor_repro():
    code = (
        "import pkgutil, importlib, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    assert VectorConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    port, _ = _programs("steady", duration=1.0)
    with pytest.raises(RuntimeError, match="cuda"):
        run_cells([port], [(0, 0)])
    assert resolve_device("cpu").type == "cpu"


def test_entry_point_defaults_pinned(capsys):
    """``run_scenario`` and ``python -m repro_torch.scenarios`` default to
    the card's vector runtime where the reference's default to ``sim``;
    both docstrings and ``--help`` say so."""
    import inspect

    from repro.core.runtime import run_scenario as jax_run_scenario
    from repro.scenarios.__main__ import main as jax_main

    from repro_torch.scenarios.__main__ import main
    assert inspect.signature(run_scenario).parameters["backend"].default \
        == "vector"
    assert inspect.signature(jax_run_scenario).parameters["backend"] \
        .default == "sim"
    assert '``"sim"`` in ``repro.core.runtime.run_scenario``' in \
        " ".join(run_scenario.__doc__.split())
    with pytest.raises(SystemExit):
        main(["--help"])
    assert "reference's default is sim" in " ".join(
        capsys.readouterr().out.split())
    for run, args in ((main, ["--device", "cpu"]), (jax_main, [])):
        assert run(["steady", "--duration", "1"] + args) == 0
    port_line, ref_line = [ln for ln in capsys.readouterr().out.splitlines()
                           if ln.startswith("scenario=")]
    assert "backend=vector" in port_line and "backend=sim" in ref_line


def test_not_ported_surfaces_raise():
    """What once raised is ported: the result cache (a cell misses,
    then hits with the same arrays, through ``run_cells`` and the
    planner's ``run_plan(cache=)``).
    Soft mode, control on the engine runtime and ``batched-serving``
    with ``arch=`` are ported and build: soft consts run the plain step,
    the flash crowd's runtime carries its controller and a standby
    pool, the batched scenario its roofline service."""
    from repro_torch.plan import PlanSpec, run_plan
    from repro_torch.core.profiles import BatchedService
    from repro_torch.core.runtime import EngineRuntime
    from repro_torch.kernels import ops
    sc = tsc.get("flash-crowd-autoscale", duration=3.0)
    rt = EngineRuntime.from_experiment(sc.compile(), [object()] * 6)
    assert rt._control.spec == sc.compile().control
    assert [h.server_id for h in rt._alive] == [0, 1]
    batched = tsc.get("batched-serving", arch="phi3-mini-3.8b")
    assert batched.service_model == \
        BatchedService.from_arch("phi3-mini-3.8b")
    from repro_torch.cache import ResultCache
    cache = ResultCache(cache_dir=None)
    prog = compile_experiment(tsc.get("steady", duration=1.0).compile())
    (cold,) = run_cells([prog], [(1, 0)], CPU, cache=cache)
    (warm,) = run_cells([prog], [(1, 0)], CPU, cache=cache)
    assert (cache.stats.misses, cache.stats.hits) == (1, 1)
    assert warm is cold
    res = run_plan(PlanSpec(overrides={"duration": 2.0, "qps": 2000.0,
                                       "policy": "jsq"},
                            params={"capacity": (4.0, 1.0, 6.0)}, steps=2,
                            starts=1, samples=256, probe_reps=1, reps=1),
                   vector_config=CPU, cache=cache)
    assert res.n_star is not None and res.cell_evals >= 1
    U = torch.zeros((1, 1))
    t = torch.zeros(1, dtype=torch.int32)
    soft = {"c": torch.ones((1, 1)), "fail_slot": -torch.ones(
        (1, 1), dtype=torch.int32), "dt": 0.005, "tau": 0.1}
    ones = torch.ones((1, 1, 1))
    carry, ys = ops.scalar_scan(soft, (U, U, torch.zeros(1)),
                                (t, ones, ones, torch.zeros((1, 1)),
                                 torch.zeros((1, 1)), ones, ones, ones))
    assert torch.isfinite(ys[0]).all()
    # the simulator and the compiler's control pre-pass no longer raise
    assert run_scenario(tsc.get("steady", duration=1.0), "sim").recorder.all
    assert compile_experiment(sc.compile()).control_actions is not None


@pytest.mark.parametrize("args,head", [
    (["retry-storm", "--backend", "sim", "--duration", "6"],
     "scenario=retry-storm backend=sim n="),
    (["flash-crowd-autoscale", "--device", "cpu", "--duration", "9"],
     "scenario=flash-crowd-autoscale backend=vector n=")])
def test_cli_runs_sim_and_chaos_on_cpu(args, head):
    """``--backend sim`` runs on the host and says so; a chaos scenario
    with a controller runs on the CPU's vector runtime, nothing
    skipped."""
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-m", "repro_torch.scenarios",
                          *args], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(head)
    if "sim" in args:
        assert lines[0].endswith(" device=host")
        assert lines[1].startswith("  resilience: shed=0 timeouts=")
    else:
        assert lines[0].endswith(" device=cpu")
        assert not any("note: injection" in ln for ln in lines)


def test_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.scenarios", "steady",
         "--backend", "vector", "--device", "cpu", "--duration", "3"],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith("scenario=steady backend=vector n=")
    assert "p99=" in lines[0]
    assert len(lines) == 2 + 3          # header, column titles, 3 intervals
