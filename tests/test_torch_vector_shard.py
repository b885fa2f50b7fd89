"""Cell sharding of the port's vector runtime (``VectorConfig.devices``),
on the CPU, against its own unsharded rows and the JAX package's.

The shard layer splits each chunk's cell axis into one contiguous slice
per device of ``runtime._shard_devices``, launches each slice's scan on
its device and gathers the outputs in cell order.  Here the hook is
replaced by a list that repeats the CPU (``[cpu, cpu]``, ``[cpu, cpu,
cpu]``), the port's counterpart of XLA's
``--xla_force_host_platform_device_count``:

* the reference test's mixed grid (``steady`` at two loads, plus
  ``batched-serving``; ``tests/test_vector_kernels.py``) sharded two and
  three ways is the unsharded grid bit for bit, with one scan a shard
  and one quantile head a chunk;
* the unsharded rows are JAX ``impl="ref", devices=1`` rows within the
  parity contract (``dropped`` equal, ``n`` within 1, stats rtol 1e-6);
* ``resolve_devices``: 1 on the CPU, every card for 0, capped at the
  cards there, and a card pinned by index refuses more than one shard;
  the NumPy backend never reads ``devices``; soft grids skip the layer;
* the cache key holds the resolved count; ``--vector-devices`` reaches
  ``VectorConfig`` from both CLIs.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.scenarios import get as jax_get  # noqa: E402
from repro.sweep.spec import spawn_seed  # noqa: E402
from repro.vector import VectorConfig as JaxConfig  # noqa: E402
from repro.vector import compile_experiment as jax_compile  # noqa: E402
from repro.vector import run_cells as jax_run_cells  # noqa: E402

from repro_torch.cache import ResultCache, store  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.scenarios import get  # noqa: E402
from repro_torch.vector import (VectorConfig, compile_experiment,  # noqa: E402
                                run_cells)
from repro_torch.vector import runtime as vruntime  # noqa: E402

CPU_DEV = torch.device("cpu")
RTOL = 1e-6


def _mixed_grid(compile_fn=compile_experiment, get_fn=get):
    """The reference's ``_mixed_grid``: 4 scalar cells, 2 batched."""
    progs, seeds = [], []
    for pi, qps in enumerate((300.0, 900.0)):
        prog = compile_fn(get_fn("steady", seed=1, duration=6.0,
                                 qps=qps).compile())
        for rep in range(2):
            progs.append(prog)
            seeds.append((spawn_seed(1, pi, rep), rep))
    prog = compile_fn(get_fn("batched-serving", seed=2,
                             duration=8.0).compile())
    for rep in range(2):
        progs.append(prog)
        seeds.append((spawn_seed(2, 9, rep), rep))
    return progs, seeds


def _fingerprint(results):
    return [(r.n, r.mean, r.p50, r.p95, r.p99, r.dropped,
             r.samples.tobytes(), r.n_ivl.tobytes(), r.util_ivl.tobytes(),
             r.qdepth_ivl.tobytes()) for r in results]


@pytest.fixture(scope="module")
def unsharded():
    progs, seeds = _mixed_grid()
    return run_cells(progs, seeds, VectorConfig(device="cpu"))


def _count_launches(monkeypatch):
    """Record each scan's (family, cells, device) and each quantile
    head's cell count, passing through to the real ``ops``."""
    calls = []
    for name in ("scalar_scan", "batched_scan"):
        real = getattr(ops, name)

        def scan(consts, carry, xs, real=real, name=name):
            calls.append((name, carry[0].shape[0], carry[0].device.type))
            return real(consts, carry, xs)
        monkeypatch.setattr(ops, name, scan)
    real_q = ops.fused_quantiles

    def head(lat, counts):
        calls.append(("fused_quantiles", lat.shape[0], lat.device.type))
        return real_q(lat, counts)
    monkeypatch.setattr(ops, "fused_quantiles", head)
    return calls


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_rows_bit_equal_unsharded(monkeypatch, unsharded, n):
    progs, seeds = _mixed_grid()
    asked = []

    def shard_devices(cfg, count):
        asked.append(count)
        return [CPU_DEV] * n
    monkeypatch.setattr(vruntime, "_shard_devices", shard_devices)
    calls = _count_launches(monkeypatch)
    got = run_cells(progs, seeds, VectorConfig(device="cpu", devices=n))
    assert _fingerprint(got) == _fingerprint(unsharded)
    # the hook is asked once a grid, for the resolved count (1 on the CPU)
    assert asked == [1]
    # 4 scalar cells, then 2 batched: a scan a non-empty slice, one head
    # a chunk on the gathered cells (the batched chunk launches before
    # the scalar one finishes: double-buffering)
    sizes = {2: ([2, 2], [1, 1]), 3: ([2, 1, 1], [1, 1])}[n]
    assert calls == ([("scalar_scan", c, "cpu") for c in sizes[0]]
                     + [("batched_scan", c, "cpu") for c in sizes[1]]
                     + [("fused_quantiles", 4, "cpu"),
                        ("fused_quantiles", 2, "cpu")])


@pytest.mark.parametrize("pipeline", [True, False])
def test_sharded_chunks_pipeline(monkeypatch, unsharded, pipeline):
    """Chunked grids (a scalar chunk of one cell) sharded two ways, with
    and without double-buffering: the same bits."""
    progs, seeds = _mixed_grid()
    monkeypatch.setattr(vruntime, "_shard_devices",
                        lambda cfg, count: [CPU_DEV, CPU_DEV])
    calls = _count_launches(monkeypatch)
    T, S = vruntime._plan_groups(progs)[0][1]      # the scalar bucket
    per_cell = T * S
    got = run_cells(progs, seeds, VectorConfig(
        device="cpu", devices=2, pipeline=pipeline,
        max_slot_elems=3 * per_cell))
    assert _fingerprint(got) == _fingerprint(unsharded)
    # the scalar family in chunks of 3 and 1 cells: slices of 2, 1 and 1
    assert [c for c in calls if c[0] == "scalar_scan"] == \
        [("scalar_scan", c, "cpu") for c in (2, 1, 1)]


def test_unsharded_rows_match_jax_ref_devices_1(unsharded):
    progs, seeds = _mixed_grid(jax_compile, jax_get)
    want = jax_run_cells(progs, seeds,
                         JaxConfig(backend="jax", impl="ref", devices=1))
    for g, w in zip(unsharded, want):
        assert g.dropped == w.dropped and abs(g.n - w.n) <= 1
        for m in ("mean", "p50", "p95", "p99"):
            assert getattr(g, m) == pytest.approx(getattr(w, m), rel=RTOL)
        for m in ("n_ivl", "util_ivl", "qdepth_ivl"):
            np.testing.assert_allclose(getattr(g, m), getattr(w, m),
                                       rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("C,n,want", [
    (117, 3, [(0, 39), (39, 78), (78, 117)]),
    (5, 2, [(0, 3), (3, 5)]),
    (2, 3, [(0, 1), (1, 2)]),
    (4, 1, [(0, 4)]),
])
def test_cell_slices_are_contiguous(C, n, want):
    assert vruntime._cell_slices(C, n) == want


def test_shard_devices_names_the_cards():
    assert vruntime._shard_devices(VectorConfig(device="cpu"), 1) == \
        [CPU_DEV]
    assert vruntime._shard_devices(VectorConfig(device="cuda:1"), 1) == \
        [torch.device("cuda", 1)]
    assert vruntime._shard_devices(VectorConfig(), 3) == \
        [torch.device("cuda", k) for k in range(3)]


def test_resolve_devices(monkeypatch):
    for devices in (0, 1, 4):
        assert VectorConfig(device="cpu",
                            devices=devices).resolve_devices() == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert VectorConfig().resolve_devices() == 4
    assert VectorConfig(devices=2).resolve_devices() == 2
    assert VectorConfig(devices=9).resolve_devices() == 4
    assert VectorConfig(device="cuda:2").resolve_devices() == 1
    assert VectorConfig(device="cuda:2", devices=1).resolve_devices() == 1
    with pytest.raises(ValueError, match="pinned by index"):
        VectorConfig(device="cuda:0", devices=2).resolve_devices()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert VectorConfig(devices=2).resolve_devices() == 1


def test_numpy_backend_never_reads_devices(monkeypatch):
    progs, seeds = _mixed_grid()
    base = run_cells(progs, seeds, VectorConfig(backend="numpy"))

    def refuse(*a, **kw):
        raise AssertionError("the NumPy backend reached the shard layer")
    monkeypatch.setattr(vruntime, "_shard_devices", refuse)
    monkeypatch.setattr(VectorConfig, "resolve_devices", refuse)
    got = run_cells(progs, seeds, VectorConfig(backend="numpy", devices=3))
    assert _fingerprint(got) == _fingerprint(base)
    assert "devices" not in ResultCache(cache_dir=None).vector_sig(
        VectorConfig(backend="numpy", devices=3))


def test_soft_grids_skip_the_shard_layer(monkeypatch):
    prog = compile_experiment(get("steady", seed=3, duration=2.0).compile())
    seeds = [(spawn_seed(3, 0, rep), rep) for rep in range(3)]
    base = run_cells([prog] * 3, seeds, VectorConfig(device="cpu",
                                                     soft=True))

    def refuse(*a, **kw):
        raise AssertionError("a soft grid reached the shard layer")
    monkeypatch.setattr(vruntime, "_shard_devices", refuse)
    calls = _count_launches(monkeypatch)
    got = run_cells([prog] * 3, seeds,
                    VectorConfig(device="cpu", soft=True, devices=2))
    assert _fingerprint(got) == _fingerprint(base)
    assert calls == [("scalar_scan", 3, "cpu")]


def test_cache_key_holds_the_resolved_count(monkeypatch):
    cache = ResultCache(cache_dir=None)
    prog = compile_experiment(get("steady", seed=3, duration=2.0).compile())
    seed = (spawn_seed(3, 0, 0), 0)
    cpu = VectorConfig(device="cpu")
    assert cache.vector_sig(cpu)["devices"] == 1
    # on the CPU every request resolves to one shard: one key
    assert cache.cell_key(prog, seed, VectorConfig(device="cpu",
                                                   devices=3)) == \
        cache.cell_key(prog, seed, cpu)
    real = store.device_sig
    monkeypatch.setattr(store, "device_sig",
                        lambda d: real(d) if d == "cpu" else "card sm_90")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    keys = {}
    for devices in (0, 1, 2, 4, 8):
        cfg = VectorConfig(device="cuda", devices=devices)
        assert cache.vector_sig(cfg)["devices"] == cfg.resolve_devices()
        keys[devices] = cache.cell_key(prog, seed, cfg)
    assert keys[0] == keys[4] == keys[8]
    assert len({keys[1], keys[2], keys[4]}) == 3


def _record_devices(monkeypatch):
    seen = []

    def shard_devices(cfg, count):
        seen.append(cfg.devices)
        return [CPU_DEV, CPU_DEV]
    monkeypatch.setattr(vruntime, "_shard_devices", shard_devices)
    return seen


def test_scenarios_cli_passes_vector_devices(monkeypatch, capsys):
    from repro_torch.scenarios.__main__ import main
    seen = _record_devices(monkeypatch)
    assert main(["steady", "--device", "cpu", "--duration", "1",
                 "--vector-devices", "3"]) in (0, None)
    assert seen == [3]
    assert "device=cpu" in capsys.readouterr().out
    seen.clear()
    main(["steady", "--device", "cpu", "--duration", "1"])
    assert seen == [0]


def test_sweep_cli_passes_vector_devices(monkeypatch, tmp_path):
    from repro_torch.sweep.__main__ import main
    seen = _record_devices(monkeypatch)
    assert main(["steady", "--axis", "qps=300,600", "--reps", "2",
                 "--set", "duration=1.0", "--device", "cpu",
                 "--vector-devices", "2", "--out", str(tmp_path),
                 "--quiet"]) == 0
    assert seen == [2]
