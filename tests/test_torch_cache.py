"""The port's result cache (``repro_torch.cache``), on the CPU, against the
JAX package's (``repro.cache``).

* A twin of each test of ``tests/test_cache.py``, on the port at
  ``device="cpu"``: fingerprints and keys, the silent-miss contract under
  on-disk damage and stale salts, cached == recomputed bit for bit on
  every executor, declaration order under partial hits, telemetry rows,
  planner reuse, the compiler's rate memo, streaming JSON, pipelined
  chunks, and the maintenance CLI.
* What the port adds: the tensor branch of the fingerprint (two distinct
  tensors never share a key, bf16 included), a salt that moves when a
  CUDA source changes, the port's own override variable
  (``REPRO_TORCH_CACHE_SALT``), the device in the cell key (a CPU entry
  never answers a card run), a warm ``run_cells`` that never reaches the
  launch, ``run_scenario(cache=)``, the CLIs' cache flags in
  subprocesses, and a ``gc`` that leaves the reference's cache alone.
* Parity with the JAX package: a cached frame, cold and warm, equals
  ``repro.sweep.run_sweep``'s (``sim`` and ``engine`` bit for bit,
  ``vector`` within rtol 1e-6 of JAX ``impl="ref"``, ``n`` within 1,
  ``dropped`` equal); the cached planner makes the reference's decisions
  with ``cell_evals == 0`` warm; the memoized compiled rates equal the
  reference's bit for bit.

The invariant everywhere: the cache may only ever change how fast an
answer arrives, never which answer arrives.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from repro.cache import ResultCache as JaxResultCache  # noqa: E402
from repro.plan import PlanSpec as JPlanSpec  # noqa: E402
from repro.plan import run_plan as jax_run_plan  # noqa: E402
from repro.scenarios import get as jax_get  # noqa: E402
from repro.sweep import Axis as JAxis  # noqa: E402
from repro.sweep import Sweep as JSweep  # noqa: E402
from repro.sweep import run_sweep as jax_run_sweep  # noqa: E402
from repro.sweep import scenario_factory as jax_scenario_factory  # noqa: E402
from repro.vector import VectorConfig as JaxConfig  # noqa: E402
from repro.vector import compile_experiment as jax_compile  # noqa: E402

from repro_torch.cache import (DEFAULT_CACHE_DIR, ResultCache,  # noqa: E402
                               Unfingerprintable, add_cache_args,
                               cache_from_args, code_salt, fingerprint)
from repro_torch.cache import gc as cache_gc  # noqa: E402
from repro_torch.cache import scan, store, verify  # noqa: E402
from repro_torch.cache.fingerprint import (PACKAGE_ROOT,  # noqa: E402
                                           tree_digest)
from repro_torch.core.client import (ClientConfig, ConstantQPS,  # noqa: E402
                                     DiurnalQPS, QPSSchedule)
from repro_torch.core.harness import Experiment, ServerSpec  # noqa: E402
from repro_torch.core.runtime import run_scenario  # noqa: E402
from repro_torch.plan import PlanSpec, run_plan  # noqa: E402
from repro_torch.scenarios import get  # noqa: E402
from repro_torch.sweep import (Axis, ResultFrame, Sweep,  # noqa: E402
                               run_sweep, scenario_factory)
from repro_torch.sweep.spec import spawn_seed  # noqa: E402
from repro_torch.vector import (VectorConfig, VectorRuntime,  # noqa: E402
                                compile_experiment, run_cells)
from repro_torch.vector import runtime as vruntime  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SRC = os.path.join(REPO, "src")
CPU = VectorConfig(device="cpu")
JAX_REF = JaxConfig(backend="jax", impl="ref")
RTOL = 1e-6
#: what ``device_sig`` reports for the card in the tests that pretend one
CARD = "NVIDIA H100 80GB HBM3 sm_90"


def _fingerprint_results(results):
    return [(r.n, repr(r.mean), repr(r.p50), repr(r.p95), repr(r.p99),
             r.dropped, r.samples.tobytes(), r.sample_ivl.tobytes(),
             r.util_ivl.tobytes(), r.qdepth_ivl.tobytes())
            for r in results]


def _grid(n_points=2, reps=2, duration=4.0):
    progs, seeds = [], []
    for pi, qps in enumerate(np.linspace(300.0, 900.0, n_points)):
        exp = get("steady", seed=1, duration=duration,
                  qps=float(qps)).compile()
        prog = compile_experiment(exp)
        for rep in range(reps):
            progs.append(prog)
            seeds.append((spawn_seed(1, pi, rep), rep))
    return progs, seeds


def _rows(frame) -> list:
    return [r.to_dict() for r in frame.rows]


def _pretend_card(monkeypatch):
    """Report a card for ``device="cuda"`` keys (the runtime itself still
    finds none)."""
    real = store.device_sig
    monkeypatch.setattr(store, "device_sig",
                        lambda d: real(d) if d == "cpu" else CARD)


# ---------------------------------------------------------------------------
# Fingerprints and keys
# ---------------------------------------------------------------------------
def test_fingerprint_canonical_and_sensitive():
    exp = get("steady", seed=3, duration=2.0).compile()
    assert fingerprint(exp) == fingerprint(exp)
    assert fingerprint(exp) == fingerprint(
        get("steady", seed=3, duration=2.0).compile())
    assert fingerprint(exp) != fingerprint(
        get("steady", seed=4, duration=2.0).compile())
    # dict key order is canonicalized away; values are not
    assert fingerprint({"a": 1, "b": 2}) == fingerprint({"b": 2, "a": 1})
    assert fingerprint({"a": 1}) != fingerprint({"a": 2})
    # float identity is by repr: -0.0 and 0.0 key distinctly
    assert fingerprint(0.0) != fingerprint(-0.0)
    assert fingerprint(np.arange(4.0)) != fingerprint(np.arange(4))
    # the port's classes key apart from the reference's twins
    assert fingerprint(exp) != fingerprint(
        jax_get("steady", seed=3, duration=2.0).compile())


def test_fingerprint_rejects_unstable_callables():
    with pytest.raises(Unfingerprintable):
        fingerprint(lambda x: x)

    def local():
        pass
    with pytest.raises(Unfingerprintable):
        fingerprint(local)
    # named module-level callables are fine (schedules hold them)
    assert fingerprint(ConstantQPS) == fingerprint(ConstantQPS)
    cache = ResultCache(cache_dir=None)
    assert cache.key("row", lambda x: x) is None
    assert cache.stats.uncacheable == 1


def test_tensor_fingerprints_do_not_collide():
    """A tensor's ``__dict__`` is empty: without its own branch every
    tensor would key alike.  Content, dtype and shape all split keys;
    bf16 hashes its bit pattern; the device is not hashed."""
    assert vars(torch.zeros(3)) == {}
    a = torch.tensor([1.0, 2.0, 3.0])
    keys = {fingerprint(a)}
    for other in (torch.tensor([1.0, 2.0, 4.0]), torch.zeros(3),
                  a.double(), a.reshape(3, 1), a[:2],
                  torch.tensor([1, 2, 3])):
        k = fingerprint(other)
        assert k not in keys, other
        keys.add(k)
    assert fingerprint(a) == fingerprint(torch.tensor([1.0, 2.0, 3.0]))
    assert fingerprint(a) == fingerprint(a.clone().requires_grad_(True))
    # a non-contiguous view keys as its contents
    m = torch.arange(6.0).reshape(2, 3)
    assert fingerprint(m.t()) == fingerprint(m.t().contiguous())
    b = a.to(torch.bfloat16)
    assert fingerprint(b) == fingerprint(torch.tensor([1.0, 2.0, 3.0],
                                                      dtype=torch.bfloat16))
    assert fingerprint(b) != fingerprint(b + 1)
    assert fingerprint(b) != fingerprint(b.view(torch.int16))
    assert fingerprint(b) != fingerprint(a.half())
    # a tensor inside a structure splits the structure's key
    assert fingerprint({"w": a}) != fingerprint({"w": torch.zeros(3)})
    assert fingerprint(torch.float32) != fingerprint(torch.bfloat16)
    assert fingerprint(torch.device("cpu")) != \
        fingerprint(torch.device("cuda"))
    with pytest.raises(Unfingerprintable):
        fingerprint(torch.Generator())
    assert ResultCache(cache_dir=None).key("row", torch.Generator()) is None


def test_cell_keys_distinguish_bit_affecting_config(tmp_path, monkeypatch):
    cache = ResultCache(cache_dir=str(tmp_path))
    prog = compile_experiment(get("steady", seed=0, duration=2.0).compile())
    seed = (spawn_seed(0, 0, 0), 0)
    base = cache.cell_key(prog, seed, CPU)
    assert base == cache.cell_key(prog, seed, VectorConfig(device="cpu"))
    # chunking and pipelining are proven bit-preserving: same key
    assert base == cache.cell_key(
        prog, seed, VectorConfig(device="cpu", max_slot_elems=1,
                                 pipeline=False))
    _pretend_card(monkeypatch)
    distinct = {base}
    for cfg in (VectorConfig(device="cpu", dt=0.01),
                VectorConfig(device="cpu", samples=128),
                VectorConfig(device="cpu", soft=True),
                VectorConfig(device="cuda")):
        k = cache.cell_key(prog, seed, cfg)
        assert k not in distinct, cfg
        distinct.add(k)
    # the seed tree is part of the key
    assert cache.cell_key(prog, (spawn_seed(0, 0, 1), 1), CPU) != base


def test_code_salt_env_override(monkeypatch):
    cur = code_salt()
    # the reference's variable never moves the port's salt
    monkeypatch.setenv("REPRO_CACHE_SALT", "deadbeef")
    code_salt.cache_clear()
    assert code_salt() == cur
    monkeypatch.setenv("REPRO_TORCH_CACHE_SALT", "deadbeef")
    code_salt.cache_clear()
    try:
        assert code_salt() == "deadbeef"
        assert ResultCache(cache_dir=None).salt == "deadbeef"
    finally:
        monkeypatch.delenv("REPRO_TORCH_CACHE_SALT")
        code_salt.cache_clear()
    assert code_salt() == cur


def test_code_salt_covers_the_cuda_sources(tmp_path, monkeypatch):
    """The salt digests every .py, .cu, .cuh and .h file under the package
    root but ``analysis/``, as the reference's leaves its linter out:
    editing a kernel's source invalidates the cache, and nothing else (a
    build output, a bytecode cache, the static analysis) moves it."""
    monkeypatch.delenv("REPRO_TORCH_CACHE_SALT", raising=False)
    code_salt.cache_clear()
    assert code_salt() == tree_digest(PACKAGE_ROOT)
    root = tmp_path / "repro_torch"
    shutil.copytree(PACKAGE_ROOT, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tree_digest(str(root))
    assert base == code_salt()
    csrc = root / "kernels" / "csrc"
    assert (csrc / "vector_step.cu").exists() and (csrc / "sm90.cuh").exists()
    (root / "__pycache__").mkdir()
    (root / "__pycache__" / "x.py").write_text("x = 1\n")
    (root / "kernels" / "vector_step.so").write_bytes(b"\x7fELF")
    rules = root / "analysis" / "lint" / "rules.py"
    rules.write_text(rules.read_text() + "# edited\n")
    assert tree_digest(str(root)) == base
    seen = {base}
    for name, text in (("vector_step.cu", "// edited\n"),
                       ("sm90.cuh", "// edited\n"),
                       ("extra.h", "#pragma once\n")):
        path = csrc / name
        path.write_text((path.read_text() if path.exists() else "") + text)
        k = tree_digest(str(root))
        assert k not in seen, name
        seen.add(k)


# ---------------------------------------------------------------------------
# The device in the key
# ---------------------------------------------------------------------------
def test_device_in_the_key(tmp_path, monkeypatch):
    """The card's rows equal the CPU's only within the rtol 1e-6
    contract: a CPU entry must never answer a card run."""
    assert store.device_sig("cpu") == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        store.device_sig("cuda")
    monkeypatch.undo()
    progs, seeds = _grid(n_points=1, reps=2, duration=2.0)
    cache = ResultCache(cache_dir=str(tmp_path))
    run_cells(progs, seeds, CPU, cache=cache)
    assert cache.stats.stores == 2

    _pretend_card(monkeypatch)
    card = VectorConfig(device="cuda")
    assert cache.vector_sig(card)["device"] == CARD
    assert cache.vector_sig(VectorConfig(device="cuda:0")) == \
        cache.vector_sig(card)
    warm = ResultCache(cache_dir=str(tmp_path))
    assert warm.cell_key(progs[0], seeds[0], card) != \
        warm.cell_key(progs[0], seeds[0], CPU)
    for p, s in zip(progs, seeds):
        assert warm.get_cell(warm.cell_key(p, s, card)) is None
    assert warm.stats.misses == 2 and warm.stats.hits == 0
    # the cold card cells then go to the card, which is absent here: the
    # run raises rather than answering from the CPU's entries
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_cells(progs, seeds, card, cache=ResultCache(
                cache_dir=str(tmp_path)))


def test_a_missing_card_is_error_rows_not_cpu_rows(tmp_path, monkeypatch):
    """With a cache and no card, a vector sweep records error rows, as it
    does uncached: nothing is stored, and nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sw = Sweep(name="nocard", factory=scenario_factory("steady"),
               axes=(Axis("runtime", ("sim", "vector")),),
               fixed={"duration": 1.0}, reps=1, metrics=("n",))
    cache = ResultCache(cache_dir=str(tmp_path))
    sim, vec = run_sweep(sw, progress=None, cache=cache).rows
    assert sim.ok
    assert vec.error.startswith("vector grid: RuntimeError") and \
        "cuda" in vec.error
    assert scan(str(tmp_path))["salts"][cache.salt]["rows"] == 1
    assert scan(str(tmp_path))["salts"][cache.salt]["cells"] == 0
    with pytest.raises(RuntimeError, match="cuda"):
        run_sweep(sw, progress=None, cache=ResultCache(
            cache_dir=str(tmp_path)), fail_fast=True)


def test_device_sig_names_the_card(monkeypatch):
    """``"cuda"`` and ``"cuda:0"`` resolve to the same card name and
    compute capability."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: f"NVIDIA H100 80GB HBM3 #{i}")
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda i=None: (9, 0))
    assert store.device_sig("cuda") == store.device_sig("cuda:0") == \
        "NVIDIA H100 80GB HBM3 #0 sm_90"
    assert store.device_sig("cuda:1") == "NVIDIA H100 80GB HBM3 #1 sm_90"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="1 CUDA device"):
        store.device_sig("cuda:1")


def test_a_missing_device_index_is_the_same_error_rows(tmp_path,
                                                       monkeypatch):
    """On a host with one card, ``device="cuda:1"`` gives the same error
    rows with a cache as without one: the key is uncacheable and the
    real path raises its own error, rather than the cache aborting the
    sweep."""
    def capability(i=None):
        assert i in (None, 0), "Invalid device id"
        return (9, 0)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "get_device_capability", capability)
    sw = Sweep(name="index", factory=scenario_factory("steady"),
               axes=(Axis("runtime", ("sim", "vector")),),
               fixed={"duration": 1.0}, reps=1, metrics=("n",))
    cfg = VectorConfig(device="cuda:1")
    plain = run_sweep(sw, progress=None, vector_config=cfg)
    cache = ResultCache(cache_dir=str(tmp_path))
    cached = run_sweep(sw, progress=None, vector_config=cfg, cache=cache)
    assert _rows(cached) == _rows(plain)
    sim, vec = cached.rows
    assert sim.ok and not vec.ok and vec.error.startswith("vector grid:")
    assert cache.stats.uncacheable == 1     # the cell key
    assert scan(str(tmp_path))["salts"][cache.salt]["rows"] == 1
    assert scan(str(tmp_path))["salts"][cache.salt]["cells"] == 0


# ---------------------------------------------------------------------------
# Cell store round trip + silent-miss contract
# ---------------------------------------------------------------------------
def test_cell_cache_roundtrip_and_partial_miss(tmp_path):
    progs, seeds = _grid()
    plain = run_cells(progs, seeds, CPU)

    cold = ResultCache(cache_dir=str(tmp_path))
    first = run_cells(progs[:3], seeds[:3], CPU, cache=cold)
    assert cold.stats.misses == 3 and cold.stats.stores == 3
    assert _fingerprint_results(first) == _fingerprint_results(plain[:3])

    # a FRESH cache object on the same dir: disk hits for the warm 3,
    # one cold cell — and which cells are cold never changes any bits
    warm = ResultCache(cache_dir=str(tmp_path))
    second = run_cells(progs, seeds, CPU, cache=warm)
    assert warm.stats.hits == 3 and warm.stats.misses == 1
    assert _fingerprint_results(second) == _fingerprint_results(plain)
    for a, b in zip(second, plain):
        for name in ("n_ivl", "occ_ivl"):
            assert getattr(a, name).tobytes() == getattr(b, name).tobytes()
        assert (a.server_ids, a.interval, a.slo, a.shed_ivl) == \
            (b.server_ids, b.interval, b.slo, b.shed_ivl)


def test_warm_run_cells_never_reaches_the_launch(tmp_path, monkeypatch):
    """Every cell warm: ``run_cells`` returns without resolving a device
    or reaching ``_launch_family``; one cold cell: one launch of it."""
    progs, seeds = _grid(n_points=2, reps=2, duration=2.0)
    run_cells(progs, seeds, CPU, cache=ResultCache(cache_dir=str(tmp_path)))
    calls = []
    real_launch = vruntime._launch_family
    real_resolve = vruntime.resolve_device

    def launch(progs, *a, **kw):
        calls.append(len(progs))
        return real_launch(progs, *a, **kw)

    def resolve(*a, **kw):
        calls.append("resolve")
        return real_resolve(*a, **kw)
    monkeypatch.setattr(vruntime, "_launch_family", launch)
    monkeypatch.setattr(vruntime, "resolve_device", resolve)
    warm = ResultCache(cache_dir=str(tmp_path))
    got = run_cells(progs, seeds, CPU, cache=warm)
    assert calls == [] and warm.stats.hits == 4
    assert _fingerprint_results(got) == \
        _fingerprint_results(run_cells(progs, seeds, CPU))
    calls.clear()
    extra = compile_experiment(get("steady", seed=1, duration=2.0,
                                   qps=1200.0).compile())
    run_cells(progs + [extra], seeds + [(spawn_seed(1, 9, 0), 0)], CPU,
              cache=ResultCache(cache_dir=str(tmp_path)))
    assert calls == ["resolve", 1]


def test_memory_hits_share_read_only_arrays():
    """A memory hit hands every caller the same arrays, frozen: a write
    into one raises instead of changing a cached answer."""
    progs, seeds = _grid(n_points=1, reps=1, duration=2.0)
    cache = ResultCache(cache_dir=None)
    (cold,) = run_cells(progs, seeds, CPU, cache=cache)
    (hit,) = run_cells(progs, seeds, CPU, cache=cache)
    assert hit is cold and cache.stats.hits == 1
    for name in ("samples", "sample_ivl", "n_ivl", "util_ivl", "occ_ivl",
                 "qdepth_ivl"):
        assert not getattr(hit, name).flags.writeable, name
    with pytest.raises(ValueError):
        hit.samples[0] = 0.0
    # the consumers only read: the sweep's telemetry and the planner's
    # objective work on frozen arrays
    from repro_torch.plan.planner import _metric_of
    from repro_torch.vector import VectorTelemetry
    tel = VectorTelemetry(hit)
    assert tel.overall().n == hit.n and tel.series()
    assert math.isfinite(_metric_of(hit, "p99"))


def test_cell_corruption_is_a_silent_miss(tmp_path):
    progs, seeds = _grid(n_points=1, reps=1)
    cache = ResultCache(cache_dir=str(tmp_path))
    baseline = run_cells(progs, seeds, CPU, cache=cache)

    entries = []
    for dirpath, _dirs, files in os.walk(tmp_path):
        entries += [os.path.join(dirpath, f) for f in files]
    assert len(entries) == 1
    with open(entries[0], "wb") as f:
        f.write(b"not an npz at all")

    fresh = ResultCache(cache_dir=str(tmp_path))
    redo = run_cells(progs, seeds, CPU, cache=fresh)
    assert fresh.stats.errors == 1 and fresh.stats.hits == 0
    assert _fingerprint_results(redo) == _fingerprint_results(baseline)


def test_stale_salt_entry_is_a_silent_miss(tmp_path):
    cache = ResultCache(cache_dir=str(tmp_path))
    key = cache.key("row", "payload-under-an-old-code-version")
    cache.put_row(key, {"metrics": {"p99": 1.0}})
    path = cache._path(key, "row")
    with open(path) as f:
        entry = json.load(f)
    entry["salt"] = "0" * 16            # as if written by older code
    with open(path, "w") as f:
        json.dump(entry, f)

    fresh = ResultCache(cache_dir=str(tmp_path))
    assert fresh.get_row(key) is None
    assert fresh.stats.errors == 1 and fresh.stats.misses == 1


def test_foreign_cell_entry_is_a_silent_miss(tmp_path):
    """An entry filed under another key (a copied or renamed file) is a
    miss: the recorded key is re-checked on load."""
    progs, seeds = _grid(n_points=1, reps=2, duration=2.0)
    cache = ResultCache(cache_dir=str(tmp_path))
    run_cells(progs, seeds, CPU, cache=cache)
    k0, k1 = (cache.cell_key(p, s, CPU) for p, s in zip(progs, seeds))
    shutil.copy(cache._path(k0, "cell"), cache._path(k1, "cell"))
    fresh = ResultCache(cache_dir=str(tmp_path))
    assert fresh.get_cell(k1) is None and fresh.stats.errors == 1
    assert fresh.get_cell(k0) is not None


# ---------------------------------------------------------------------------
# Sweep rows: cached == recomputed, bit for bit, on every executor
# ---------------------------------------------------------------------------
def _mixed_sweep(cls=Sweep, axis=Axis, factory=scenario_factory):
    return cls(name="mix", factory=factory("steady"),
               axes=(axis("runtime", ("sim", "engine", "vector")),
                     axis("qps", (150.0, 300.0))),
               fixed={"duration": 1.5}, reps=2, base_seed=9,
               metrics=("n", "mean", "p50", "p95", "p99", "dropped"))


def test_sweep_rows_bit_identical_cached_vs_recomputed(tmp_path):
    sweep = _mixed_sweep()
    plain = run_sweep(sweep, vector_config=CPU, progress=None)
    plain = plain.to_dict()["rows"]

    cold = ResultCache(cache_dir=str(tmp_path))
    first = run_sweep(sweep, vector_config=CPU, cache=cold, progress=None)
    assert not first.errors
    assert first.to_dict()["rows"] == plain
    assert cold.stats.hits == 0 and cold.stats.stores >= len(first.rows)

    # warm re-runs across serial / 2-worker / 8-worker: all hits, and
    # the rows cannot depend on the executor or worker count
    for executor, workers in (("serial", None), ("process", 2),
                              ("process", 8)):
        warm = ResultCache(cache_dir=str(tmp_path))
        frame = run_sweep(sweep, executor=executor, workers=workers,
                          vector_config=CPU, cache=warm, progress=None)
        assert frame.to_dict()["rows"] == plain, (executor, workers)
        assert warm.stats.hits == len(frame.rows)
        assert warm.stats.misses == 0


def test_mixed_process_frame_looks_up_and_writes_back_in_the_parent(
        tmp_path):
    """A cold ``sim|vector`` frame under the process executor: rows are
    looked up and stored in this process (the workers never see the
    cache), and a warm re-run is all hits."""
    sweep = Sweep(name="mixed", factory=scenario_factory("steady"),
                  axes=(Axis("runtime", ("sim", "vector")),
                        Axis("qps", (300.0, 900.0))),
                  fixed={"duration": 1.5}, reps=2, runtime="vector",
                  metrics=("n", "mean", "p99", "dropped", "shed"))
    serial = run_sweep(sweep, vector_config=CPU, progress=None)
    cold = ResultCache(cache_dir=str(tmp_path))
    proc = run_sweep(sweep, executor="process", workers=2,
                     vector_config=CPU, cache=cold, progress=None)
    assert _rows(proc) == _rows(serial)
    assert cold.stats.lookups == 8 + 4     # 8 rows, then 4 vector cells
    assert scan(str(tmp_path))["salts"][cold.salt]["rows"] == 8
    warm = ResultCache(cache_dir=str(tmp_path))
    again = run_sweep(sweep, executor="process", workers=2,
                      vector_config=CPU, cache=warm, progress=None)
    assert _rows(again) == _rows(serial)
    assert (warm.stats.hits, warm.stats.misses) == (8, 0)


def test_sweep_cache_hits_preserve_declaration_order(tmp_path):
    sweep = Sweep(name="order", factory=scenario_factory("steady"),
                  axes=(Axis("qps", (150.0, 300.0, 450.0)),),
                  fixed={"duration": 1.0}, reps=2, base_seed=3,
                  metrics=("n", "p99"))
    plain = run_sweep(sweep, progress=None)
    pre = ResultCache(cache_dir=str(tmp_path))
    run_sweep(sweep, cache=pre, progress=None)

    # evict only the MIDDLE point's entries: a partial hit pattern with
    # a cold hole in the middle must not reorder or change any row
    from repro_torch.sweep.executor import _row_key
    probe = ResultCache(cache_dir=str(tmp_path))
    for rep in range(2):
        key = _row_key(probe, sweep, 1, {"duration": 1.0, "qps": 300.0},
                       rep)
        os.remove(probe._path(key, "row"))

    warm = ResultCache(cache_dir=str(tmp_path))
    frame = run_sweep(sweep, cache=warm, progress=None)
    assert warm.stats.hits == 4 and warm.stats.misses == 2
    assert [r.params for r in frame.rows] == [r.params for r in plain.rows]
    assert frame.to_dict() == plain.to_dict()


def test_error_rows_are_never_stored(tmp_path):
    """A row that fails is recomputed on every run, never replayed."""
    sweep = Sweep(name="bad", factory=scenario_factory("steady"),
                  axes=(Axis("qps", (150.0,)),), fixed={"duration": 1.0},
                  reps=2, metrics=("n", "no_such_metric"))
    cache = ResultCache(cache_dir=str(tmp_path))
    frame = run_sweep(sweep, cache=cache, progress=None)
    assert len(frame.errors) == 2 and cache.stats.stores == 0
    again = ResultCache(cache_dir=str(tmp_path))
    frame = run_sweep(sweep, cache=again, progress=None)
    assert len(frame.errors) == 2
    assert (again.stats.hits, again.stats.misses) == (0, 2)


def test_telemetry_and_per_client_rows_round_trip(tmp_path):
    sweep = Sweep(name="tele", factory=scenario_factory("steady"),
                  axes=(Axis("qps", (200.0,)),), fixed={"duration": 2.0},
                  reps=1, base_seed=1, metrics=("n", "p99"),
                  telemetry=True, per_client=True)
    plain = run_sweep(sweep, progress=None).to_dict()
    cold = ResultCache(cache_dir=str(tmp_path))
    run_sweep(sweep, cache=cold, progress=None)
    warm = ResultCache(cache_dir=str(tmp_path))
    frame = run_sweep(sweep, cache=warm, progress=None)
    assert warm.stats.hits == 1
    assert frame.to_dict() == plain
    assert frame.rows[0].series is not None
    assert frame.rows[0].clients is not None


def _assert_vector_rows_close(got, want):
    for m, v in want.items():
        if m == "n":
            assert abs(got[m] - v) <= 1
        elif m == "dropped":
            assert got[m] == v
        else:
            assert math.isclose(got[m], v, rel_tol=RTOL), m


def test_cached_frames_match_the_reference(tmp_path):
    """The mixed sweep through the port's cache, cold and warm, against
    ``repro.sweep.run_sweep`` (uncached): ``sim`` and ``engine`` rows bit
    for bit, ``vector`` rows within the ``impl="ref"`` contract."""
    want = jax_run_sweep(_mixed_sweep(JSweep, JAxis, jax_scenario_factory),
                         vector_config=JAX_REF, progress=None)
    for label in ("cold", "warm"):
        cache = ResultCache(cache_dir=str(tmp_path))
        got = run_sweep(_mixed_sweep(), vector_config=CPU, cache=cache,
                        progress=None)
        if label == "warm":
            assert cache.stats.misses == 0
        assert len(got.rows) == len(want.rows) == 12
        for g, w in zip(got.rows, want.rows):
            assert (g.index, g.params, g.rep, g.seed, g.stream) == \
                (w.index, w.params, w.rep, w.seed, w.stream)
            if g.params["runtime"] == "vector":
                _assert_vector_rows_close(g.metrics, w.metrics)
            else:
                assert json.dumps(g.to_dict()) == json.dumps(w.to_dict())


# ---------------------------------------------------------------------------
# Single cells: VectorRuntime and run_scenario
# ---------------------------------------------------------------------------
def test_run_scenario_and_vector_runtime_take_the_cache(tmp_path):
    sc = get("server-failure", duration=3.0, seed=2)
    plain = run_scenario(sc, "vector", vector_config=CPU, rep=1)
    cold = ResultCache(cache_dir=str(tmp_path))
    first = run_scenario(sc, "vector", vector_config=CPU, rep=1, cache=cold)
    assert (cold.stats.misses, cold.stats.stores) == (1, 1)
    warm = ResultCache(cache_dir=str(tmp_path))
    second = run_scenario(sc, "vector", vector_config=CPU, rep=1,
                          cache=warm)
    assert warm.stats.hits == 1
    for rt in (first, second):
        assert _fingerprint_results([rt.result]) == \
            _fingerprint_results([plain.result])
        assert json.dumps(rt.telemetry.to_rows()) == \
            json.dumps(plain.telemetry.to_rows())
        assert rt.dropped == plain.dropped and rt.shed == plain.shed
    # the same cell through the runtime adapter and the grid path
    rt = VectorRuntime(sc.compile(), rep=1, config=CPU, cache=warm)
    rt.run()
    assert rt.result is second.result and warm.stats.hits == 2
    # another repetition is another cell
    run_scenario(sc, "vector", vector_config=CPU, rep=0, cache=warm)
    assert warm.stats.misses == 1


# ---------------------------------------------------------------------------
# Planner reuse
# ---------------------------------------------------------------------------
PLAN_KW = dict(scenario="steady", objective="p99", slo=0.02,
               overrides={"policy": "jsq", "qps": 2000.0, "duration": 3.0},
               params={"capacity": (4.0, 1.0, 6.0)},
               steps=12, starts=1, samples=512, seed=0,
               reps=2, probe_reps=1)


def test_planner_reuses_cells_across_runs(tmp_path):
    """Cold, the cache serves only what the run itself repeats; warm,
    every exact cell: ``cell_evals == 0`` and the same answer.  Both
    against the reference's run with its own (memory) cache."""
    spec = PlanSpec(**PLAN_KW)
    plain = run_plan(spec, vector_config=CPU)
    cold = ResultCache(cache_dir=str(tmp_path))
    res1 = run_plan(spec, vector_config=CPU, cache=cold)
    assert 0 < res1.cell_evals <= plain.cell_evals
    assert res1.cell_evals == plain.cell_evals - cold.stats.hits
    warm = ResultCache(cache_dir=str(tmp_path))
    res2 = run_plan(spec, vector_config=CPU, cache=warm)
    assert res2.cell_evals == 0          # every exact cell came warm
    assert warm.stats.misses == 0
    for res in (res1, res2):
        assert res.n_star == plain.n_star
        # probes of one repetition carry a NaN CI: compare as JSON
        assert json.dumps(res.verified) == json.dumps(plain.verified)
        assert json.dumps(res.probes) == json.dumps(plain.probes)

    want = jax_run_plan(JPlanSpec(**PLAN_KW), vector_config=JAX_REF,
                        cache=JaxResultCache(cache_dir=None))
    assert res1.n_star == res2.n_star == want.n_star
    assert res1.cell_evals == want.cell_evals
    assert [(p["n"], p["meets"]) for p in res2.probes] == \
        [(p["n"], p["meets"]) for p in want.probes]
    np.testing.assert_allclose(res2.verified["values"],
                               want.verified["values"], rtol=RTOL)


def test_optimize_sweep_hands_the_cache_to_the_planner(tmp_path):
    sweep = Sweep(name="plan-steady", factory=None, mode="optimize",
                  optimize={"scenario": "steady", "slo": 0.02, "steps": 12,
                            "starts": 1, "samples": 512, "probe_reps": 1,
                            "params": {"capacity": [4.0, 1.0, 6.0]}},
                  fixed=dict(PLAN_KW["overrides"]), reps=2, base_seed=0)
    cold = ResultCache(cache_dir=str(tmp_path))
    first = run_sweep(sweep, vector_config=CPU, cache=cold, progress=None)
    warm = ResultCache(cache_dir=str(tmp_path))
    second = run_sweep(sweep, vector_config=CPU, cache=warm, progress=None)
    assert warm.stats.misses == 0 and warm.stats.hits > 0
    final = [r for r in second.rows if r.params["phase"] == "final"]
    assert final[0].metrics["cell_evals"] == 0.0

    def strip(frame):
        return json.dumps([(r.params, {k: v for k, v in r.metrics.items()
                                       if k != "cell_evals"})
                           for r in frame.rows])
    assert strip(first) == strip(second)


# ---------------------------------------------------------------------------
# Rate-array dedupe in the vector compiler
# ---------------------------------------------------------------------------
def test_rate_array_memo_bit_identical():
    from repro.core.client import ClientConfig as JClientConfig
    from repro.core.client import ConstantQPS as JConstantQPS
    from repro.core.client import DiurnalQPS as JDiurnalQPS
    from repro.core.harness import Experiment as JExperiment
    from repro.core.harness import ServerSpec as JServerSpec
    from repro_torch.vector import compile as vcompile

    def diurnal(C, Q, E, S):
        return E(clients=tuple(C(i, Q(250.0, 100.0, period=5.0), seed=i)
                               for i in range(3)),
                 servers=(S(0),), duration=3.0, seed=5)

    def constant(C, Q, E, S):
        return E(clients=tuple(C(i, Q(100.0 + 50.0 * i), seed=i)
                               for i in range(4)),
                 servers=(S(0),), duration=2.0, seed=1)

    exp = diurnal(ClientConfig, DiurnalQPS, Experiment, ServerSpec)
    vcompile._RATE_CACHE.clear()
    a = compile_experiment(exp)
    assert len(vcompile._RATE_CACHE) == 1     # 3 identical schedules
    assert not next(iter(vcompile._RATE_CACHE.values())).flags.writeable
    vcompile._RATE_CACHE.clear()
    b = compile_experiment(exp)
    assert np.array_equal(a.rate_conn, b.rate_conn)
    assert np.array_equal(a.rate_free, b.rate_free)

    # eviction under a cap of 1 cannot change any compiled rates
    old_cap = vcompile._RATE_CACHE_CAP
    vcompile._RATE_CACHE_CAP = 1
    try:
        vcompile._RATE_CACHE.clear()
        exp2 = constant(ClientConfig, ConstantQPS, Experiment, ServerSpec)
        capped = compile_experiment(exp2)
        assert len(vcompile._RATE_CACHE) <= 1
    finally:
        vcompile._RATE_CACHE_CAP = old_cap
    vcompile._RATE_CACHE.clear()
    full = compile_experiment(exp2)
    assert np.array_equal(capped.rate_conn, full.rate_conn)
    assert np.array_equal(capped.rate_free, full.rate_free)

    # the memoized rates are the reference's, bit for bit
    for build, prog in ((diurnal, a), (constant, full)):
        ref = jax_compile(build(JClientConfig,
                                JDiurnalQPS if build is diurnal
                                else JConstantQPS, JExperiment, JServerSpec))
        assert prog.rate_conn.tobytes() == ref.rate_conn.tobytes()
        assert prog.rate_free.tobytes() == ref.rate_free.tobytes()


class FnQPS(QPSSchedule):
    """A schedule whose law is a callable: a lambda has no canonical
    form, so its rates are not memoized."""

    def __init__(self, fn):
        self.fn = fn

    def rate(self, t: float) -> float:
        return self.fn(t)


def test_unfingerprintable_schedule_skips_the_memo():
    from repro_torch.vector import compile as vcompile
    exp = Experiment(clients=(ClientConfig(0, FnQPS(lambda t: 200.0),
                                           seed=0),),
                     servers=(ServerSpec(0),), duration=1.0, seed=0)
    vcompile._RATE_CACHE.clear()
    prog = compile_experiment(exp)
    assert len(vcompile._RATE_CACHE) == 0
    want = compile_experiment(Experiment(
        clients=(ClientConfig(0, ConstantQPS(200.0), seed=0),),
        servers=(ServerSpec(0),), duration=1.0, seed=0))
    assert prog.rate_conn.tobytes() == want.rate_conn.tobytes()


# ---------------------------------------------------------------------------
# Streaming ResultFrame JSON
# ---------------------------------------------------------------------------
def _tele_frame():
    sweep = Sweep(name="stream", factory=scenario_factory("steady"),
                  axes=(Axis("qps", (200.0, 400.0)),),
                  fixed={"duration": 1.5}, reps=2, base_seed=2,
                  metrics=("n", "mean", "p99"), telemetry=True,
                  per_client=True)
    return run_sweep(sweep, progress=None)


def test_streaming_json_byte_identical_to_dumps(tmp_path):
    frame = _tele_frame()
    expected = json.dumps(frame.to_dict(), indent=1)
    assert frame.to_json() == expected
    path = str(tmp_path / "frame.json")
    frame.to_json(path)
    with open(path) as f:
        assert f.read() == expected
    # empty frame too
    empty = ResultFrame(name="none", spec={"metrics": ["n"]}, rows=[])
    assert empty.to_json() == json.dumps(empty.to_dict(), indent=1)


def test_streaming_json_round_trip_is_exact(tmp_path):
    frame = _tele_frame()
    path = str(tmp_path / "frame.json")
    frame.to_json(path)
    back = ResultFrame.from_json(path)             # streamed reader
    assert back.to_dict() == frame.to_dict()
    with open(path) as f:
        text_back = ResultFrame.from_json(f.read())
    assert text_back.to_dict() == frame.to_dict()
    rows = list(ResultFrame.iter_json_rows(path))
    assert len(rows) == len(frame.rows)
    assert rows[0].metrics == frame.rows[0].metrics
    assert rows[-1].params == frame.rows[-1].params


# ---------------------------------------------------------------------------
# Pipelined chunk execution
# ---------------------------------------------------------------------------
def test_pipeline_on_off_bit_identical(tmp_path):
    progs, seeds = _grid(n_points=3, reps=2)
    sync = run_cells(progs, seeds, VectorConfig(device="cpu",
                                                max_slot_elems=1,
                                                pipeline=False))
    piped = run_cells(progs, seeds, VectorConfig(device="cpu",
                                                 max_slot_elems=1))
    assert _fingerprint_results(sync) == _fingerprint_results(piped)
    # chunked, pipelined and cached: the stores land as chunks finish
    cache = ResultCache(cache_dir=str(tmp_path))
    cached = run_cells(progs, seeds, VectorConfig(device="cpu",
                                                  max_slot_elems=1),
                       cache=cache)
    assert cache.stats.stores == len(progs)
    assert _fingerprint_results(cached) == _fingerprint_results(sync)


# ---------------------------------------------------------------------------
# Maintenance CLI + arg plumbing
# ---------------------------------------------------------------------------
def test_cache_cli_stats_verify_gc(tmp_path, capsys):
    from repro_torch.cache.__main__ import main
    d = str(tmp_path / "cache")
    cache = ResultCache(cache_dir=d)
    k1 = cache.key("row", "a")
    cache.put_row(k1, {"metrics": {"p99": 0.5}})
    prog = compile_experiment(get("steady", seed=0, duration=1.0).compile())
    run_cells([prog], [(1, 0)], CPU, cache=cache)
    # a stale-salt tree from an imaginary older code version
    os.makedirs(os.path.join(d, "f" * 16, "ab"))

    assert main(["stats", "--cache-dir", d]) == 0
    out = capsys.readouterr().out
    assert "1 rows, 1 cells" in out and "(stale)" in out

    assert main(["verify", "--cache-dir", d]) == 0
    rep = scan(d)
    assert rep["salts"][cache.salt]["rows"] == 1

    # corrupt the row entry: verify flags it, gc removes it + stale tree
    with open(cache._path(k1, "row"), "w") as f:
        f.write("{ truncated")
    assert main(["verify", "--cache-dir", d]) == 1
    assert main(["gc", "--cache-dir", d]) == 0
    out = capsys.readouterr().out
    assert "1 stale salt tree(s), 1 corrupt entries" in out.splitlines()[-1]
    assert verify(d)["corrupt"] == []
    assert not os.path.isdir(os.path.join(d, "f" * 16))
    left = cache_gc(d, all_salts=True)
    assert cache.salt in left["removed_salts"]


def test_cache_from_args_flag_combinations(tmp_path):
    ap = argparse.ArgumentParser()
    add_cache_args(ap)
    assert cache_from_args(ap.parse_args([])) is None
    assert cache_from_args(ap.parse_args(["--no-cache"])) is None
    c = cache_from_args(ap.parse_args(["--cache"]))
    assert c is not None and c.cache_dir == DEFAULT_CACHE_DIR
    d = str(tmp_path / "c")
    c = cache_from_args(ap.parse_args(["--cache-dir", d]))
    assert c is not None and c.cache_dir == d
    assert cache_from_args(ap.parse_args(["--cache-dir", d,
                                          "--no-cache"])) is None


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, *args], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def _stats(stdout: str, cache_dir: str) -> dict:
    """The ``cache[DIR] hits=.. misses=..`` line a CLI prints -> counts."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith("cache[")]
    assert len(lines) == 1, stdout
    head, _, counts = lines[0].partition(" ")
    assert head == f"cache[{cache_dir}]"
    return {k: int(v) for k, v in (kv.split("=") for kv in counts.split())}


CLI_CASES = {
    "sweep": ["-m", "repro_torch.sweep", "steady", "--axis", "qps=300,600",
              "--set", "duration=1.5", "--reps", "2", "--device", "cpu",
              "--quiet"],
    "scenarios": ["-m", "repro_torch.scenarios", "steady", "--duration",
                  "2", "--device", "cpu"],
    "plan": ["-m", "repro_torch.plan", "steady", "--slo", "0.02", "--set",
             "policy=jsq", "--set", "qps=2000", "--set", "duration=3",
             "--capacity", "4,1,6", "--steps", "12", "--starts", "1",
             "--samples", "512", "--probe-reps", "1", "--reps", "2",
             "--device", "cpu", "--quiet"],
}


@pytest.mark.parametrize("cli", sorted(CLI_CASES))
def test_cli_cache_flags_in_a_subprocess(cli, tmp_path):
    """Each CLI twice on one ``--cache-dir``: the first run misses and
    stores, the second is all hits, and the outputs agree."""
    d = str(tmp_path / "cache")
    args = CLI_CASES[cli] + ["--cache-dir", d]
    if cli != "scenarios":
        args += ["--out", str(tmp_path / "out")]
    outs = []
    for _ in range(2):
        out = _run(args, cwd=tmp_path)
        assert out.returncode == 0, out.stderr[-2000:]
        outs.append(out.stdout)
    cold, warm = (_stats(o, d) for o in outs)
    assert cold["misses"] > 0 and cold["stores"] > 0 and not cold["errors"]
    assert warm["misses"] == warm["stores"] == warm["errors"] == 0
    assert warm["hits"] > 0
    assert [ln for ln in outs[0].splitlines() if not ln.startswith("cache[")
            and "exact cells" not in ln] == \
        [ln for ln in outs[1].splitlines() if not ln.startswith("cache[")
         and "exact cells" not in ln]
    if cli == "plan":
        assert "; 0 exact cells)" in outs[1]
    if cli != "sweep":
        return
    # --no-cache wins over --cache-dir: no stats line
    out = _run(args + ["--no-cache"], cwd=tmp_path)
    assert out.returncode == 0 and "cache[" not in out.stdout
    # the maintenance CLI sees what the runs stored
    out = _run(["-m", "repro_torch.cache", "stats", "--cache-dir", d,
                "--json"], cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    rep = json.loads(out.stdout)
    info = rep["salts"][rep["current_salt"]]
    assert (info["rows"], info["cells"]) == (4, 4) and not info["stale"]
    out = _run(["-m", "repro_torch.cache", "verify", "--cache-dir", d],
               cwd=tmp_path)
    assert out.returncode == 0 and "checked 8 entries, 0 corrupt" in \
        out.stdout


def test_port_gc_leaves_the_reference_cache_alone(tmp_path):
    """The two packages keep apart directories by default: the port's
    ``gc --all`` (which removes every salt tree of its directory) leaves
    the reference's entries where they are, and the reverse."""
    from repro.cache import DEFAULT_CACHE_DIR as JAX_DEFAULT
    assert DEFAULT_CACHE_DIR != JAX_DEFAULT
    ref = JaxResultCache(cache_dir=str(tmp_path / JAX_DEFAULT))
    ref.put_row(ref.key("row", "reference"), {"metrics": {"p99": 1.0}})
    port = ResultCache(cache_dir=str(tmp_path / DEFAULT_CACHE_DIR))
    port.put_row(port.key("row", "port"), {"metrics": {"p99": 2.0}})
    ref_files = sorted(str(p) for p in (tmp_path / JAX_DEFAULT).rglob("*"))
    out = _run(["-m", "repro_torch.cache", "gc", "--all"], cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "removed 1 stale salt tree(s)" in out.stdout
    assert sorted(str(p) for p in (tmp_path / JAX_DEFAULT).rglob("*")) == \
        ref_files
    assert scan(str(tmp_path / DEFAULT_CACHE_DIR))["salts"] == {}
    from repro.cache import scan as jax_scan
    assert jax_scan(str(tmp_path / JAX_DEFAULT))["salts"][ref.salt][
        "rows"] == 1
