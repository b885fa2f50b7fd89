"""The port's NumPy vector backend against the JAX package's.

``VectorConfig(backend="numpy")`` runs the reference's namespace-generic
step math with ``np`` in f64 on the host and the reference's partition
quantiles, on the same NumPy draws, so its rows are held to the
reference's ``VectorConfig(backend="numpy")`` rows BIT FOR BIT (no
tolerance): n, mean, p50/p95/p99, dropped, every kept sample and every
interval series.  Sizes are the existing port tests': the canonical
scenarios at 5 s and the chaos scenarios at full duration, seed 3,
stream 1.

Also: ``"auto"`` is ``"torch"``; ``"jax"`` (and any other name) raises
``ValueError``; soft mode with numpy raises ``RuntimeError``; the numpy
backend never initialises CUDA (it runs with ``device="cuda"`` where
there is no card); the cache keys of the two backends differ; and
``--vector-backend numpy`` on both CLIs, in subprocesses with the card
hidden, prints the reference CLI's report and writes its sweep CSV.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from repro import scenarios as jsc  # noqa: E402
from repro.vector import VectorConfig as JaxConfig  # noqa: E402
from repro.vector import compile_experiment as jax_compile  # noqa: E402
from repro.vector import run_cells as jax_run  # noqa: E402

from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.cache import ResultCache  # noqa: E402
from repro_torch.core.stats import (quantiles_partition,  # noqa: E402
                                    quantiles_partition_batched)
from repro_torch.vector import (VectorConfig, compile_experiment,  # noqa: E402
                                run_cells)

NUMPY = VectorConfig(backend="numpy", device="cuda")   # device not read
JAX_NUMPY = JaxConfig(backend="numpy")
CANONICAL = ["steady", "flash-crowd", "diurnal-fleet", "server-failure",
             "elastic-autoscale", "batched-serving", "churn-storm"]
CHAOS = [("retry-storm", {}), ("correlated-failure", {}),
         ("gray-failure", {}), ("flash-crowd-autoscale", {}),
         ("flash-crowd-autoscale", dict(controller="admission_shedder",
                                        peak_qps=4000.0))]
REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _programs(name, **kw):
    return (compile_experiment(tsc.get(name, **kw).compile()),
            jax_compile(jsc.get(name, **kw).compile()))


def _assert_rows_equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert (g.n, g.mean, g.p50, g.p95, g.p99, g.dropped) == \
            (w.n, w.mean, w.p50, w.p95, w.p99, w.dropped)
        for m in ("samples", "sample_ivl", "n_ivl", "util_ivl", "occ_ivl",
                  "qdepth_ivl", "tokens_ivl", "shed_ivl"):
            a, b = getattr(g, m), getattr(w, m)
            assert (a is None) == (b is None), m
            if b is not None:
                np.testing.assert_array_equal(a, b, err_msg=m)


@pytest.mark.parametrize("name", CANONICAL)
def test_canonical_rows_bit_identical(name):
    port, ref = _programs(name, duration=5.0, seed=3)
    _assert_rows_equal(run_cells([port], [(3, 1)], NUMPY),
                       jax_run([ref], [(3, 1)], JAX_NUMPY))


@pytest.mark.parametrize("name,kw", CHAOS)
def test_chaos_rows_bit_identical(name, kw):
    port, ref = _programs(name, seed=3, **kw)
    _assert_rows_equal(run_cells([port], [(3, 1)], NUMPY),
                       jax_run([ref], [(3, 1)], JAX_NUMPY))


def test_mixed_grid_bit_identical():
    """Two scalar shape buckets and a batched one in one call, several
    cells a bucket: the [cell, server] scan and the padded quantile
    matrix as the reference runs them."""
    port, ref, seeds = [], [], []
    for i, (name, kw) in enumerate((("steady", dict(qps=900.0)),
                                    ("server-failure", dict(duration=3.0)),
                                    ("batched-serving", {}))):
        for rep in range(2):
            p, r = _programs(name, seed=11 + i, **dict(dict(duration=5.0),
                                                         **kw))
            port.append(p)
            ref.append(r)
            seeds.append((11 + i, rep))
    _assert_rows_equal(run_cells(port, seeds, NUMPY),
                       jax_run(ref, seeds, JAX_NUMPY))


def test_quantiles_partition_batched_equals_rows():
    rng = np.random.default_rng(0)
    counts = np.array([0, 1, 2, 7, 1000])
    mat = np.zeros((5, 1000))
    for i, n in enumerate(counts):
        mat[i, :n] = rng.lognormal(size=n)
    out = quantiles_partition_batched(mat, counts, (50.0, 95.0, 99.0))
    assert np.isnan(out[0]).all()
    for i in range(1, 5):
        np.testing.assert_array_equal(
            out[i], quantiles_partition(mat[i, :counts[i]], (50, 95, 99)))


def test_backend_names():
    assert VectorConfig().resolve_backend() == "torch"
    assert VectorConfig(backend="torch").resolve_backend() == "torch"
    assert NUMPY.resolve_backend() == "numpy"
    prog, _ = _programs("steady", duration=1.0)
    for bad in ("jax", "cupy"):
        with pytest.raises(ValueError, match="'auto', 'torch' or 'numpy'"):
            run_cells([prog], [(0, 0)], VectorConfig(backend=bad,
                                                     device="cpu"))


def test_soft_with_numpy_raises():
    prog, _ = _programs("steady", duration=1.0)
    with pytest.raises(RuntimeError, match="torch backend"):
        run_cells([prog], [(0, 0)], VectorConfig(backend="numpy",
                                                 soft=True))


def test_cache_keys_of_the_backends_differ():
    cache = ResultCache(cache_dir=None)
    prog, _ = _programs("steady", duration=1.0)
    torch_key = cache.cell_key(prog, (0, 0), VectorConfig(device="cpu"))
    numpy_key = cache.cell_key(prog, (0, 0), NUMPY)
    assert None not in (torch_key, numpy_key) and torch_key != numpy_key
    assert cache.vector_sig(NUMPY)["device"] == "host"
    # the numpy key does not depend on ``device``
    assert numpy_key == cache.cell_key(
        prog, (0, 0), VectorConfig(backend="numpy", device="cpu"))
    # a warm numpy run is served from the numpy key, not a torch row
    first = run_cells([prog], [(0, 0)], NUMPY, cache=cache)[0]
    hits = cache.stats.hits
    again = run_cells([prog], [(0, 0)], NUMPY, cache=cache)[0]
    assert cache.stats.hits == hits + 1 and again.p99 == first.p99


def _run(args, cwd, card_hidden=True) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    if card_hidden:
        env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, *args], env=env, cwd=cwd,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    return out


def test_scenarios_cli_numpy_backend(tmp_path):
    """No card and no ``--device cpu``: the numpy backend runs on the
    host and prints the reference CLI's report line for line."""
    got = _run(["-m", "repro_torch.scenarios", "steady", "--vector-backend",
                "numpy", "--duration", "3"], tmp_path).stdout.splitlines()
    want = _run(["-m", "repro.scenarios", "steady", "--backend", "vector",
                 "--vector-backend", "numpy", "--duration", "3"],
                tmp_path, card_hidden=False).stdout.splitlines()
    assert got[0] == want[0] + " device=host"
    assert got[1:] == want[1:]


def test_sweep_cli_numpy_backend(tmp_path):
    common = ["steady", "--axis", "qps=300,600", "--reps", "2", "--set",
              "duration=3", "--vector-backend", "numpy", "--quiet"]
    _run(["-m", "repro_torch.sweep", *common, "--out", "port"], tmp_path)
    _run(["-m", "repro.sweep", *common, "--runtime", "vector", "--out",
          "ref"], tmp_path, card_hidden=False)
    got = (tmp_path / "port" / "steady.csv").read_text()
    assert got == (tmp_path / "ref" / "steady.csv").read_text()
    assert len(got.splitlines()) == 5
