"""The port's vector kernels on the CPU against the JAX package.

The same inputs, made from a seed with NumPy, go through the JAX
functions and the port's counterparts:

* the step math (``repro_torch.kernels.ref.scalar_step`` /
  ``batched_step``) against ``repro.kernels.ref.vector_slot_advance``,
  bit-equal: op by op (eager, unfused) the two are the same f32
  arithmetic, and both sum over server lanes left to right.  Against
  the Pallas kernels ``scalar_slot_advance`` / ``batched_slot_advance``
  in interpret mode, and after a 64-slot ``lax.scan``, the tolerance is
  rtol 1e-6 / atol 1e-6 per slot and rtol 1e-5 / atol 1e-6 after the
  scan: those run jitted, and XLA on the CPU fuses and may contract a
  multiply-add into an FMA (tests/test_vector_kernels.py).  A
  contracted sum that cancels leaves a residue of up to an ulp of its
  operands (7.6e-6 at a queue length of 64), so that comparison holds
  for these seeded inputs, not for any input;
* the quantile head (``ref.fused_quantiles``) bit-equal to the sort
  oracle ``repro.kernels.ref.fused_quantiles``, and within 1 ulp of the
  radix-select Pallas kernel in interpret mode: the two select the same
  order statistics, but XLA contracts the interpret-mode kernel's lerp
  ``b - (b - a) * (1 - t)`` into an FMA where the oracle rounds the
  product first (the oracle is what the JAX runtime's ``impl="ref"``
  path runs).  XLA on the CPU also flushes subnormals to zero, which
  PyTorch and the card keep: rows of subnormal latencies are held
  bit-equal to the same oracle written in NumPy f32, and to JAX's once
  their subnormal results are flushed.  The edge rows are those of the
  card tests (``tests/_quantile_rows.py``);
* the quantile kernel's launch plan (``vector_quantiles.launch_plan``,
  a pure function of the shape) over a range of shapes.

On the CPU, ``kernels.ops`` takes these plain versions; the CUDA kernels
themselves are held against them on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import vector_quantiles as jvq  # noqa: E402
from repro.kernels import vector_step as jvs  # noqa: E402

from repro_torch.kernels import ops, ref, vector_quantiles  # noqa: E402
from repro_torch.kernels import vector_step  # noqa: E402

from _quantile_rows import KINDS, quantile_rows  # noqa: E402

C = 8                     # one Pallas cell tile
DT = 0.005


def _inputs(S: int, batched: bool, T: int = 1, seed: int = 0):
    """NumPy inputs for a [C, S] tile over T slots: failure slots,
    masked (non-accepting or inactive) lanes, and cells whose lanes all
    refuse requests."""
    g = np.random.default_rng((seed, S, int(batched)))
    f32 = np.float32
    c = g.integers(1, 7, (C, S)).astype(f32)
    fail = np.where(g.random((C, S)) < 0.3, g.integers(0, max(T, 4), (C, S)),
                    -1).astype(np.int32)
    act = (g.random((T, C, S)) < 0.9).astype(f32)
    acc = act * (g.random((T, C, S)) < 0.85).astype(f32)
    acc[:, 1] = 0.0                              # a cell nobody accepts in
    acc[: T // 2 + 1, 5] = 0.0                   # ... and one for a while
    spd = (g.random((T, C, S)) + 0.5).astype(f32)
    Nc = (g.random((T, C, S)) * 5.0).astype(f32)
    Nf = (g.random((T, C)) * 4.0).astype(f32)
    if not batched:
        consts = {"c": c, "fail_slot": fail}
        carry = ((g.random((C, S)) * 0.02).astype(f32),
                 (g.random((C, S)) * 3.0).astype(f32),
                 g.integers(0, 5, C).astype(f32))
        xs = (np.arange(T, dtype=np.int32), Nc,
              (g.random((T, C, S)) * 0.01).astype(f32), Nf,
              (g.random((T, C)) * 0.01).astype(f32), act, acc, spd)
        return consts, carry, xs
    consts = {"c": c, "fail_slot": fail,
              "tm": (g.random((C, 1)) * 0.01 + 1e-3).astype(f32),
              "tc": (g.random((C, 1)) * 1e-4 + 1e-5).astype(f32),
              "new_mean": (g.random((C, 1)) * 50.0 + 1.0).astype(f32)}
    carry = ((g.random((C, S)) * 2.0).astype(f32),
             (g.random((C, S)) * 0.02 + 1e-3).astype(f32),
             (g.random((C, S)) * 64.0).astype(f32),
             g.integers(0, 5, C).astype(f32))
    xs = (np.arange(T, dtype=np.int32), Nc,
          (g.random((T, C, S)) * 2.0).astype(f32),
          (g.random((T, C, S)) * 0.8).astype(f32), Nf,
          (g.random((T, C)) * 2.0).astype(f32),
          (g.random((T, C)) * 0.8).astype(f32), act, acc, spd)
    return consts, carry, xs


def _jax_args(consts, carry, xs, k=None):
    jc = {key: jnp.asarray(v) for key, v in consts.items()}
    jc["dt"] = DT
    jx = tuple(jnp.asarray(x if k is None else x[k]) for x in xs)
    return jc, tuple(jnp.asarray(a) for a in carry), jx


def _torch_args(consts, carry, xs, k=None):
    tc = {key: torch.from_numpy(v) for key, v in consts.items()}
    tc["dt"] = float(np.float32(DT))
    tx = tuple(torch.from_numpy(np.ascontiguousarray(
        x if k is None else x[k])) for x in xs)
    return tc, tuple(torch.from_numpy(a) for a in carry), tx


def _flat(out):
    carry, ys = out
    return [np.asarray(a) for a in list(carry) + list(ys)]


@pytest.mark.parametrize("S", [1, 3, 16])
@pytest.mark.parametrize("family", ["scalar", "batched"])
def test_step_matches_jax_ref_and_pallas_interpret(family, S):
    batched = family == "batched"
    consts, carry, xs = _inputs(S, batched, T=6)
    step = ref.batched_step if batched else ref.scalar_step
    advance = (jvs.batched_slot_advance if batched
               else jvs.scalar_slot_advance)
    # traced once for all slots; dt stays a Python constant, as eager
    pallas = jax.jit(lambda c, k, x: advance({**c, "dt": DT}, k, x,
                                             interpret=True))
    for k in range(xs[0].shape[0]):      # slots with and without failures
        jc, jk, jx = _jax_args(consts, carry, xs, k)
        want = _flat(jref.vector_slot_advance(family, jc, jk, jx))
        kern = _flat(pallas({n: v for n, v in jc.items() if n != "dt"},
                            jk, jx))
        got = _flat(step(*_torch_args(consts, carry, xs, k)))
        for g, w, p in zip(got, want, kern):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_allclose(g, p, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S", [1, 3, 16])
@pytest.mark.parametrize("family", ["scalar", "batched"])
def test_scan_matches_jax_lax_scan(family, S):
    """64 slots through the port's scan (the CPU path of ``ops``) and
    through ``lax.scan`` of the JAX step."""
    batched = family == "batched"
    consts, carry, xs = _inputs(S, batched, T=64, seed=1)
    jc, jk, jx = _jax_args(consts, carry, xs)
    want = _flat(jax.jit(lambda k, x: jax.lax.scan(
        lambda kk, xx: jref.vector_slot_advance(family, jc, kk, xx),
        k, x))(jk, jx))
    scan = ops.batched_scan if batched else ops.scalar_scan
    got = _flat(scan(*_torch_args(consts, carry, xs)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_waterfill_levels_exactly():
    """The sort-free level fill on a hand-checked case: 3 work units over
    lanes at 0, 1, 5 (one masked) fill the two open lanes to level 2."""
    U = torch.tensor([[0.0, 1.0, ref._BIG, 5.0]])
    fill = ref.waterfill(U, torch.tensor([3.0]))
    assert fill.tolist() == [[2.0, 1.0, 0.0, 0.0]]


def _quantile_case(seed: int, K: int = 300):
    g = np.random.default_rng(seed)
    counts = np.array([0, 1, 2, K, 7, 7] + list(g.integers(1, K, 10)),
                      np.int32)
    lat = np.full((counts.size, K), np.inf, np.float32)
    for i, n in enumerate(counts):
        lat[i, :n] = g.gamma(2.0, 0.01, n)
    lat[4, :7] = 0.25                            # all ties
    lat[5, :7] = [0.1, 0.1, 0.2, 0.2, 0.2, 0.3, 0.3]
    return lat, counts


def _numpy_quantiles(lat, counts):
    """The sort oracle in NumPy f32, which keeps subnormals: np.sort, the
    floor/ceil ranks of f32(q / 100) * (n - 1), numpy's lerp."""
    x = np.sort(lat, axis=1)
    nf = counts.astype(np.float32)[:, None]
    pos = np.float32([q / 100.0 for q in (50.0, 95.0, 99.0)]) * (nf - 1)
    lo, hi = np.floor(pos), np.ceil(pos)
    K = lat.shape[1]
    a = np.take_along_axis(x, np.clip(lo, 0, K - 1).astype(np.int64), 1)
    b = np.take_along_axis(x, np.clip(hi, 0, K - 1).astype(np.int64), 1)
    t = pos - lo
    with np.errstate(invalid="ignore"):
        out = np.where(t >= 0.5, b - (b - a) * (np.float32(1) - t),
                       a + (b - a) * t)
    return np.where(counts[:, None] > 0, out, np.float32(np.nan))


def _hold_quantiles_to_jax(lat, counts):
    """ops.fused_quantiles on the CPU: bit-equal to the JAX sort oracle,
    within 1 ulp of the interpret-mode Pallas kernel, and bit-equal to
    the oracle in NumPy (module doc).  XLA on the CPU flushes subnormals
    to zero, so where a result is subnormal JAX's functions are held to
    it flushed."""
    want = np.asarray(jref.fused_quantiles(jnp.asarray(lat),
                                           jnp.asarray(counts)))
    kern = np.asarray(jvq.fused_quantiles(jnp.asarray(lat),
                                          jnp.asarray(counts),
                                          interpret=True))
    got = ops.fused_quantiles(torch.from_numpy(lat),
                              torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(got, _numpy_quantiles(lat, counts))
    tiny = np.finfo(np.float32).tiny
    flushed = np.where(np.abs(got) < tiny, np.float32(0), got)
    np.testing.assert_array_equal(flushed, want)  # NaN rows compare equal
    np.testing.assert_array_equal(np.isnan(got), np.isnan(kern))
    ok = ~np.isnan(got)
    np.testing.assert_array_max_ulp(flushed[ok], kern[ok], maxulp=1)
    np.testing.assert_array_equal(np.isnan(got).all(1), counts == 0)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_quantiles_match_jax(seed):
    lat, counts = _quantile_case(seed)
    got = _hold_quantiles_to_jax(lat, counts)
    assert np.isnan(got[0]).all() and not np.isnan(got[1:]).any()
    assert (got[1] == lat[1, 0]).all()           # one sample: itself
    assert (got[4] == np.float32(0.25)).all()


@pytest.mark.parametrize("K", [1, 3, 129, 300])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_quantiles_edge_rows_match_jax(kind, K):
    """The card tests' edge rows at CPU-sized K: 13 rows of one kind
    (row 0 with a count of 0, row 1 with a count of 1)."""
    lat, counts = quantile_rows(13, K, kinds=(kind,))
    got = _hold_quantiles_to_jax(lat, counts)
    for i in np.flatnonzero(counts):             # within the row's range
        vals = lat[i, :counts[i]]
        assert (vals.min() <= got[i]).all() and (got[i] <= vals.max()).all()
    assert (got[1] == lat[1, 0]).all()           # one sample: itself
    if kind == "ties":
        assert (got[1:] == np.float32(0.25)).all()


def test_quantile_ranks_match_jax():
    n = np.array([0, 1, 2, 3, 100, 32768, 1001], np.int32)
    jp, jlo, jhi = jref.quantile_ranks(jnp.asarray(n))
    tp, tlo, thi = ref.quantile_ranks(torch.from_numpy(n))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))


def test_soft_mode_consts_raise():
    consts, carry, xs = _torch_args(*_inputs(3, False, T=2))
    consts["tau"] = 0.05
    with pytest.raises(NotImplementedError, match="not ported"):
        ops.scalar_scan(consts, carry, xs)


@pytest.mark.parametrize("wrapper", ["scalar_scan", "batched_scan",
                                     "fused_quantiles"])
def test_cuda_wrappers_refuse_cpu_tensors(wrapper):
    """A kernel wrapper launches on CUDA tensors or raises: it never
    runs the plain version itself."""
    if wrapper == "fused_quantiles":
        lat, counts = _quantile_case(0)
        args = (torch.from_numpy(lat), torch.from_numpy(counts))
        fn = vector_quantiles.fused_quantiles
    else:
        args = _torch_args(*_inputs(3, wrapper == "batched_scan", T=2))
        fn = getattr(vector_step, wrapper)
    before = fn.launches
    with pytest.raises(ValueError, match="CUDA"):
        fn(*args)
    assert fn.launches == before


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5, 8, 9, 16, 17, 31, 32, 33, 40,
                               64, 1024])
@pytest.mark.parametrize("C", [1, 5, 37, 117, 20000])
def test_scan_geometry_covers_every_cell_once(C, S):
    """The scan kernels' launch geometry: every cell sits in exactly one
    segment (S <= 32: G >= S lanes, G a power of two, 32 // G cells a
    warp) or one block (S > 32), and no block lies wholly past C."""
    G, per_warp, warps, blocks = vector_step._geometry(C, S)
    if S <= 32:
        assert S <= G <= 32 and G & (G - 1) == 0
        assert per_warp == 32 // G
        assert 1 <= warps <= vector_step.WARPS_PER_BLOCK
        b, w, seg = np.meshgrid(np.arange(blocks), np.arange(warps),
                                np.arange(per_warp), indexing="ij")
        cell = ((b * warps + w) * per_warp + seg).ravel()
        per_block = warps * per_warp
    else:
        assert per_warp == 0 and G % 32 == 0 and G - 32 < S <= G
        assert warps == G // 32
        cell = np.arange(blocks)
        per_block = 1
    np.testing.assert_array_equal(np.bincount(cell[cell < C], minlength=C),
                                  np.ones(C, dtype=np.int64))
    assert (blocks - 1) * per_block < C <= blocks * per_block


@pytest.mark.parametrize("C,S", [(5, 0), (5, vector_step.MAX_LANES + 1),
                                 (0, 4)])
def test_scan_geometry_refuses_unsupported_shapes(C, S):
    with pytest.raises(ValueError, match="unsupported scan shape"):
        vector_step._geometry(C, S)


def _slice_width(K: int, cs: int) -> int:
    """ceil(K / cs) rounded up to a 16-byte group of f32."""
    per_block = -(-K // cs)
    return -(-per_block // 4) * 4


@pytest.mark.parametrize("K", [1, 3, 4, 129, 2047, 4097, 32768, 32771,
                               100_003, 393_056, 393_057, 2 ** 19 + 3,
                               4_000_000])
@pytest.mark.parametrize("C", [1, 13, 26, 52, 117, 132, 300])
def test_quantile_launch_plan_covers_each_row(C, K):
    """The quantile kernel's launch plan: a cluster of 1, 2, 4 or 8
    blocks a row whose slices (the kernel's split of a row's m values:
    round4(ceil(m / cluster)) each) cover the values once and fit the
    block's shared memory; the row is streamed only when 8 blocks
    cannot hold it."""
    cs, width, resident = vector_quantiles.launch_plan(C, K)
    assert cs in (1, 2, 4, 8) and width % 4 == 0 and width * cs >= K
    fixed = vector_quantiles.HIST_BYTES + 4 * 4
    assert resident == (fixed + 4 * width <= vector_quantiles.SMEM_BYTES)
    if not resident:
        assert cs == vector_quantiles.MAX_CLUSTER
    for m in sorted({1, 2, K // 3 + 1, K - 1, K} - {0}):
        w = _slice_width(m, cs)
        assert w <= width
        lo = [min(b * w, m) for b in range(cs)]
        hi = [min(s + w, m) for s in lo]
        assert lo[0] == 0 and hi[-1] == m and lo[1:] == hi[:-1]
    # a cluster grows only while the doubled grid keeps one block an SM
    # and each block MIN_SLICE values, or until the slice fits
    if cs > 1:
        grown = (C * cs <= vector_quantiles.H100_SMS
                 and K // cs >= vector_quantiles.MIN_SLICE)
        half = fixed + 4 * _slice_width(K, cs // 2)
        assert grown or half > vector_quantiles.SMEM_BYTES


@pytest.mark.parametrize("C,K,cluster", [(117, 32768, 1), (52, 32768, 2),
                                         (13, 32768, 2), (26, 18099, 1),
                                         (300, 32768, 1), (1, 300_000, 8)])
def test_quantile_launch_plan_at_the_grids(C, K, cluster):
    """The grids' first launches (fig1, steady16, server-failure,
    batched8: C x K as chip_smoke's QUANTILE_CASES capture them), each
    slice held in shared memory; and a long row that needs 8 blocks."""
    assert vector_quantiles.launch_plan(C, K) == \
        (cluster, _slice_width(K, cluster), True)


@pytest.mark.parametrize("C,K", [(0, 5), (5, 0)])
def test_quantile_launch_plan_refuses_empty_shapes(C, K):
    with pytest.raises(ValueError, match="unsupported quantile shape"):
        vector_quantiles.launch_plan(C, K)
