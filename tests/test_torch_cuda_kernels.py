"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit (``nvcc``) and
skips without one.  Run them on the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda_kernels.py

(``--noconftest``: the repository's conftest imports JAX, which the
card's machine need not have.)  The scans are bit-equal to the plain
versions: both run the same f32 operations, sums over server lanes left
to right, no FMA contraction.  The quantile head is bit-equal as well.

In bf16 the prefill kernel rounds the unnormalised probabilities to
bf16 before P·V (its tensor-core body) and divides by their f32 sum at
the end; its plain version (the reference oracle's arithmetic) rounds
the normalised ones.  Each side's weights lie within one bf16 rounding
of the exact ones and each side rounds its output once, so the two
differ by a few bf16 roundings of values no larger than ``max|v|``;
errors of single weights mostly cancel across keys, and what is left
is one output rounding that tips the other way: one bf16 step of
``|o| <= max|v|``, no more than ``2^-7 max|v|``.  The tests hold
``2^-7 max|v|`` (``ATTN_TOL``).  f32 runs the CUDA-core body, where
nothing rounds but f32 sums taken in another order: ``F32_TOL``.  The
decode kernel rounds where the oracle does (probabilities to bf16, the
output once), so only a rounding that f32 noise pushes across a bf16
step can differ: within ``ATTN_TOL`` as well.

The SSD scan widens its inputs to f32 first, as its plain version does;
the two differ by the order of f32 sums and FMA contraction, whatever
the input dtype, and by the kernel's tensor-core products, which take
every f32 operand as bf16 parts (hi and lo; three parts beside f32
inputs): about 2^-16 relative per operand, a few percent of the bound
below at mamba2's widths (scripts/ssd_numerics.py emulates it).  So for
bf16 inputs as for f32 the kernel and the plain version are both held
against the same scan run in f64 on the same (widened) values, within
the f32 bound of ``tests/test_kernels.py``, rtol = atol = 2e-4, widened
by ``L * 2^-24 * max|y|``: the f32 rounding
of the chunk's cumulative sum of L decays, which every
``exp(cum_t - cum_s)`` inherits.  The reference's own test (chunks <= 64,
|y| <= ~50) never reaches that term; at mamba2's chunk of 256 with
unit-normal inputs (|y| up to ~230) the plain f32 version lies up to
1.4e-3 from the f64 scan on the CPU, the kernel 5e-4 from the plain
version on the card, both past 2e-4 + 2e-4|y| alone.  A state kept in
bf16 misses this bound by an order of magnitude (chip_smoke.py's
control).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import (decode_attention, flash_attention, ops,
                                 ref, ssd_scan, vector_quantiles,
                                 vector_step)

from _quantile_rows import KINDS, quantile_rows  # noqa: E402

#: kernel vs plain attention, relative to max|v| (see the module doc)
ATTN_TOL = 2.0 ** -7
F32_TOL = 2e-5
#: SSD kernel and plain version vs the f64 scan (the reference's f32
#: Pallas-vs-oracle bound, widened as the module doc says)
SSD_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels are built with nvcc for "
                    "sm_90a and launch only there)")
    return torch.device("cuda")


def _scan_inputs(device, S: int, batched: bool, T: int = 48, C: int = 5):
    g = np.random.default_rng((S, int(batched), T, C))

    def f(*shape, scale=1.0):
        return torch.from_numpy((g.random(shape) * scale)
                                .astype(np.float32)).to(device)

    act = (f(T, C, S) < 0.9).float()
    acc = act * (f(T, C, S) < 0.85).float()
    # a cell nobody accepts in: every lane at _BIG in the water-fill, and
    # at 16 lanes the phantom fill of the reference (ROADMAP Queue C)
    acc[:, 1] = 0.0
    fail = np.where(g.random((C, S)) < 0.3, g.integers(0, T, (C, S)), -1)
    fail[0, 0], fail[2, S - 1] = 0, T - 1       # the first and last slot
    consts = {"c": (f(C, S, scale=6.0) + 1.0).floor(),
              "fail_slot": torch.from_numpy(fail.astype(np.int32))
              .to(device),
              "dt": float(np.float32(0.005))}
    t = torch.arange(T, dtype=torch.int32, device=device)
    if not batched:
        carry = (f(C, S, scale=0.02), f(C, S, scale=3.0),
                 f(C, scale=4.0).floor())
        xs = (t, f(T, C, S, scale=5.0), f(T, C, S, scale=0.01),
              f(T, C, scale=4.0), f(T, C, scale=0.01), act, acc,
              f(T, C, S) + 0.5)
        work = (carry[0], xs[2])
    else:
        consts.update(tm=f(C, 1, scale=0.01) + 1e-3,
                      tc=f(C, 1, scale=1e-4) + 1e-5,
                      new_mean=f(C, 1, scale=50.0) + 1.0)
        carry = (f(C, S, scale=2.0), f(C, S, scale=0.02) + 1e-3,
                 f(C, S, scale=64.0), f(C, scale=4.0).floor())
        xs = (t, f(T, C, S, scale=5.0), f(T, C, S, scale=2.0),
              f(T, C, S, scale=0.8), f(T, C, scale=4.0), f(T, C, scale=2.0),
              f(T, C, scale=0.8), act, acc, f(T, C, S) + 0.5)
        work = (carry[0], carry[1], xs[2], xs[3])
    # a cell of tiny work: its divides leave the kernel's fast window
    # (dividends under 2^-60), so its slots run again with the exact divide
    for w in work:
        w[..., 3, :] *= 1e-30
    return consts, carry, xs


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 48, 61])
@pytest.mark.parametrize("C", [5, 37, 1100])
@pytest.mark.parametrize("S", [1, 3, 4, 8, 16, 31, 32, 33, 40])
@pytest.mark.parametrize("family", ["scalar", "batched"])
def test_scan_kernel_bit_equal_to_plain(cuda, family, S, C, T):
    """Segments of 1 to 32 lanes packed into warps (S = 31: a ragged
    segment; C = 37: a warp not full; C = 1100: blocks of 2 and 4 warps,
    whose ring of inputs passes 48 KB of shared memory), one block a cell
    past 32 lanes; T = 1 (the per-slot form) and T not a multiple of the
    ring's depth; fail slots at the first and last slot."""
    batched = family == "batched"
    consts, carry, xs = _scan_inputs(cuda, S, batched, T=T, C=C)
    kern = vector_step.batched_scan if batched else vector_step.scalar_scan
    plain = ref.batched_scan if batched else ref.scalar_scan
    before = kern.launches
    kc, ky = kern(consts, carry, xs)
    pc, py = plain(consts, carry, xs)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    for k, p in zip(list(kc) + list(ky), list(pc) + list(py)):
        assert torch.equal(k, p)


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw", [
    ("flash-crowd-autoscale", {}),
    ("flash-crowd-autoscale", dict(controller="admission_shedder",
                                   peak_qps=4000.0)),
    ("correlated-failure", {})])
def test_scan_kernel_bit_equal_on_chaos_grid(cuda, name, kw):
    """A chaos grid's scan launch as ``run_cells`` builds it, at full
    duration: standby columns (``active = 0``) until the control
    pre-pass's ``set_scale`` opens one, admission-thinned arrivals, two
    servers failing in one slot and their replacements joining."""
    from repro_torch import scenarios
    from repro_torch.vector import compile_experiment
    from repro_torch.vector import runtime as R
    progs, seeds = [], []
    for rep in range(3):
        sc = scenarios.get(name, seed=10 + rep, **kw)
        progs.append(compile_experiment(sc.compile()))
        seeds.append((sc.seed, rep))
    (batched, shape, idxs), = R._plan_groups(progs)
    draws = [R._draw_cell(progs[i], R._cell_rng(*seeds[i])) for i in idxs]
    consts, carry, xs = R.scan_inputs([progs[i] for i in idxs], draws,
                                      batched, shape, cuda)
    active = xs[-3]
    assert not batched and (active == 0).any() and (active == 1).any()
    kc, ky = vector_step.scalar_scan(consts, carry, xs)
    pc, py = ref.scalar_scan(consts, carry, xs)
    torch.cuda.synchronize()
    for k, p in zip(list(kc) + list(ky), list(pc) + list(py)):
        assert torch.equal(k, p)


@pytest.mark.gpu
def test_scan_fast_divide_is_the_ieee_divide(cuda):
    """The scans' branch-free divide (``FastDiv``) is the IEEE quotient
    wherever it does not flag its operands, and it flags exactly the pairs
    outside its window (|a| in [2^-60, 2^80] or a zero over a positive b;
    b in [2^-44, 2^64]): 2^22 random pairs across the window and past its
    edges, with mantissas of all ones, powers of two, signed zeros,
    negative divisors, subnormals, infinities and NaN."""
    g = np.random.default_rng(7)
    n = 1 << 22

    def rand(lo, hi):
        e = g.integers(lo, hi + 1, n).astype(np.float64)
        x = (g.random(n) + 1.0) * np.exp2(e)
        return np.where(g.random(n) < 0.5, -x, x).astype(np.float32)

    a, b = rand(-70, 90), np.abs(rand(-50, 70))
    k = n // 16
    a[:k] = (a[:k].view(np.uint32) | 0x7FFFFF).view(np.float32)
    b[k:2 * k] = (b[k:2 * k].view(np.uint32) | 0x7FFFFF).view(np.float32)
    a[2 * k:3 * k] = np.exp2(g.integers(-60, 80, k)).astype(np.float32)
    b[3 * k:4 * k] = np.exp2(g.integers(-44, 64, k)).astype(np.float32)
    a[4 * k:4 * k + 1000] = 0.0
    a[4 * k + 1000:4 * k + 2000] = -0.0
    b[4 * k + 1500:4 * k + 2500] *= -1.0
    special = np.array([np.inf, -np.inf, np.nan, 1e-45, -3e-39, 0.0],
                       dtype=np.float32)
    a[5 * k:5 * k + 6] = special
    b[5 * k + 6:5 * k + 12] = special
    q, bad = vector_step._fast_div(torch.from_numpy(a).to(cuda),
                                   torch.from_numpy(b).to(cuda))
    q, bad = q.cpu().numpy(), bad.cpu().numpy()
    with np.errstate(all="ignore"):
        want = a / b
    aa = np.abs(a)
    inside = ((((aa >= 2.0 ** -60) & (aa <= 2.0 ** 80))
               & (b >= 2.0 ** -44) & (b <= 2.0 ** 64))
              | ((a == 0) & (b > 0)))
    np.testing.assert_array_equal(bad == 0, inside)
    assert inside.mean() > 0.5
    np.testing.assert_array_equal(q[inside].view(np.uint32),
                                  want[inside].view(np.uint32))


def _quantiles_bit_equal(L, N) -> np.ndarray:
    """The quantile kernel on (L, N) against its plain version on the
    same tensors: bit-equal, NaN rows exactly where the count is 0."""
    k = vector_quantiles.fused_quantiles(L, N).cpu().numpy()
    p = ref.fused_quantiles(L, N).cpu().numpy()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(k.view(np.uint32)[~np.isnan(p)],
                                  p.view(np.uint32)[~np.isnan(p)])
    np.testing.assert_array_equal(np.isnan(k).all(1),
                                  N.cpu().numpy() <= 0)
    np.testing.assert_array_equal(np.isnan(k), np.isnan(p))
    return k


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 13, 117, 300])
@pytest.mark.parametrize("K", [1, 3, 129, 4097, 32768, 32771, 100_003,
                               300_000, 2 ** 19 + 3])
def test_fused_quantiles_kernel_bit_equal_to_plain(cuda, K, C):
    """Every cluster size (launch_plan: 1, 2, 4 and 8 blocks a row, held
    in shared memory), rows whose 16-byte groups start anywhere
    (K % 4 != 0), and the streamed path (K = 2^19 + 3, 8 blocks a row);
    rows of every kind of _quantile_rows."""
    lat, counts = quantile_rows(C, K, seed=3)
    _quantiles_bit_equal(torch.from_numpy(lat).to(cuda),
                         torch.from_numpy(counts).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("K", [4097, 32771, 2 ** 19 + 3])
@pytest.mark.parametrize("kind", KINDS)
def test_fused_quantiles_kernel_edge_rows(cuda, kind, K, offset):
    """13 rows of one kind (counts of 0 and 1 among them) in a matrix
    that starts ``offset`` floats past a 16-byte boundary."""
    lat, counts = quantile_rows(13, K, seed=5, kinds=(kind,))
    buf = torch.empty(lat.size + offset, dtype=torch.float32, device=cuda)
    L = buf[offset:].view(lat.shape)
    L.copy_(torch.from_numpy(lat))
    k = _quantiles_bit_equal(L, torch.from_numpy(counts).to(cuda))
    assert (k[1] == lat[1, 0]).all()             # one sample: itself


@pytest.mark.gpu
def test_fused_quantiles_kernel_counts_past_k(cuda):
    """A count above K clamps the ranks into the row, as the sort's
    gather does; a negative count is an empty row."""
    g = np.random.default_rng(9)
    lat = g.gamma(2.0, 0.004, (4, 1000)).astype(np.float32)
    N = torch.tensor([1000, 1001, 5000, -3], dtype=torch.int32, device=cuda)
    _quantiles_bit_equal(torch.from_numpy(lat).to(cuda), N)


def _bf16(g, *shape, device, dtype=torch.bfloat16):
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)) \
        .to(device).to(dtype)


def _within(kern, plain, v, tol=ATTN_TOL):
    err = (kern.float() - plain.float()).abs().max().item()
    assert err <= tol * v.float().abs().max().item(), err
    return err


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,T,H,KV,hd,causal,window", [
    (2, 32, 32, 4, 4, 96, True, None),     # phi3's head_dim, one tile
    (2, 100, 100, 4, 2, 96, True, None),   # ragged q and kv tiles, GQA
    (2, 64, 200, 8, 2, 128, True, 48),     # window with causal, S < T
    (2, 77, 77, 4, 1, 16, False, 20),      # window alone, MQA
    (2, 150, 40, 2, 2, 256, False, 30),    # rows past T + window: no key
    (2, 130, 130, 2, 2, 200, True, None),  # head_dim not a power of two
    (2, 90, 90, 4, 2, 100, True, None),    # hd % 8 != 0: element loads,
                                           # padded to 112
    (2, 1, 1, 2, 2, 96, True, None),       # one query, one key
    (2, 2048, 2048, 2, 2, 96, True, None),  # the K/V ring wraps 16 times
    (3, 70, 200, 8, 2, 128, True, None),   # B = 3, GQA, S < T
])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_flash_attention_kernel_close_to_plain(cuda, B, S, T, H, KV, hd,
                                               causal, window, dtype):
    g = np.random.default_rng((S, T, hd))
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    q = _bf16(g, B, S, H, hd, device=cuda, dtype=dt)
    k = _bf16(g, B, T, KV, hd, device=cuda, dtype=dt)
    v = _bf16(g, B, T, KV, hd, device=cuda, dtype=dt)
    before = flash_attention.flash_attention.launches
    out = flash_attention.flash_attention(q, k, v, causal=causal,
                                          window=window)
    plain = ref.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    assert torch.isfinite(out.float()).all()
    _within(out, plain, v, F32_TOL if dtype == "f32" else ATTN_TOL)
    if window is not None and S > T + window - 1:
        # a row with no key averages v over every key, as the oracle does
        mean = v.float().mean(1).repeat_interleave(H // KV, dim=1)
        torch.testing.assert_close(out[:, T + window - 1:].float(),
                                   mean[:, None].expand_as(
                                       out[:, T + window - 1:]).float(),
                                   rtol=0, atol=ATTN_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,KV,hd,window", [
    (4, 192, 4, 4, 96, None),              # the serving shape, narrowed
    (3, 300, 8, 2, 128, None),             # GQA
    (2, 64, 16, 1, 64, 24),                # MQA (G = 16), ring + window
    (2, 90, 4, 2, 100, None),              # hd % 8 != 0: element loads
    (4, 1024, 16, 8, 256, 1024),           # gemma3-12b, ring + window
])
@pytest.mark.parametrize("block_t", [None, "T", 40, 16])
@pytest.mark.parametrize("q_dtype", ["bf16", "f32"])
def test_decode_attention_kernel_close_to_plain(cuda, B, T, H, KV, hd,
                                                window, block_t, q_dtype):
    """Splits: the default, one split of the whole cache, a ragged last
    split, splits shorter than 32 slots."""
    g = np.random.default_rng((B, T, hd))
    q = _bf16(g, B, H, hd, device=cuda, dtype=torch.float32
              if q_dtype == "f32" else torch.bfloat16)
    k = _bf16(g, B, T, KV, hd, device=cuda)
    v = _bf16(g, B, T, KV, hd, device=cuda)
    lengths = torch.from_numpy(g.integers(1, T + 1, B).astype(np.int32))
    lengths[0] = 0                          # no valid key: mean of v
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    if window is not None:                  # ring: slot j holds j + T*r
        pos = pos + T * (np.arange(T) < 5)[None, :].astype(np.int32)
    pos[:, -3:] = -1                        # empty slots
    kp = torch.from_numpy(pos).to(cuda)
    lengths = lengths.to(cuda)
    if window is not None:
        lengths = lengths + T
    qpos = torch.clamp(lengths - 1, min=0)
    before = decode_attention.decode_attention.launches
    out = decode_attention.decode_attention(
        q, k, v, lengths=lengths, key_positions=kp, q_pos=qpos,
        window=window, block_t=T if block_t == "T" else block_t)
    plain = ref.decode_attention(q, k, v, lengths=lengths, key_positions=kp,
                                 q_pos=qpos, window=window)
    torch.cuda.synchronize()
    assert decode_attention.decode_attention.launches == before + 1
    assert out.dtype == plain.dtype == torch.bfloat16
    assert torch.isfinite(out.float()).all()
    _within(out, plain, v)
    if window is None:
        mean = v[0].float().mean(0).repeat_interleave(H // KV, dim=0)
        torch.testing.assert_close(out[0].float(), mean, rtol=0,
                                   atol=ATTN_TOL)


@pytest.mark.gpu
def test_decode_attention_kernel_unaligned_cache(cuda):
    """A cache whose rows are not 16-byte aligned takes the element-load
    instantiation; the same result as the plain version."""
    g = np.random.default_rng(3)
    B, T, H, KV, hd = 2, 96, 8, 2, 64
    q = _bf16(g, B, H, hd, device=cuda)
    n = B * T * KV * hd
    k = _bf16(g, n + 1, device=cuda)[1:].view(B, T, KV, hd)
    v = _bf16(g, n + 1, device=cuda)[1:].view(B, T, KV, hd)
    assert k.data_ptr() % 16 and v.data_ptr() % 16
    lengths = torch.tensor([T, 50], dtype=torch.int32, device=cuda)
    out = decode_attention.decode_attention(q, k, v, lengths=lengths)
    plain = ref.decode_attention(q, k, v, lengths=lengths)
    torch.cuda.synchronize()
    _within(out, plain, v)


def _ssd_inputs(g, device, b, s, h, p, n, dtype, h0):
    def f(*shape):
        return torch.from_numpy(g.standard_normal(shape).astype(np.float32)
                                ).to(device)
    dt_ = torch.float32 if dtype == "f32" else torch.bfloat16
    x = f(b, s, h, p).to(dt_)
    dt = torch.nn.functional.softplus(f(b, s, h))
    A = -torch.exp(f(h) * 0.5)
    B, C = f(b, s, 1, n).to(dt_), f(b, s, 1, n).to(dt_)
    return x, dt, A, B, C, (f(b, h, p, n) if h0 else None)


def _ssd_f32_close(got, truth, chunk: int) -> None:
    """An f32 scan against the f64 scan (module doc)."""
    atol = SSD_TOL["atol"] + chunk * 2.0 ** -24 * truth.abs().max().item()
    torch.testing.assert_close(got.double(), truth, rtol=SSD_TOL["rtol"],
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,p,n,chunk,h0", [
    (2, 128, 4, 16, 16, 32, False),        # the reference test's shapes
    (1, 256, 2, 64, 128, 64, False),
    (2, 64, 8, 32, 64, 32, True),
    (1, 512, 64, 64, 128, 256, False),     # mamba2-1.3b's prefill
    (2, 256, 3, 64, 128, 128, True),       # the served widths, h0
    (1, 96, 2, 24, 40, 96, True),          # ragged tiles: P, N, L
    (1, 512, 8, 128, 128, 256, False),     # jamba-1.5-large's Mamba head
    (1, 512, 8, 128, 128, 256, True),
    (1, 160, 3, 96, 72, 80, False),        # ragged, past the old P <= 64
    (1, 160, 3, 96, 72, 80, True),
    (4, 512, 64, 64, 128, 256, False),     # batch 4 at the served widths
    (4, 512, 64, 64, 128, 256, True),
    (1, 96, 2, 20, 30, 48, True),          # P, N not multiples of 8
])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_ssd_scan_kernel_close_to_plain(cuda, b, s, h, p, n, chunk, h0,
                                        dtype):
    g = np.random.default_rng((b, s, p, n))
    x, dt, A, B, C, hh = _ssd_inputs(g, cuda, b, s, h, p, n, dtype, h0)
    before = ssd_scan.ssd_scan.launches
    y, hN = ssd_scan.ssd_scan(x, dt, A, B, C, chunk=chunk, h0=hh)
    py, ph = ref.ssd_chunked(x, dt, A, B, C, chunk=chunk, h0=hh)
    torch.cuda.synchronize()
    assert ssd_scan.ssd_scan.launches == before + 1
    assert y.dtype == hN.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(hN).all()
    ty, th = ref.ssd_chunked(*(a.double() for a in (x, dt, A, B, C)),
                             chunk=chunk,
                             h0=None if hh is None else hh.double())
    for got in (y, py):
        _ssd_f32_close(got, ty, chunk)
    for got in (hN, ph):
        _ssd_f32_close(got, th, chunk)


@pytest.mark.gpu
@pytest.mark.parametrize("p,n", [(129, 128), (128, 129)])
def test_ssd_scan_refuses_past_its_limits(cuda, p, n):
    """P and N up to 128: past that the wrapper raises, with no launch."""
    g = np.random.default_rng(p + n)
    x, dt, A, B, C, _ = _ssd_inputs(g, cuda, 1, 64, 2, p, n, "bf16", False)
    before = ssd_scan.ssd_scan.launches
    with pytest.raises(ValueError, match="p <= 128, n <= 128"):
        ssd_scan.ssd_scan(x, dt, A, B, C, chunk=64)
    assert ssd_scan.ssd_scan.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("s", [384, 45])
def test_ssd_scan_ops_pads_on_the_card(cuda, s):
    """``ops.ssd_scan`` pads a ragged sequence with dt = 0 and launches the
    kernel; chained halves equal the whole sequence."""
    g = np.random.default_rng(s)
    x, dt, A, B, C, _ = _ssd_inputs(g, cuda, 1, s, 8, 64, 128, "bf16", False)
    before = ssd_scan.ssd_scan.launches
    y, hN = ops.ssd_scan(x, dt, A, B, C, chunk=256)
    assert ssd_scan.ssd_scan.launches == before + 1
    ny, nh = ref.ssd_naive(*(a.double() for a in (x, dt, A, B, C)))
    _ssd_f32_close(y, ny, 256)
    _ssd_f32_close(hN, nh, 256)
    k = s // 2
    ya, ha = ops.ssd_scan(x[:, :k], dt[:, :k], A, B[:, :k], C[:, :k],
                          chunk=32)
    yb, hb = ops.ssd_scan(x[:, k:], dt[:, k:], A, B[:, k:], C[:, k:],
                          chunk=32, h0=ha)
    _ssd_f32_close(torch.cat([ya, yb], 1), ny, 32)
    _ssd_f32_close(hb, nh, 32)


@pytest.mark.gpu
def test_fig1_sweep_rows_equal_run_cells_on_the_card(cuda):
    """The fig1 grid of ``benchmarks/torch_port/bench_vector.py`` through
    ``repro_torch.sweep.run_sweep`` on the card: one ``scalar_scan`` and
    one ``fused_quantiles`` launch, and every row equal, bit for bit, to
    ``run_cells`` on the programs and seeds of the same declaration."""
    import os
    import sys
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                        os.pardir))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from benchmarks.torch_port.bench_vector import build_grid, grid_programs

    from repro_torch.sweep import run_sweep
    from repro_torch.vector import VectorConfig, run_cells
    sweep = build_grid(smoke=False, runtime="vector")
    scans = vector_step.scalar_scan.launches
    heads = vector_quantiles.fused_quantiles.launches
    frame = run_sweep(sweep, progress=None).raise_errors()
    assert vector_step.scalar_scan.launches == scans + 1
    assert vector_quantiles.fused_quantiles.launches == heads + 1
    cells = run_cells(*grid_programs(sweep), VectorConfig(device="cuda"))
    assert len(frame.rows) == len(cells) == 117
    for row, res in zip(frame.rows, cells):
        assert row.metrics == {m: getattr(res, m)
                               for m in ("n", "mean", "p50", "p95", "p99")}
