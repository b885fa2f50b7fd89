"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit (``nvcc``) and
skips without one.  Run them on the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda_kernels.py

(``--noconftest``: the repository's conftest imports JAX, which the
card's machine need not have.)  The scans are bit-equal to the plain
versions: both run the same f32 operations, sums over server lanes left
to right, no FMA contraction.  The quantile head is bit-equal as well.

The prefill kernel keeps the probabilities in f32 (as the Pallas kernel
does) where its plain version (the reference oracle's arithmetic)
rounds them to v's dtype before P·V; each side rounds its output once.
In bf16, with ``|o| <= max|v|``: ``|kernel - plain| <= 2^-9 |o| + 2^-9
sum_j p_j |v_j| + 2^-9 |o| <= 3 * 2^-9 max|v|``; the tests hold ``2^-7
max|v|`` (``ATTN_TOL``), which leaves room for the f32 sums taken in
another order.  In f32 nothing rounds but those sums: ``F32_TOL``.  The
decode kernel rounds where the oracle does (probabilities to bf16, the
output once), so only a rounding that f32 noise pushes across a bf16
step can differ: within ``ATTN_TOL`` as well.

The SSD scan widens its inputs to f32 first, as its plain version does;
the two differ by the order of f32 sums and FMA contraction, whatever
the input dtype.  So for bf16 inputs as for f32 the kernel and the plain
version are both held against the same scan run in f64 on the same
(widened) values, within the f32 bound of ``tests/test_kernels.py``,
rtol = atol = 2e-4, widened by ``L * 2^-24 * max|y|``: the f32 rounding
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
    g = np.random.default_rng((S, int(batched)))

    def f(*shape, scale=1.0):
        return torch.from_numpy((g.random(shape) * scale)
                                .astype(np.float32)).to(device)

    act = (f(T, C, S) < 0.9).float()
    acc = act * (f(T, C, S) < 0.85).float()
    acc[:, 1] = 0.0                              # a cell nobody accepts in
    consts = {"c": (f(C, S, scale=6.0) + 1.0).floor(),
              "fail_slot": torch.from_numpy(np.where(
                  g.random((C, S)) < 0.3, g.integers(0, T, (C, S)), -1)
                  .astype(np.int32)).to(device),
              "dt": float(np.float32(0.005))}
    t = torch.arange(T, dtype=torch.int32, device=device)
    if not batched:
        carry = (f(C, S, scale=0.02), f(C, S, scale=3.0),
                 f(C, scale=4.0).floor())
        xs = (t, f(T, C, S, scale=5.0), f(T, C, S, scale=0.01),
              f(T, C, scale=4.0), f(T, C, scale=0.01), act, acc,
              f(T, C, S) + 0.5)
        return consts, carry, xs
    consts.update(tm=f(C, 1, scale=0.01) + 1e-3,
                  tc=f(C, 1, scale=1e-4) + 1e-5,
                  new_mean=f(C, 1, scale=50.0) + 1.0)
    carry = (f(C, S, scale=2.0), f(C, S, scale=0.02) + 1e-3,
             f(C, S, scale=64.0), f(C, scale=4.0).floor())
    xs = (t, f(T, C, S, scale=5.0), f(T, C, S, scale=2.0),
          f(T, C, S, scale=0.8), f(T, C, scale=4.0), f(T, C, scale=2.0),
          f(T, C, scale=0.8), act, acc, f(T, C, S) + 0.5)
    return consts, carry, xs


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 3, 16, 40])
@pytest.mark.parametrize("family", ["scalar", "batched"])
def test_scan_kernel_bit_equal_to_plain(cuda, family, S):
    batched = family == "batched"
    consts, carry, xs = _scan_inputs(cuda, S, batched)
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
def test_fused_quantiles_kernel_bit_equal_to_plain(cuda):
    g = np.random.default_rng(3)
    K = 5000
    counts = np.concatenate([[0, 1, 2, K, 7],
                             g.integers(1, K, 20)]).astype(np.int32)
    lat = np.full((counts.size, K), np.inf, np.float32)
    for i, n in enumerate(counts):
        lat[i, :n] = g.gamma(2.0, 0.01, n)
    lat[4, :7] = 0.25                            # all ties
    L = torch.from_numpy(lat).to(cuda)
    N = torch.from_numpy(counts).to(cuda)
    k = vector_quantiles.fused_quantiles(L, N).cpu().numpy()
    p = ref.fused_quantiles(L, N).cpu().numpy()
    np.testing.assert_array_equal(k, p)
    assert np.isnan(k[0]).all() and not np.isnan(k[1:]).any()


def _bf16(g, *shape, device, dtype=torch.bfloat16):
    return torch.from_numpy(g.standard_normal(shape).astype(np.float32)) \
        .to(device).to(dtype)


def _within(kern, plain, v, tol=ATTN_TOL):
    err = (kern.float() - plain.float()).abs().max().item()
    assert err <= tol * v.float().abs().max().item(), err
    return err


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,H,KV,hd,causal,window", [
    (32, 32, 4, 4, 96, True, None),        # phi3's head_dim, one tile
    (100, 100, 4, 2, 96, True, None),      # ragged q and kv tiles, GQA
    (64, 200, 8, 2, 128, True, 48),        # window with causal, S < T
    (77, 77, 4, 1, 16, False, 20),         # window alone, MQA
    (150, 40, 2, 2, 256, False, 30),       # rows past T + window: no key
    (130, 130, 2, 2, 200, True, None),     # head_dim not a power of two
])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_flash_attention_kernel_close_to_plain(cuda, S, T, H, KV, hd,
                                               causal, window, dtype):
    g = np.random.default_rng((S, T, hd))
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    q = _bf16(g, 2, S, H, hd, device=cuda, dtype=dt)
    k = _bf16(g, 2, T, KV, hd, device=cuda, dtype=dt)
    v = _bf16(g, 2, T, KV, hd, device=cuda, dtype=dt)
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
    (3, 300, 8, 2, 128, None),             # GQA, ragged last tile
    (2, 64, 16, 1, 64, 24),                # MQA (G = 16), ring + window
])
@pytest.mark.parametrize("q_dtype", ["bf16", "f32"])
def test_decode_attention_kernel_close_to_plain(cuda, B, T, H, KV, hd,
                                                window, q_dtype):
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
        window=window)
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
