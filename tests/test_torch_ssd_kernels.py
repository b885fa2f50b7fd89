"""The port's Mamba-2 SSD scan (plain versions) on the CPU against the JAX
package.

The same inputs, made from a seed with NumPy, go through the JAX
oracles (``repro.kernels.ref.ssd_naive``, ``ssd_chunked``), the
interpret-mode Pallas kernel (``repro.kernels.ssd_scan.ssd_scan``) and
the port's ``repro_torch.kernels.ref`` versions, which ``kernels.ops``
takes for CPU tensors and which the CUDA kernel is held against on the
card (tests/test_torch_cuda_kernels.py).

Tolerances are those of ``tests/test_kernels.py`` (the Pallas kernel
against its oracle): rtol = atol = 2e-4 for f32 inputs, 3e-2 for bf16
inputs.  Every version widens its inputs to f32 first, so both
frameworks see the same values; they differ by the order of f32 sums
(the decay products, the chunk's matrix products, the cumulative sum),
which the f32 tolerance covers at these sizes, and the bf16 inputs make
the Pallas-vs-oracle comparison of the reference itself noisier, which
the bf16 tolerance covers.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ssd_scan as tssd  # noqa: E402

TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=3e-2, atol=3e-2)}

#: the shapes of tests/test_kernels.py::test_ssd_scan (b, s, h, p, n, chunk),
#: then jamba-1.5-large's Mamba head (p = n = 128, the CUDA kernel's
#: widest) at a small s and h
SHAPES = [(2, 128, 4, 16, 16, 32), (1, 256, 2, 64, 128, 64),
          (2, 64, 8, 32, 64, 32), (1, 64, 2, 128, 128, 32)]


def _inputs(b, s, h, p, n, dtype: str, seed=0):
    """(jax arrays, torch tensors) of x, dt, A, B, C, as the reference's
    test draws them: x, B, C unit normal in ``dtype``; dt = softplus of a
    unit normal and A = -exp(0.5 N(0, 1)) in f32."""
    g = np.random.default_rng((seed, b, s, h, p, n))
    x = g.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(g.standard_normal((b, s, h)), 0.0).astype(np.float32)
    A = (-np.exp(g.standard_normal(h) * 0.5)).astype(np.float32)
    B = g.standard_normal((b, s, 1, n)).astype(np.float32)
    C = g.standard_normal((b, s, 1, n)).astype(np.float32)
    wide = (x, B, C)
    if dtype == "bf16":
        jx, jB, jC = (jnp.asarray(a).astype(jnp.bfloat16) for a in wide)
        tx, tB, tC = (torch.from_numpy(a).to(torch.bfloat16) for a in wide)
    else:
        jx, jB, jC = (jnp.asarray(a) for a in wide)
        tx, tB, tC = (torch.from_numpy(a) for a in wide)
    j = (jx, jnp.asarray(dt), jnp.asarray(A), jB, jC)
    t = (tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC)
    return j, t


def _close(got: torch.Tensor, want, dtype: str) -> None:
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_chunked_matches_pallas_interpret(b, s, h, p, n, chunk, dtype):
    j, t = _inputs(b, s, h, p, n, dtype)
    jy, jh = pallas_ssd(*j, chunk=chunk, interpret=True)
    y, hN = ref.ssd_chunked(*t, chunk=chunk)
    assert tuple(y.shape) == (b, s, h, p) and tuple(hN.shape) == (b, h, p, n)
    _close(y, jy, dtype)
    _close(hN, jh, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SHAPES)
def test_ssd_plain_versions_match_jax_oracles(b, s, h, p, n, chunk, dtype):
    """``ssd_naive`` against the reference's per-step oracle and
    ``ssd_chunked`` against both of its oracles."""
    j, t = _inputs(b, s, h, p, n, dtype, seed=1)
    jy, jh = jref.ssd_naive(*j)
    y, hN = ref.ssd_naive(*t)
    _close(y, jy, dtype)
    _close(hN, jh, dtype)
    cy, ch = ref.ssd_chunked(*t, chunk=chunk)
    _close(cy, jy, dtype)
    _close(ch, jh, dtype)
    jcy, jch = jref.ssd_chunked(*j, chunk=chunk)
    _close(cy, jcy, dtype)
    _close(ch, jch, dtype)


def test_ssd_state_continuation():
    """h0 chaining: scan(first half) -> scan(second half) == scan(full),
    as tests/test_kernels.py checks it for the Pallas kernel; the port's
    chained halves also match the Pallas kernel's chained halves."""
    (jx, jdt, jA, jB, jC), (x, dt, A, B, C) = _inputs(1, 128, 2, 16, 16,
                                                       "f32", seed=2)
    y_full, h_full = jref.ssd_naive(jx, jdt, jA, jB, jC)
    ya, ha = ops.ssd_scan(x[:, :64], dt[:, :64], A, B[:, :64], C[:, :64],
                          chunk=32)
    yb, hb = ops.ssd_scan(x[:, 64:], dt[:, 64:], A, B[:, 64:], C[:, 64:],
                          chunk=32, h0=ha)
    _close(torch.cat([ya, yb], dim=1), y_full, "f32")
    _close(hb, h_full, "f32")
    pa, pha = pallas_ssd(jx[:, :64], jdt[:, :64], jA, jB[:, :64],
                         jC[:, :64], chunk=32, interpret=True)
    pb, phb = pallas_ssd(jx[:, 64:], jdt[:, 64:], jA, jB[:, 64:],
                         jC[:, 64:], chunk=32, h0=pha, interpret=True)
    _close(yb, pb, "f32")
    _close(hb, phb, "f32")


@pytest.mark.parametrize("s,chunk", [(100, 32), (45, 32), (7, 32),
                                     (384, 256)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ops_ssd_scan_pads_to_the_chunk(s, chunk, dtype):
    """Any s: ``ops.ssd_scan`` pads with dt = 0 (state-neutral), cuts y
    back to s, and agrees with the reference's ``ops.ssd_scan`` and with
    the unpadded per-step oracle, the final state included."""
    j, t = _inputs(1, s, 4, 16, 32, dtype, seed=3)
    y, hN = ops.ssd_scan(*t, chunk=chunk)
    assert tuple(y.shape) == (1, s, 4, 16)
    jy, jh = jops.ssd_scan(*j, chunk=chunk, impl="ref")
    _close(y, jy, dtype)
    _close(hN, jh, dtype)
    ny, nh = jref.ssd_naive(*j)
    _close(y, ny, dtype)
    _close(hN, nh, dtype)


def test_cpu_tensors_take_the_plain_version_and_never_the_kernel():
    """On the CPU ``ops.ssd_scan`` runs ``ref.ssd_chunked`` (no launch);
    the kernel's wrapper refuses a CPU tensor rather than fall back."""
    _, (x, dt, A, B, C) = _inputs(1, 64, 2, 16, 16, "f32", seed=4)
    before = tssd.ssd_scan.launches
    y, hN = ops.ssd_scan(x, dt, A, B, C, chunk=32)
    py, ph = ref.ssd_chunked(x, dt, A, B, C, chunk=32)
    assert torch.equal(y, py) and torch.equal(hN, ph)
    assert tssd.ssd_scan.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        tssd.ssd_scan(x, dt, A, B, C, chunk=32)
    with pytest.raises(ValueError, match="chunk"):
        tssd.ssd_scan(x, dt, A, B, C, chunk=48)
    _, wide = _inputs(1, 32, 1, 129, 16, "f32", seed=4)
    with pytest.raises(ValueError, match="p <= 128"):
        tssd.ssd_scan(*wide, chunk=32)
    _, wide = _inputs(1, 32, 1, 16, 129, "f32", seed=4)
    with pytest.raises(ValueError, match="n <= 128"):
        tssd.ssd_scan(*wide, chunk=32)


def _served_head(seed: int, dtype) -> tuple:
    """One head of mamba2-1.3b's served prefill (s 512, p 64, n 128, two
    chunks of 256) in chip_smoke.py's ranges: x, B, C unit normal in
    ``dtype``, dt = softplus(N - 4.6 + 2 N), A = -exp(1.386 + 0.5 N)."""
    g = np.random.default_rng((seed, 17))

    def f(*shape):
        return torch.from_numpy(g.standard_normal(shape).astype(np.float32))
    x = f(1, 512, 1, 64).to(dtype)
    dt = torch.nn.functional.softplus(f(1, 512, 1) - 4.6 + 2.0 * f(1, 512, 1))
    A = -torch.exp(1.386 + 0.5 * f(1))
    return x, dt, A, f(1, 512, 1, 128).to(dtype), f(1, 512, 1, 128).to(dtype)


def _card_bound_used(got, plain, chunk: int) -> float:
    """The largest share of chip_smoke.py's bound on |kernel - plain|,
    2e-4 (1 + |plain|) + L 2^-24 max|plain|, that an element uses."""
    atol = 2e-4 + chunk * 2.0 ** -24 * plain.abs().max().item()
    return ((got - plain).abs() / (atol + 2e-4 * plain.abs())).max().item()


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_split_products_keep_the_card_bound(seed):
    """The numerics of the CUDA kernel, emulated in f64
    (``ref.ssd_chunked_parts``): with its f32 operands (M, w x, the
    entering state) as bf16 hi + lo parts against exact bf16 inputs, y
    and the final state stay within a tenth of chip_smoke's bound around
    the plain version; rounded to bf16 once, they miss it."""
    x, dt, A, B, C = _served_head(seed, torch.bfloat16)
    py, ph = ref.ssd_chunked(x, dt, A, B, C, chunk=256)
    y2, h2 = ref.ssd_chunked_parts(x, dt, A, B, C, chunk=256, parts=2)
    assert _card_bound_used(y2, py, 256) <= 0.1
    assert _card_bound_used(h2, ph, 256) <= 0.1
    y1, h1 = ref.ssd_chunked_parts(x, dt, A, B, C, chunk=256, parts=1)
    assert _card_bound_used(y1, py, 256) > 1.0
    assert _card_bound_used(h1, ph, 256) > 1.0


def test_ssd_split_products_of_f32_inputs_keep_the_card_bound():
    """f32 inputs: every operand in three bf16 parts (the kernel's split
    beside f32 inputs) stays within a tenth of the same bound."""
    x, dt, A, B, C = _served_head(2, torch.float32)
    py, ph = ref.ssd_chunked(x, dt, A, B, C, chunk=256)
    y3, h3 = ref.ssd_chunked_parts(x, dt, A, B, C, chunk=256, parts=3)
    assert _card_bound_used(y3, py, 256) <= 0.1
    assert _card_bound_used(h3, ph, 256) <= 0.1


def test_ssd_chunked_parts_matches_the_plain_version_at_small_shapes():
    """The emulation itself, in three parts on f32 inputs, against
    ``ssd_chunked`` with an initial state and a ragged chunk count."""
    _, (x, dt, A, B, C) = _inputs(2, 96, 3, 24, 40, "f32", seed=5)
    h0 = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 3, 24, 40)).astype(np.float32))
    py, ph = ref.ssd_chunked(x, dt, A, B, C, chunk=32, h0=h0)
    ey, eh = ref.ssd_chunked_parts(x, dt, A, B, C, chunk=32, parts=3, h0=h0)
    _close(ey, py, "f32")
    _close(eh, ph, "f32")
