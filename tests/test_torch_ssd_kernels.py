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

#: the shapes of tests/test_kernels.py::test_ssd_scan (b, s, h, p, n, chunk)
SHAPES = [(2, 128, 4, 16, 16, 32), (1, 256, 2, 64, 128, 64),
          (2, 64, 8, 32, 64, 32)]


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
    _, wide = _inputs(1, 32, 1, 128, 16, "f32", seed=4)
    with pytest.raises(ValueError, match="p <= 64"):
        tssd.ssd_scan(*wide, chunk=32)
