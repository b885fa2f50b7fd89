"""The CUDA kernels of the port against their plain PyTorch versions, on
the card.

Every test here needs an NVIDIA GPU with the CUDA toolkit (``nvcc``) and
skips without one.  Run them on the machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_cuda_kernels.py

(``--noconftest``: the repository's conftest imports JAX, which the
card's machine need not have.)  The scans are bit-equal to the plain
versions: both run the same f32 operations, sums over server lanes left
to right, no FMA contraction.  The quantile head is bit-equal as well.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, vector_quantiles, vector_step


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
