"""The port's attention (plain versions) on the CPU against the JAX
package.

The same inputs, made from a seed with NumPy, go through the JAX
oracles (``repro.kernels.ref.naive_attention``, ``chunked_attention``,
``decode_attention``), the interpret-mode Pallas kernels, and the
port's ``repro_torch.kernels.ref`` versions, which ``kernels.ops``
takes for CPU tensors and which the CUDA kernels are held against on the
card (tests/test_torch_cuda_kernels.py).

Tolerances:

* against the oracles in f32, atol 2e-5 / rtol 1e-5: the same f32
  operations (logits scaled after the product, the finite -1e30 mask,
  softmax, P·V), summed in another order;
* against the oracles in bf16, 2^-8 of max|v|: the probabilities and the
  output are rounded to bf16 on both sides, and an f32 difference in the
  last place can move one rounding by one bf16 step (2^-8 relative);
* against the interpret-mode Pallas kernels in f32, atol 2e-5: they keep
  the probabilities in f32 too.  They differ from the oracle, and so
  from the port, on a row whose every key is masked: the oracle's
  softmax over -1e30 averages v, the Pallas kernels write 0.  The port
  follows the oracle (a test below pins both conventions).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import decode_attention as jda  # noqa: E402
from repro.kernels import flash_attention as jfa  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as tda  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_REL = 2.0 ** -8


def _np(g, *shape):
    return g.standard_normal(shape).astype(np.float32)


def _pair(a: np.ndarray, dtype: str):
    """The same array for JAX and for the port, in ``dtype``."""
    if dtype == "f32":
        return jnp.asarray(a), torch.from_numpy(a)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(a).to(torch.bfloat16)


def _close(port: torch.Tensor, jax_out, dtype: str, v: np.ndarray):
    got = port.float().numpy()
    want = np.asarray(jax_out.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, **F32_TOL)
    else:
        assert np.abs(got - want).max() <= BF16_REL * np.abs(v).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S,T,H,KV,hd,causal,window", [
    (24, 24, 4, 4, 16, True, None),        # smoke width, MHA
    (24, 24, 4, 2, 96, True, None),        # phi3's head_dim, GQA
    (20, 36, 4, 1, 16, True, 8),           # window + causal, MQA, S < T
    (40, 16, 2, 2, 16, False, 6),          # rows past T + window: no key
])
def test_flash_plain_matches_naive_oracle(dtype, S, T, H, KV, hd, causal,
                                          window):
    g = np.random.default_rng((S, T, H, hd))
    q, k, v = _np(g, 2, S, H, hd), _np(g, 2, T, KV, hd), _np(g, 2, T, KV, hd)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jref.naive_attention(jq, jk, jv, causal=causal, window=window)
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tv.dtype and got.shape == tq.shape
    _close(got, want, dtype, v)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_plain_chunks_like_chunked_oracle(dtype):
    """Query chunks at offsets: the reference's chunked path (S > chunk)."""
    g = np.random.default_rng(7)
    S, H, KV, hd, chunk = 96, 4, 2, 16, 32
    q, k, v = _np(g, 1, S, H, hd), _np(g, 1, S, KV, hd), _np(g, 1, S, KV, hd)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jref.chunked_attention(jq, jk, jv, causal=True, window=40,
                                  chunk=chunk)
    got = ref.flash_attention(tq, tk, tv, causal=True, window=40,
                              chunk=chunk)
    _close(got, want, dtype, v)
    # a last chunk shorter than the others: the reference asserts instead
    short = ref.flash_attention(tq[:, :80], tk, tv, causal=True, window=40,
                                chunk=chunk)
    torch.testing.assert_close(short, got[:, :80], rtol=0, atol=0)


def _decode_case(g, B, T, H, KV, hd, ring: bool):
    q, k, v = _np(g, B, H, hd), _np(g, B, T, KV, hd), _np(g, B, T, KV, hd)
    lengths = g.integers(1, T + 1, B).astype(np.int32)
    lengths[0] = 0                             # no valid key at all
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    if ring:                                   # slot j holds j or j + T
        pos = pos + T * (np.arange(T) < T // 3).astype(np.int32)
        lengths = lengths + T
    pos[:, -2:] = -1                           # empty slots
    q_pos = np.maximum(lengths - 1, 0).astype(np.int32)
    return q, k, v, lengths, pos, q_pos


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,KV,hd,window,ring", [
    (3, 40, 4, 4, 16, None, False),        # ragged lengths, -1 slots
    (3, 40, 4, 2, 96, None, False),        # phi3's head_dim, GQA
    (2, 24, 4, 1, 16, 10, True),           # ring positions + window, MQA
])
def test_decode_plain_matches_oracle(dtype, B, T, H, KV, hd, window, ring):
    g = np.random.default_rng((B, T, hd, int(ring)))
    q, k, v, lengths, pos, q_pos = _decode_case(g, B, T, H, KV, hd, ring)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jref.decode_attention(jq, jk, jv, lengths=jnp.asarray(lengths),
                                 key_positions=jnp.asarray(pos),
                                 q_pos=jnp.asarray(q_pos), window=window)
    got = ops.decode_attention(tq, tk, tv,
                               lengths=torch.from_numpy(lengths),
                               key_positions=torch.from_numpy(pos),
                               q_pos=torch.from_numpy(q_pos), window=window)
    assert got.dtype == tv.dtype and got.shape == tq.shape
    _close(got, want, dtype, v)


def test_decode_plain_defaults_match_oracle():
    """Without key positions and q_pos: keys at 0..T-1, q_pos = len - 1."""
    g = np.random.default_rng(5)
    q, k, v = _np(g, 2, 4, 16), _np(g, 2, 12, 2, 16), _np(g, 2, 12, 2, 16)
    lengths = np.array([5, 12], np.int32)
    want = jref.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), lengths=jnp.asarray(lengths),
                                 window=3)
    got = ref.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               lengths=torch.from_numpy(lengths), window=3)
    _close(got, want, "f32", v)


def test_plain_versions_match_interpret_pallas_kernels():
    """One small shape through the Pallas kernels in interpret mode (f32,
    probabilities in f32 on both sides), rows with a key each."""
    g = np.random.default_rng(11)
    S, H, KV, hd = 64, 4, 2, 16
    q, k, v = _np(g, 1, S, H, hd), _np(g, 1, S, KV, hd), _np(g, 1, S, KV, hd)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=20,
                               block_q=32, block_k=32, interpret=True)
    got = ref.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)

    B, T = 3, 64
    qd, kd, vd = _np(g, B, H, hd), _np(g, B, T, KV, hd), _np(g, B, T, KV, hd)
    lengths = np.array([9, 40, 64], np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos[:, 50:] = -1
    want = jda.decode_attention(jnp.asarray(qd), jnp.asarray(kd),
                                jnp.asarray(vd), lengths=jnp.asarray(lengths),
                                key_positions=jnp.asarray(pos), window=16,
                                block_t=32, interpret=True)
    got = ref.decode_attention(torch.from_numpy(qd), torch.from_numpy(kd),
                               torch.from_numpy(vd),
                               lengths=torch.from_numpy(lengths),
                               key_positions=torch.from_numpy(pos),
                               window=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_all_masked_row_convention():
    """A row with no valid key: the port (and the oracle) average v over
    every key; the interpret-mode Pallas kernel writes 0."""
    g = np.random.default_rng(13)
    q, k, v = _np(g, 1, 2, 16), _np(g, 1, 32, 1, 16), _np(g, 1, 32, 1, 16)
    lengths = np.zeros(1, np.int32)
    port = ref.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v),
                                lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(port.numpy()[0],
                               np.broadcast_to(v[0, :, 0].mean(0), (2, 16)),
                               rtol=1e-5, atol=1e-6)
    pallas = jda.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v),
                                  lengths=jnp.asarray(lengths),
                                  interpret=True)
    assert not np.asarray(pallas).any()


def test_wrappers_refuse_cpu_tensors_and_bad_shapes():
    """The CUDA wrappers never fall back: a CPU tensor is an error."""
    q = torch.zeros(1, 4, 2, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported"):
        tfa.flash_attention(torch.zeros(1, 4, 2, 300), q, q)
    with pytest.raises(ValueError, match="window"):
        tfa.check_window(0)
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention(q[:, 0], q, q, lengths=torch.ones(1))
    with pytest.raises(ValueError, match="unsupported"):
        tda.decode_attention(torch.zeros(1, 34, 16), q, q,
                             lengths=torch.ones(1))
    assert tfa.flash_attention.launches == 0
    assert tda.decode_attention.launches == 0
