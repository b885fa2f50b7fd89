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
#: streaming multiprocessors of an H100 SXM, the card the splits are sized for
H100_SMS = 132


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
    # whisper's encoder (S = T, bidirectional) and cross attention (a
    # decoder sequence over the encoder's T), H = KV at hd 64, T reduced
    # from 1500
    (150, 150, 12, 12, 64, False, None),
    (16, 150, 12, 12, 64, False, None),
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


def _unchecked_flash(q, k, v, *, causal, window, chunk=512):
    """The plain ``flash_attention`` as it was before each query chunk ran
    under a checkpoint: autograd keeps every chunk's logits."""
    return torch.cat([ref.naive_attention(q[:, i:i + chunk], k, v,
                                          causal=causal, window=window,
                                          q_offset=i)
                      for i in range(0, q.shape[1], chunk)], dim=1)


def _saved_bytes(fn):
    """(output of ``fn()``, bytes of the distinct storages autograd
    saves for its backward)."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, sum(seen.values())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 700])
def test_flash_plain_checkpoints_its_query_chunks(dtype, window):
    """S = 1536, three 512-row chunks: the backward keeps at most one
    chunk's f32 logits beside the inputs (the unchecked version keeps
    all three chunks' logits and probabilities), and the outputs and
    q, k, v gradients are the unchecked version's bit for bit."""
    g = np.random.default_rng(11)
    S, H, KV, hd = 1536, 4, 2, 16
    arrays = (_np(g, 1, S, H, hd), _np(g, 1, S, KV, hd),
              _np(g, 1, S, KV, hd))
    up = _pair(_np(g, 1, S, H, hd), dtype)[1]
    dt = torch.float32 if dtype == "f32" else torch.bfloat16
    runs = {}
    for name, fn in (("checked", ref.flash_attention),
                     ("unchecked", _unchecked_flash)):
        xs = [torch.from_numpy(a).to(dt).requires_grad_(True)
              for a in arrays]
        out, saved = _saved_bytes(
            lambda: fn(*xs, causal=True, window=window))
        runs[name] = (out, saved, torch.autograd.grad(out, xs, up))
    inputs = sum(a.size for a in arrays) * (4 if dtype == "f32" else 2)
    chunk_logits = 512 * S * H * 4
    assert runs["checked"][1] <= chunk_logits + inputs
    assert runs["unchecked"][1] > 3 * chunk_logits
    assert torch.equal(runs["checked"][0], runs["unchecked"][0])
    for a, b in zip(runs["checked"][2], runs["unchecked"][2]):
        assert torch.equal(a, b)


def test_flash_plain_gradient_matches_chunked_oracle():
    """The checkpointed chunks' q, k, v gradients against ``jax.grad`` of
    the reference's ``chunked_attention`` (its scan body under
    ``jax.checkpoint``), f32, at the attention tolerance."""
    g = np.random.default_rng(12)
    S, H, KV, hd = 1536, 4, 2, 16
    q, k, v = _np(g, 1, S, H, hd), _np(g, 1, S, KV, hd), _np(g, 1, S, KV, hd)
    up = _np(g, 1, S, H, hd)

    def jloss(a, b, c):
        return jnp.sum(jref.chunked_attention(a, b, c, causal=True,
                                              window=700) * up)
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ref.flash_attention(*xs, causal=True, window=700)
    got = torch.autograd.grad(out, xs, torch.from_numpy(up))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32_TOL)


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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,H,KV,hd", [
    (3, 150, 12, 12, 64),                  # whisper's cross decode, T reduced
    (2, 48, 8, 1, 16),                     # one KV head for 8 query heads
])
def test_cross_decode_plain_matches_oracle(dtype, B, T, H, KV, hd):
    """The cross attention's decode: ``lengths`` only (no key positions,
    no query position), rows reading all of the encoder's T, part of it
    and one position."""
    g = np.random.default_rng((B, T, H))
    q, k, v = _np(g, B, H, hd), _np(g, B, T, KV, hd), _np(g, B, T, KV, hd)
    lengths = np.array([T, T // 3, 1][:B], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (q, k, v))
    want = jref.decode_attention(jq, jk, jv, lengths=jnp.asarray(lengths))
    got = ops.decode_attention(tq, tk, tv, lengths=torch.from_numpy(lengths))
    assert got.dtype == tv.dtype and got.shape == tq.shape
    _close(got, want, dtype, v)


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


def _split_schedule(q, k, v, lengths, pos, q_pos, window, block_t):
    """Plain emulation of ``csrc/decode_attention.cu``'s arithmetic
    order, in f32 on the CPU: the cache cut into splits of ``block_t``
    slots (the last one shorter when ``block_t`` does not divide T); per
    split ``m_i = max s`` and ``l_i = sum exp(s - m_i)`` (launch A); the
    row's ``m = max m_i`` and ``l = sum_i l_i exp(m_i - m)`` in split
    order, ``p = exp(s - m) / l`` rounded to bf16, masked slots skipped
    when the row has a valid key, each split's f32 partial P·V (launch
    B); the partials summed in split order and rounded once (launch C)."""
    B, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    s = torch.einsum("bkgd,btkd->bkgt", q.float().reshape(B, KV, G, hd),
                     k.float()) * (hd ** -0.5)
    valid = (pos >= 0) & (pos < lengths[:, None])
    if window is not None:
        valid &= pos > q_pos[:, None] - window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full((), -1e30))
    cuts = [slice(t0, min(T, t0 + block_t)) for t0 in range(0, T, block_t)]
    ms = [s[..., c].amax(-1) for c in cuts]
    ls = [torch.exp(s[..., c] - m[..., None]).sum(-1)
          for c, m in zip(cuts, ms)]
    m = torch.stack(ms).amax(0)
    l = torch.zeros_like(m)
    for mi, li in zip(ms, ls):
        l = l + li * torch.exp(mi - m)
    any_valid = (m > -1e30)[..., None]
    out = torch.zeros(B, KV, G, hd)
    for c in cuts:
        p = (torch.exp(s[..., c] - m[..., None]) / l[..., None]).to(
            torch.bfloat16).float()
        p = torch.where(valid[..., c] | ~any_valid, p, torch.zeros(()))
        out = out + torch.einsum("bkgt,btkd->bkgd", p, v[:, c].float())
    return out.to(torch.bfloat16).reshape(B, H, hd)


@pytest.mark.parametrize("q_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("B,T,H,KV,hd,window,ring,block_t", [
    (4, 192, 32, 32, 96, None, False, None),   # phi3 served, 3 splits
    (4, 512, 32, 8, 128, 384, True, None),     # ring + window, 8 splits
    (4, 1024, 16, 8, 256, 1024, True, None),   # gemma3-12b decode
    (1, 192, 32, 32, 96, None, False, None),   # phi3 at batch 1, 6 splits
    (4, 192, 4, 4, 96, None, False, 80),       # ragged last split (32)
    (3, 200, 8, 2, 64, None, False, 24),       # splits below 32 slots
    (2, 100, 4, 1, 40, 30, True, 100),         # one split, MQA
])
def test_split_schedule_matches_oracle(q_dtype, B, T, H, KV, hd, window,
                                       ring, block_t):
    """The split schedule of the CUDA decode kernel against the JAX
    oracle within 2^-7 max|v|, the card tests' bound, at chip_smoke's
    decode shapes (the wrapper's default split) and at chosen splits,
    with a row whose every slot is masked (mean of v)."""
    g = np.random.default_rng((B, T, hd, KV))
    q = _np(g, B, H, hd)
    k, v = _np(g, B, T, KV, hd), _np(g, B, T, KV, hd)
    lengths = np.array([T, T - 41, T // 2 + 3, 5][:B], np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    pos = np.where(pos < lengths[:, None], pos, -1).astype(np.int32)
    if ring:                                   # the newest r slots wrapped
        r = np.array([37, 0, 100, 3][:B])[:, None]
        j = np.arange(T)[None, :]
        pos = np.where(j < r, j + T, j).astype(np.int32)
        lengths = (T + r[:, 0]).astype(np.int32)
    lengths[-1] = 0 if B > 1 else lengths[-1]  # no valid key: mean of v
    q_pos = np.maximum(lengths - 1, 0).astype(np.int32)
    if block_t is None:
        block_t = tda.default_block_t(B, T, KV, H100_SMS)
    jq, tq = _pair(q, q_dtype)
    (jk, tk), (jv, tv) = _pair(k, "bf16"), _pair(v, "bf16")
    want = jref.decode_attention(jq, jk, jv, lengths=jnp.asarray(lengths),
                                 key_positions=jnp.asarray(pos),
                                 q_pos=jnp.asarray(q_pos), window=window)
    got = _split_schedule(tq, tk, tv, torch.from_numpy(lengths),
                          torch.from_numpy(pos), torch.from_numpy(q_pos),
                          window, block_t)
    want = np.asarray(want.astype(jnp.float32))
    vmax = np.abs(np.asarray(jv.astype(jnp.float32))).max()
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * vmax
    if B > 1:
        mean = tv[-1, :, :, :].float().mean(0).repeat_interleave(H // KV, 0)
        np.testing.assert_allclose(got[-1].float().numpy(), mean.numpy(),
                                   atol=2.0 ** -7 * vmax)


def test_default_block_t_fills_the_card():
    """The default split: at least two blocks per SM (here the H100 SXM's
    132) unless that would cut a split below 32 slots."""
    for B, T, KV in ((4, 192, 32), (4, 512, 8), (4, 1024, 8), (1, 192, 32),
                     (1, 4096, 8), (8, 64, 32), (1, 20, 1), (2, 999, 4)):
        bt = tda.default_block_t(B, T, KV, H100_SMS)
        n_split = -(-T // bt)
        assert bt >= tda.MIN_BLOCK_T
        assert KV * B * n_split >= 2 * H100_SMS or bt == tda.MIN_BLOCK_T
    assert [tda.default_block_t(*c, H100_SMS)
            for c in ((4, 192, 32), (4, 512, 8), (4, 1024, 8),
                      (1, 192, 32))] == [64, 56, 113, 32]


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
    with pytest.raises(ValueError, match="block_t"):
        tda.decode_attention(q[:, 0], q, q, lengths=torch.ones(1),
                             block_t=0)
    assert tfa.flash_attention.launches == 0
    assert tda.decode_attention.launches == 0
