"""The port's remaining dense attention variants on the CPU against the
JAX package: gemma3-12b (5 sliding-window + 1 global layer a group,
qk-norm, a scaled and tied embedding, GeGLU, head_dim 256 at full
width), stablelm-3b (LayerNorm with bias, partial rotary at 0.25) and
command-r-35b (parallel attention and MLP, LayerNorm, tied embedding).

JAX's own parameters for each ``-smoke`` config (``repro.models.registry
.init_params``) are carried across with ``param.from_numpy``, and the
same token batches, drawn with numpy from a seed, go through
``repro.models.registry`` (``impl="ref"``, the path the JAX engine takes
off the TPU) and ``repro_torch.models.registry``.  ``gemma3-12b-smoke``
has 12 layers and a window of 16: prompts of 10 (under the window), 24
and 32 (over it) and 12 decode steps, so the prefill takes both
branches of ``_prefill_cache`` and the decode writes past the ring's
wrap.

Tolerances, relative to max|logit|:

* f32 parameters: 1e-4, greedy tokens identical (those of
  ``tests/test_torch_models.py``).  Both run the same f32 operations in
  another summation order (full forward: <= 1e-5 measured).  The decode
  caches are bf16 on both sides, so a K/V value on a bf16 rounding
  boundary can round apart: the test resets the port's cache to JAX's
  before every decode step and holds each step alone (cache entries
  within one bf16 step, positions equal), to 1e-4 where the K/V values
  the step wrote equal JAX's bit for bit and to 1e-3 where one of them
  rounded apart (measured: 1.05e-4 on such a step).  Left to run free
  over 12
  steps, such flips pile up in gemma3-smoke's 12 layers (1 to 22 of
  each position's 2048 cached values) and the logits part by up to
  1.7e-4; the engine test holds the free-running greedy tokens.
* bf16 parameters: within ``max(2e-2, 2 g)``, where ``g`` is the JAX
  package's own bf16 error on the same inputs and tokens (its bf16
  logits against its f32 logits).  phi3-smoke's 2e-2 does not hold
  here: over seeds 0-3 the full forward's bf16 gap, port against JAX,
  reads 3.2e-2 to 6.2e-2 on gemma3-smoke (12 layers) and 1.5e-2 to
  5.1e-2 on stablelm-smoke, where JAX's own bf16 run lies 4.9e-2 to
  5.7e-2 and 8.0e-2 to 1.31e-1 from its f32 run, and the port's bf16
  run lies as far from JAX's f32 run as JAX's bf16 run does (ratio
  0.94 to 1.09).  Two such errors is the most two runs each as good as
  JAX's bf16 can differ.
"""
from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402

from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.configs.base import ATTN, ATTN_SWA, get_config  # noqa: E402
from repro_torch.core.profiles import BatchedService  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FULL = ("gemma3-12b", "stablelm-3b", "command-r-35b")
ARCHS = tuple(a + "-smoke" for a in FULL)
GEMMA = ARCHS[0]
F32_TOL = 1e-4
#: an f32 decode step whose new K/V rounded to another bf16 value than
#: JAX's somewhere (see the module docstring)
F32_FLIP_TOL = 1e-3
BF16_FLOOR = 2e-2
#: decode cache length of the prefill/decode test: the global layer's
#: cache holds every position (32 + 12 < 48); the ring holds 16
MAX_LEN = 48
DECODE_STEPS = 12
#: the reference's parameter counts at full width (JR.count_params)
FULL_COUNTS = {"gemma3-12b": 11_765_419_776, "stablelm-3b": 2_795_443_200,
               "command-r-35b": 30_283_546_624}


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, dtype: str):
    params = JR.init_params(jax_config(arch), jax.random.PRNGKey(0))
    if dtype == "f32":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        params)
    return params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_params(arch: str, dtype: str) -> dict:
    return P.from_numpy(_np(_jax_params(arch, dtype)))


@functools.lru_cache(maxsize=None)
def _jax_fns(arch: str):
    """Jitted (prefill at ``MAX_LEN``, decode step, full forward)."""
    jcfg = jax_config(arch)
    prefill = jax.jit(lambda p, t: JR.prefill(jcfg, p, {"tokens": t},
                                              MAX_LEN, impl="ref"))
    decode = jax.jit(lambda p, c, t, pos: JR.decode_step(jcfg, p, c, t, pos,
                                                         impl="ref"))
    logits = jax.jit(lambda p, t: JR.lm_logits(jcfg, p, {"tokens": t},
                                               impl="ref"))
    return prefill, decode, logits


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_tol(j16, j32) -> float:
    return max(BF16_FLOOR, 2.0 * _rel(j16, j32))


def _cache_close(got: dict, want: dict, want32=None) -> bool:
    """Every position's cache entry: positions equal; K/V bf16.  f32
    parameters (``want32`` None): each value within one bf16 step (2^-7
    relative) of JAX's plus ``F32_TOL`` of max|K|, |V| (an entry that
    cancels to ~1e-4 of the entries' scale carries f32 sum-order noise of
    several of its own bf16 steps: measured 1.3e-5 on a value of 3.8e-4
    where max|V| is 23).  bf16 parameters: each leaf within the bf16
    tolerance of max|K|, |V|, JAX's own error read against its f32 cache
    ``want32``.  -> whether every K/V value equals JAX's bit for bit."""
    assert set(got) == set(want)
    same = True
    for name in got:
        np.testing.assert_array_equal(got[name]["pos"].numpy(),
                                      np.asarray(want[name]["pos"]), name)
        for leaf in ("k", "v"):
            g, w = _f32(got[name][leaf]), _f32(want[name][leaf])
            assert got[name][leaf].dtype == torch.bfloat16
            assert g.shape == w.shape
            if want32 is not None:
                tol = _bf16_tol(w, want32[name][leaf])
                assert _rel(g, w) <= tol, (name, leaf)
            else:
                lim = 2.0 ** -7 * np.abs(w) + F32_TOL * np.abs(w).max()
                assert (np.abs(g - w) <= lim).all(), (name, leaf)
            same &= bool((g == w).all())
    return same


# ---------------------------------------------------------------------------
# Configs, counts, parameter trees
# ---------------------------------------------------------------------------
FIELDS = ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
          "vocab_size", "resolved_head_dim", "resolved_pattern",
          "sliding_window", "rope_theta", "rope_fraction", "qk_norm",
          "attn_logit_softcap", "norm", "parallel_block", "use_bias",
          "tie_embeddings", "act", "glu", "family", "sub_quadratic",
          "notes")


@pytest.mark.parametrize("arch", FULL)
def test_config_is_the_reference_config(arch):
    for name in (arch, arch + "-smoke"):
        port, ref = get_config(name), jax_config(name)
        for f in FIELDS:
            assert getattr(port, f) == getattr(ref, f), (name, f)
    assert get_config(GEMMA).sliding_window == 16
    assert get_config(GEMMA).resolved_pattern == (ATTN_SWA,) * 5 + (ATTN,)


@pytest.mark.parametrize("arch", FULL)
def test_count_params_full_width(arch):
    cfg = get_config(arch)
    assert R.count_params(cfg) == R.count_params(cfg, active=True) == \
        JR.count_params(jax_config(arch)) == FULL_COUNTS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_from_numpy_is_bit_exact_and_keeps_the_tree(arch):
    cfg = get_config(arch)
    jparams = _jax_params(arch, "bf16")
    port = P.from_numpy(_np(jparams))
    specs = R.model_specs(cfg)
    flat = dict(P.leaves(port))
    assert set(flat) == {p for p, _ in P.leaves(specs)}
    for path, s in P.leaves(specs):
        assert tuple(flat[path].shape) == s.shape, path
        assert flat[path].dtype == s.dtype, path
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = tuple(k.key for k in path)
        np.testing.assert_array_equal(_f32(flat[keys]), _f32(leaf))
    blocks = port["groups"]["pos0"]
    assert ("unembed" in port) == (not cfg.tie_embeddings)
    assert ("q_norm" in blocks["attn"]) == ("k_norm" in blocks["attn"]) \
        == cfg.qk_norm
    assert ("norm2" in blocks) == (not cfg.parallel_block)
    assert ("bias" in blocks["norm1"]) == (cfg.norm == "layernorm")
    assert arch != GEMMA or ("unembed" not in port and
                             "q_norm" in blocks["attn"])


# ---------------------------------------------------------------------------
# The paths that run for the first time, layer by layer
# ---------------------------------------------------------------------------
def test_gemma_embedding_scale_matches_jax():
    """sqrt(d_model) rounded to the table's dtype, at gemma3's full width
    (sqrt(3840) is not a bf16 value) and at the smoke width."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (2, 7)).astype(np.int32)
    for d in (3840, 64):
        cfg = replace(get_config(GEMMA), d_model=d)
        jcfg = replace(jax_config(GEMMA), d_model=d)
        table = rng.standard_normal((256, d)).astype(np.float32)
        for dt in (jnp.float32, jnp.bfloat16):
            jt = jnp.asarray(table).astype(dt)
            want = JL.embed_tokens(jcfg, {"tokens": jt}, jnp.asarray(tokens))
            got = L.embed_tokens(cfg, {"tokens": P.from_numpy(_np(jt))},
                                 torch.from_numpy(tokens))
            np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qk_norm_projection_matches_jax(dtype):
    """gemma3's q/k RMS norms with non-trivial scales, after the
    projections and before RoPE, at head_dim 256."""
    cfg = replace(get_config(GEMMA), head_dim=256)
    jcfg = replace(jax_config(GEMMA), head_dim=256)
    rng = np.random.default_rng(4)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    specs = A.attention_specs(cfg)
    jp = {k: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32)
                         / math.sqrt(s.shape[0])).astype(
              jdt if s.dtype == torch.bfloat16 else jnp.float32)
          for k, s in specs.items()}
    x = jnp.asarray(rng.standard_normal((2, 5, cfg.d_model)), jdt)
    want = JA._proj_qkv(jcfg, jp, x)
    got = A._proj_qkv(cfg, P.from_numpy(_np(jp)), P.from_numpy(_np(x)))
    for g, w in zip(got, want):
        assert _rel(g, w) <= (1e-6 if dtype == "f32" else 2.0 ** -7)


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norm_with_bias_matches_jax(norm):
    """stablelm's LayerNorm with a non-zero bias and scale (the smoke
    parameters hold ones and zeros), in f32 and bf16."""
    cfg = replace(get_config("stablelm-3b"), norm=norm)
    jcfg = replace(jax_config("stablelm-3b"), norm=norm)
    rng = np.random.default_rng(5)
    p = {k: rng.standard_normal(s.shape).astype(np.float32)
         for k, s in L.norm_specs(cfg).items()}
    x = rng.standard_normal((3, 4, cfg.d_model)).astype(np.float32) * 3 + 1
    for dt in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dt)
        want = JL.apply_norm(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                             xj)
        got = L.apply_norm(cfg, P.from_numpy(p), P.from_numpy(_np(xj)))
        assert got.dtype == (torch.float32 if dt == jnp.float32
                             else torch.bfloat16)
        assert _rel(got, want) <= (1e-6 if dt == jnp.float32 else 2.0 ** -8)


@pytest.mark.parametrize("hd,fraction", [(80, 0.25), (16, 0.25), (256, 1.0)])
def test_partial_rotary_matches_jax(hd, fraction):
    """stablelm's rotary on the first 25 % of each head (hd 80: rot 20,
    the rest passes through bit for bit), and gemma3's full rotary at
    hd 256 with its theta."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 9, 3, hd)).astype(np.float32)
    pos = np.arange(100, 109, dtype=np.int32)
    theta = 1e6 if hd == 256 else 1e4
    for dt in (jnp.float32, jnp.bfloat16):
        xj = jnp.asarray(x).astype(dt)
        want = JL.rope(xj, jnp.asarray(pos), theta, fraction)
        got = L.rope(P.from_numpy(_np(xj)), torch.from_numpy(pos), theta,
                     fraction)
        rot = int(hd * fraction) - int(hd * fraction) % 2
        np.testing.assert_array_equal(_f32(got)[..., rot:],
                                      _f32(want)[..., rot:])
        assert _rel(got, want) <= (1e-5 if dt == jnp.float32 else 2.0 ** -8)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_parallel_block_matches_jax(dtype):
    """command-r's block, ``x + attn(norm1(x)) + mlp(norm1(x))``, with
    non-trivial norm scales and biases, prefill and decode forms."""
    arch = "command-r-35b-smoke"
    cfg, jcfg = get_config(arch), jax_config(arch)
    rng = np.random.default_rng(6)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                _jax_params(arch, dtype)["groups"]["pos0"])
    jp["norm1"] = {k: jnp.asarray(rng.standard_normal(v.shape), v.dtype)
                   for k, v in jp["norm1"].items()}
    p = P.from_numpy(_np(jp))
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tol = 1e-5 if dtype == "f32" else 2e-2
    x = jnp.asarray(rng.standard_normal((2, 11, cfg.d_model)), jdt)
    pos = jnp.arange(11)
    want = JT.apply_block_seq(jcfg, jp, ATTN, x, positions=pos, impl="ref",
                              moe_impl="dispatch")
    got, (k, v) = T.apply_block_seq(cfg, p, ATTN, P.from_numpy(_np(x)),
                                    positions=torch.arange(11))
    assert _rel(got, want) <= tol
    cache = P.init_tree(A.make_kv_cache_specs(cfg, 2, 16), torch.Generator())
    jcache = {k: jnp.asarray(_f32(t)).astype(
        jnp.int32 if t.dtype == torch.int32 else jnp.bfloat16)
        for k, t in cache.items()}                # the same empty cache
    xd = jnp.asarray(rng.standard_normal((2, cfg.d_model)), jdt)
    positions = jnp.array([3, 7], jnp.int32)
    want, _ = JT.apply_block_decode(jcfg, jp, ATTN, xd, jcache,
                                    positions=positions, impl="ref",
                                    moe_impl="dispatch")
    got = T.apply_block_decode(cfg, p, ATTN, P.from_numpy(_np(xd)), cache,
                               positions=torch.tensor([3, 7],
                                                      dtype=torch.int32))
    assert _rel(got, want) <= tol
    assert "norm2" not in p and "mlp" in p


# ---------------------------------------------------------------------------
# Whole models: full forward, prefill + decode, caches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_full_forward_matches_reference(arch):
    cfg = get_config(arch)
    _, _, jlogits = _jax_fns(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 29)).astype(np.int32)
    j32 = jlogits(_jax_params(arch, "f32"), jnp.asarray(toks))
    got = R.lm_logits(cfg, _port_params(arch, "f32"),
                      {"tokens": torch.from_numpy(toks)})
    assert _rel(got, j32) <= F32_TOL
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(j32.argmax(-1)))
    j16 = jlogits(_jax_params(arch, "bf16"), jnp.asarray(toks))
    got = R.lm_logits(cfg, _port_params(arch, "bf16"),
                      {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16
    assert _rel(got, j16) <= _bf16_tol(j16, j32)


CASES = ([(GEMMA, s, d) for s in (10, 24, 32) for d in ("f32", "bf16")]
         + [(a, 24, d) for a in ARCHS[1:] for d in ("f32", "bf16")])


@pytest.mark.parametrize("arch,S,dtype", CASES)
def test_prefill_and_decode_match_reference(arch, S, dtype):
    """Prefill of a batch of 2 (``S`` tokens) and ``DECODE_STEPS`` decode
    steps fed JAX's f32 greedy tokens.  Before every step the port's
    cache is reset to JAX's, so each step is held alone; after it, the
    cache entries it wrote (ring slot ``pos % 16`` on the SWA layers)
    are held against JAX's."""
    cfg = get_config(arch)
    jprefill, jdecode, _ = _jax_fns(arch)
    jp = _jax_params(arch, dtype)
    params = _port_params(arch, dtype)
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                             (2, S)).astype(np.int32)
    jl, jcache, jlen = jprefill(jp, jnp.asarray(toks))
    tl, tcache, tlen = R.prefill(cfg, params,
                                 {"tokens": torch.from_numpy(toks)}, MAX_LEN)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    jcache32 = None
    if dtype == "bf16":      # JAX's own bf16 error, on the same tokens
        jp32 = _jax_params(arch, "f32")
        j32, jcache32, _ = jprefill(jp32, jnp.asarray(toks))
        tol = _bf16_tol(jl, j32)
    else:
        j32, tol = jl, F32_TOL
    assert _rel(tl, jl) <= tol
    _cache_close(tcache, jcache, jcache32)
    if arch == GEMMA:
        ring, full = tcache["pos0"]["pos"], tcache["pos5"]["pos"]
        assert ring.shape[-1] == 16 and full.shape[-1] == MAX_LEN
        # the ring holds the last min(S, 16) positions at slot pos % 16
        last = np.arange(max(0, S - 16), S)
        assert sorted(ring[0, 0][ring[0, 0] >= 0].tolist()) == last.tolist()
        assert (ring[0, 0, last % 16].numpy() == last).all()
    tok = j32.argmax(-1).astype(jnp.int32)
    if dtype == "f32":
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(tok))
    pos = jlen
    for _ in range(DECODE_STEPS):
        tcache = P.from_numpy(_np(jcache))
        jl, jcache = jdecode(jp, jcache, tok, pos)
        tl, tcache = R.decode_step(cfg, params, tcache,
                                   torch.from_numpy(np.array(tok)),
                                   torch.from_numpy(np.array(pos)))
        if dtype == "bf16":
            j32, jcache32 = jdecode(jp32, jcache32, tok, pos)
            assert _rel(tl, jl) <= _bf16_tol(jl, j32)
            _cache_close(tcache, jcache, jcache32)
        else:
            j32 = jl
            same = _cache_close(tcache, jcache)
            assert _rel(tl, jl) <= (F32_TOL if same else F32_FLIP_TOL)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                          np.asarray(jl.argmax(-1)))
        tok, pos = j32.argmax(-1).astype(jnp.int32), pos + 1
    if arch == GEMMA:        # every ring slot rewritten past the wrap
        ring = tcache["pos0"]["pos"][0, 0].numpy()
        end = S + DECODE_STEPS
        assert sorted(ring.tolist()) == list(range(end - 16, end))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _jax_greedy(arch, jparams, prompt, n_new: int, width: int = 64) -> list:
    """Full-forward greedy decode without a cache; the sequence is
    right-padded to ``width`` (under the causal mask the pad never
    reaches the logits at ``len - 1``)."""
    _, _, fwd = _jax_fns(arch)
    toks = [int(t) for t in prompt]
    out = []
    for _ in range(n_new):
        row = np.zeros((1, width), np.int32)
        row[0, :len(toks)] = toks
        logits = fwd(jparams, jnp.asarray(row))[0, len(toks) - 1]
        out.append(int(jnp.argmax(logits)))
        toks.append(out[-1])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_jax_full_forward(arch):
    """Three ragged prompts on two slots, f32 parameters (the cache is
    bf16): the third waits for a slot and is prefilled into a reused
    one.  For gemma3 two prompts are longer than the window and the
    short one decodes past the ring's wrap (9 + 10 > 16); every
    request's tokens equal JAX's full-forward greedy."""
    cfg = get_config(arch)
    jparams = _jax_params(arch, "f32")
    params = _port_params(arch, "f32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (24, 9, 37)]
    eng = InferenceEngine(cfg, params, max_batch=2, max_len=96)
    for i, p in enumerate(prompts):
        eng.submit(p, 10, i)
    done = {c.req_id: c for c in eng.run_until_idle()}
    assert sorted(done) == [0, 1, 2] and eng.prefill_count == 3
    for i, p in enumerate(prompts):
        assert done[i].tokens == _jax_greedy(arch, jparams, p, 10), i


def test_engine_prefills_swa_at_exact_length(monkeypatch):
    """No bucket for a model with sliding-window layers (its pads would
    enter the ring and push real keys out); stablelm and command-r, full
    attention only, still pad to the bucket."""
    seen = []
    real = R.prefill

    def spy(cfg, params, batch, max_len, **kw):
        seen.append((cfg.name, tuple(batch["tokens"].shape)))
        return real(cfg, params, batch, max_len, **kw)
    monkeypatch.setattr(R, "prefill", spy)
    for arch in ARCHS:
        cfg = get_config(arch)
        params = R.init_params(cfg, torch.Generator().manual_seed(0))
        eng = InferenceEngine(cfg, params, max_batch=2, max_len=64)
        assert eng._exact_prefill == (arch == GEMMA)
        assert eng.cache["pos0"]["k"].shape[2] == (16 if arch == GEMMA
                                                   else 64)
        eng.submit(np.arange(21) % cfg.vocab_size, 3, 0)
        eng.run_until_idle()
        assert seen[-1] == (arch, (1, 21 if arch == GEMMA else 32))


def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_launch_serve_gemma3_smoke_on_cpu():
    """40-token prompts, over the smoke window of 16."""
    out = _run("repro_torch.launch.serve", "--arch", "gemma3-12b",
               "--smoke", "--device", "cpu", "--duration", "2", "--qps", "6",
               "--prompt-len", "40")
    line = [ln for ln in out.splitlines() if ln.startswith("serve: ")]
    rep = json.loads(line[-1][len("serve: "):])
    assert rep["n"] == rep["submitted"] > 0 and rep["dropped"] == 0
    assert rep["decode_steps"] > 0 and rep["tokens"] >= 4 * rep["n"]
    for key in ("p50_ms", "p99_ms", "ttft_p50_ms", "decode_step_ms",
                "tokens_per_s"):
        assert math.isfinite(rep[key]) and rep[key] > 0, key


@pytest.mark.parametrize("arch", FULL)
def test_batched_serving_arch_builds_from_hopper_roofline(arch):
    """``batched-serving arch=...`` on the H100's datasheet figures: a
    decode step streams the bf16 parameters (``count_params``) once over
    8 cards at 3.35 TB/s; compute is 2 FLOPs a parameter a token at
    989 TFLOP/s."""
    n = R.count_params(get_config(arch))
    sc = tsc.get("batched-serving", arch=arch)
    svc = sc.service_model
    assert svc == BatchedService.from_arch(arch)
    assert svc.name == f"batched:{arch}"
    assert svc.t_memory == 2.0 * n / (8 * 3.35e12)
    assert svc.t_compute_per_seq == svc.t_prefill_per_token == \
        2.0 * n / (8 * 989e12)
    from test_torch_engine_control import _port
    rt = _port(tsc.get("batched-serving", arch=arch, duration=2.0,
                       qps=40.0))
    assert rt.telemetry.overall().n > 0
