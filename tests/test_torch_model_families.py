"""The port's remaining model families on the CPU against the JAX
package: jamba-1.5-large-398b (Mamba-2, attention and MoE layers in one
group of 8), whisper-small (an encoder of bidirectional attention, a
decoder whose every block adds cross attention over the encoder's
output; LayerNorm, biases, a plain GeLU MLP; the frame frontend) and
llava-next-mistral-7b (mistral's decoder behind the patch frontend).

JAX's own parameters for each ``-smoke`` config are carried across with
``param.from_numpy``.  JAX initialises every bias to zero, so whisper's
attention, MLP and LayerNorm biases are drawn anew with numpy and loaded
into both trees (``_with_biases``).  Frames, patch embeddings and token
batches are drawn with numpy from a seed.  The JAX side runs
``repro.models`` with ``impl="ref"``, the path the JAX engine takes off
the TPU.

Tolerances, relative to the largest magnitude of the reference's output:

* cross attention and the encoder alone: f32 within 1e-5 (the same f32
  operations summed in another order); bf16 within 2^-7 of max|v| for
  one attention (a probability or an output on a bf16 rounding boundary
  rounds apart: one bf16 step) and 2e-2 for the encoder's stack.
* whole smoke models: f32 within ``max(1e-4, 2 u)``, with greedy tokens
  equal, where ``u`` is how far JAX's own f32 logits move when every
  f32 weight moves one ulp (``_ulp_gap``): the stacked matrices of a
  2-group smoke model are drawn at std 1/sqrt(2), attention scores are
  large, and f32 sums in any order move the logits.  Measured over seeds
  0-7: the full forward (``lm_logits``) of whisper-smoke differs from
  JAX by 4.1e-5 to 5.5e-4 at 20 and 40 tokens, where JAX's own f32 run
  lies 5.5e-5 to 9.0e-4 from JAX run in f64 (``jax_enable_x64``); that
  of jamba-smoke by 6.3e-5 to 1.95e-4 (JAX cannot run its SSD scan in
  f64).  The prefill's last position and each decode step (the port's
  cache reset to JAX's before it, as ``tests/test_torch_moe.py`` does)
  read under 4e-5.  bf16 within ``max(2e-2, 2 g)``, where ``g`` is the
  JAX package's own bf16 gap on the same tokens (its bf16 logits against
  its f32 logits), as in ``tests/test_torch_dense_variants.py``;
  jamba's bf16 is held against JAX run op by op (``jax.disable_jit``),
  as the MoE tests do.  Caches: positions and Mamba states as in those
  tests; ``ek``/``ev`` bf16, within one bf16 step of JAX's.
* parameter counts and spec trees equal; the engine's greedy tokens
  equal JAX's prefill/decode greedy.
"""
from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
from dataclasses import asdict, replace
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.configs.base import list_configs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import param as JP  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serving.engine import _bucket as jax_bucket  # noqa: E402
from repro.serving.engine import make_warmed_engine as jax_warmed  # noqa: E402

from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.configs import base as CB  # noqa: E402
from repro_torch.configs.base import (ATTN, MAMBA, ENC_ATTN,  # noqa: E402
                                      get_config)
from repro_torch.core.profiles import BatchedService  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAMBA, WHISPER, LLAVA = FULL = ("jamba-1.5-large-398b", "whisper-small",
                                "llava-next-mistral-7b")
ARCHS = tuple(a + "-smoke" for a in FULL)
#: the reference's parameter counts at full width (JR.count_params):
#: total, active
FULL_COUNTS = {JAMBA: (397_645_855_104, 93_240_048_000),
               WHISPER: (278_241_792, 278_241_792),
               LLAVA: (7_245_926_400, 7_245_926_400)}
#: the cut of jamba's group that one card runs at full width (the
#: group's positions 4 and 5: attention with its dense MLP, then Mamba
#: with an MoE FFN)
JAMBA_CUT = dict(num_layers=2, pattern=(ATTN, MAMBA), moe_positions=(1,))
JAMBA_CUT_COUNTS = (11_898_463_872, 3_442_747_008)
LAYER_TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
F32_TOL = 1e-4
#: an f32 decode step whose new K/V rounded to another bf16 value than
#: JAX's somewhere (``tests/test_torch_dense_variants.py``)
F32_FLIP_TOL = 1e-3
BF16_FLOOR = 2e-2
MAX_LEN = 64
DECODE_STEPS = 3
#: the inputs of each model's whole-model tests: tokens a row, and the
#: frames (whisper) or patches (llava) a row; jamba's 40 tokens cross
#: its smoke chunk of 32
SHAPES = {ARCHS[0]: (40, 0), ARCHS[1]: (20, 24), ARCHS[2]: (20, 12)}
BIAS_LEAVES = ("qb", "kb", "vb", "ob", "bi", "bo", "bias")


def _with_biases(tree, seed: int = 3):
    """``tree`` with every bias leaf (attention, MLP, LayerNorm) drawn
    from N(0, 0.1^2) with numpy, in the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k in sorted(node):
            v = node[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in BIAS_LEAVES:
                out[k] = jnp.asarray(0.1 * rng.standard_normal(
                    v.shape).astype(np.float32)).astype(v.dtype)
            else:
                out[k] = v
        return out
    return walk(tree)


@functools.lru_cache(maxsize=None)
def _jax_params(arch: str, dtype: str, **over):
    jcfg = replace(jax_config(arch), **dict(over)) if over \
        else jax_config(arch)
    params = JR.init_params(jcfg, jax.random.PRNGKey(0))
    if jcfg.use_bias:
        params = _with_biases(params)
    if dtype == "f32":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        params)
    return params


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_params(arch: str, dtype: str) -> dict:
    return P.from_numpy(_np(_jax_params(arch, dtype)))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want) -> float:
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_tol(j16, j32) -> float:
    return max(BF16_FLOOR, 2.0 * _rel(j16, j32))


def _jdt(dtype: str):
    return jnp.float32 if dtype == "f32" else jnp.bfloat16


def _ulp_up(tree):
    """Every f32 leaf moved one ulp up."""
    return jax.tree_util.tree_map(
        lambda a: jnp.nextafter(a, jnp.inf) if a.dtype == jnp.float32
        else a, tree)


def _f32_tol(fn, jparams, want, *args, floor: float = F32_TOL) -> float:
    """``max(floor, 2 u)``, ``u`` = how far the logits of ``fn`` (its
    output, or its output's first item) move from ``want`` when every f32
    weight moves one ulp (see the module docstring)."""
    out = fn(_ulp_up(jparams), *args)
    return max(floor, 2.0 * _rel(out[0] if isinstance(out, tuple) else out,
                                 want))


def _batch(arch: str, seed: int, dtype: str = "f32"):
    """(JAX batch, port batch) of 2 rows: tokens, and frames or patch
    embeddings where the model has a frontend, drawn with numpy."""
    cfg = get_config(arch)
    S, n = SHAPES[arch]
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    key = {"frame": "frames", "patch": "patch_embeds"}.get(cfg.embed_frontend)
    if key:
        a = g.standard_normal((2, n, R.FRONTEND_DIMS[cfg.embed_frontend]))
        a = a.astype(np.float32)
        jb[key] = jnp.asarray(a).astype(_jdt(dtype))
        tb[key] = P.from_numpy(_np(jb[key]))
    return jb, tb


# ---------------------------------------------------------------------------
# Configs, counts, spec trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FULL + ARCHS)
def test_config_is_the_reference_config(name):
    assert asdict(get_config(name)) == asdict(jax_config(name))


def test_registry_holds_every_reference_arch():
    """``get_config`` returns every arch the JAX package lists, and its
    smoke form; the port registers those and no other."""
    for name in list_configs():
        assert get_config(name).name == name
        assert get_config(name + "-smoke").name == name + "-smoke"
    CB._populate()
    assert sorted(CB._REGISTRY) == list_configs()


def test_unknown_arch_lists_the_registered_ones():
    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'") as e:
        get_config("no-such-arch")
    assert all(name in str(e.value) for name in list_configs())


@pytest.mark.parametrize("arch", FULL + ("jamba-cut",))
def test_count_params_total_and_active(arch):
    if arch == "jamba-cut":
        cfg = replace(get_config(JAMBA), **JAMBA_CUT)
        jcfg = replace(jax_config(JAMBA), **JAMBA_CUT)
        want = JAMBA_CUT_COUNTS
    else:
        cfg, jcfg, want = get_config(arch), jax_config(arch), \
            FULL_COUNTS[arch]
    assert R.count_params(cfg) == JR.count_params(jcfg) == want[0]
    assert R.count_params(cfg, active=True) == \
        JR.count_params(jcfg, active=True) == want[1]


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return np.dtype(dt).name


def _spec_tree(specs, is_spec):
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_spec)[0]
    return {tuple(getattr(k, "key", str(k)) for k in path):
            (tuple(s.shape), _dtype_name(s.dtype)) for path, s in flat}


@pytest.mark.parametrize("arch,over", [(a, {}) for a in FULL + ARCHS]
                         + [(WHISPER, dict(num_encoder_layers=3)),
                            (WHISPER + "-smoke",
                             dict(num_encoder_layers=3))])
def test_spec_trees_match_jax(arch, over):
    """Paths, shapes and dtypes of ``model_specs`` and of a decode
    cache (whisper's with ``ek``/``ev`` over 24 encoder positions)
    equal JAX's; with ``num_encoder_layers=3`` the encoder stacks 3
    groups and the decoder 12 (smoke: 3 and 2)."""
    cfg = replace(get_config(arch), **over)
    jcfg = replace(jax_config(arch), **over)
    got = _spec_tree(R.model_specs(cfg), lambda s: isinstance(s, P.Spec))
    assert got == _spec_tree(JR.model_specs(jcfg), JP.is_spec)
    enc = 24 if cfg.enc_dec else None
    got = _spec_tree(R.cache_specs(cfg, 2, 48, enc_len=enc),
                     lambda s: isinstance(s, P.Spec))
    assert got == _spec_tree(JR.cache_specs(jcfg, 2, 48, enc_len=enc),
                             JP.is_spec)
    if over:
        assert R.model_specs(cfg)["enc_groups"]["pos0"]["attn"]["q"] \
            .shape[0] == 3
        assert R.model_specs(cfg)["groups"]["pos0"]["xattn"]["q"] \
            .shape[0] == cfg.n_groups


def test_cross_blocks_have_no_qk_norm_and_follow_use_bias():
    cfg = replace(get_config(ARCHS[1]), qk_norm=True)
    specs = A.attention_specs(cfg, cross=True)
    assert "q_norm" not in specs and "k_norm" not in specs
    assert {"qb", "kb", "vb", "ob"} <= set(specs)
    assert "q_norm" in A.attention_specs(cfg)
    assert not {"qb", "kb", "vb", "ob"} & set(A.attention_specs(
        replace(cfg, use_bias=False), cross=True))


# ---------------------------------------------------------------------------
# Cross attention and the encoder alone
# ---------------------------------------------------------------------------
def _cross_layer(dtype: str, seed: int = 0):
    """(port cfg, JAX cfg, JAX cross-attention params) of whisper-smoke,
    every leaf drawn with numpy (biases non-zero), in ``dtype``; the
    biases f32 as their specs."""
    cfg, jcfg = get_config(ARCHS[1]), jax_config(ARCHS[1])
    rng = np.random.default_rng(seed)
    specs = JA.attention_specs(jcfg, cross=True)
    jp = {}
    for k, s in specs.items():
        a = rng.standard_normal(s.shape).astype(np.float32)
        if k in BIAS_LEAVES:
            jp[k] = jnp.asarray(0.1 * a)
        else:
            jp[k] = jnp.asarray(a / math.sqrt(s.shape[0])).astype(
                _jdt(dtype))
    return cfg, jcfg, jp


def _x(dtype: str, shape, seed: int):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(
        shape + (64,)).astype(np.float32)).astype(_jdt(dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_kv_matches_jax(dtype):
    _, _, jp = _cross_layer(dtype)
    enc = _x(dtype, (2, 24), 1)
    jk, jv = JA.cross_kv(jp, enc)
    k, v = A.cross_kv(P.from_numpy(_np(jp)), P.from_numpy(_np(enc)))
    for got, want in ((k, jk), (v, jv)):
        assert got.dtype == (torch.float32 if dtype == "f32"
                             else torch.bfloat16)
        assert tuple(got.shape) == want.shape == (2, 24, 2, 16)
        assert _rel(got, want) <= (1e-6 if dtype == "f32" else 2.0 ** -8)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("S", [1, 9, 40])
def test_cross_attention_seq_matches_jax(dtype, S):
    """A decoder sequence shorter than, or longer than, the 24 encoder
    positions, without a mask."""
    cfg, jcfg, jp = _cross_layer(dtype)
    x, enc = _x(dtype, (2, S), 2), _x(dtype, (2, 24), 1)
    want = JA.cross_attention_seq(jcfg, jp, x, enc, impl="ref")
    p = P.from_numpy(_np(jp))
    got = A.cross_attention_seq(cfg, p, P.from_numpy(_np(x)),
                                *A.cross_kv(p, P.from_numpy(_np(enc))))
    assert tuple(got.shape) == want.shape and got.dtype == \
        (torch.float32 if dtype == "f32" else torch.bfloat16)
    assert _rel(got, want) <= LAYER_TOL[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_attention_decode_matches_jax(dtype):
    """One token a row over the bf16 encoder cache; rows read 24, 7 and
    1 of its 24 positions (``enc_lengths < T``)."""
    cfg, jcfg, jp = _cross_layer(dtype)
    x, enc = _x(dtype, (3,), 4), _x(dtype, (3, 24), 5)
    jk, jv = JA.cross_kv(jp, enc)
    ek, ev = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    lens = np.array([24, 7, 1], np.int32)
    want = JA.cross_attention_decode(jcfg, jp, x, ek, ev, jnp.asarray(lens),
                                     impl="ref")
    got = A.cross_attention_decode(cfg, P.from_numpy(_np(jp)),
                                   P.from_numpy(_np(x)),
                                   P.from_numpy(_np(ek)),
                                   P.from_numpy(_np(ev)),
                                   torch.from_numpy(lens))
    assert tuple(got.shape) == want.shape == (3, 64)
    assert _rel(got, want) <= LAYER_TOL[dtype]
    # row 2 reads encoder position 0 only: a shorter cache agrees
    one = A.cross_attention_decode(cfg, P.from_numpy(_np(jp)),
                                   P.from_numpy(_np(x))[2:],
                                   P.from_numpy(_np(ek))[2:, :1],
                                   P.from_numpy(_np(ev))[2:, :1],
                                   torch.ones(1, dtype=torch.int32))
    assert _rel(one, got[2:]) <= LAYER_TOL[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_without_key_positions_masks_as_jax(dtype):
    """``ops.decode_attention`` with ``lengths`` only: key ``j`` counts
    when ``j < lengths`` (JAX's oracle), ``lengths < T`` included."""
    from repro.kernels import ref as jref
    g = np.random.default_rng(9)
    q, k, v = (g.standard_normal(s).astype(np.float32)
               for s in ((3, 12, 64), (3, 30, 12, 64), (3, 30, 12, 64)))
    lens = np.array([30, 11, 1], np.int32)
    jq, jk, jv = (jnp.asarray(a).astype(_jdt(dtype)) for a in (q, k, v))
    want = jref.decode_attention(jq, jk, jv, lengths=jnp.asarray(lens))
    got = ops.decode_attention(*(P.from_numpy(_np(a)) for a in (jq, jk, jv)),
                               lengths=torch.from_numpy(lens))
    assert _rel(got, want) <= LAYER_TOL[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_cross_attention_dtype_reaching_flash(dtype, monkeypatch):
    """The flash kernel takes one dtype: on an f32 tree q, k and v reach
    ``ops.flash_attention`` in f32, on a bf16 tree in bf16; a mixed pair
    (f32 q over bf16 K/V) is cast to the promoted dtype, f32."""
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.dtype, k.dtype, v.dtype, kw["causal"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention", spy)
    cfg = get_config(ARCHS[1])
    jb, tb = _batch(ARCHS[1], 0)
    R.lm_logits(cfg, _port_params(ARCHS[1], dtype), tb)
    want = torch.float32 if dtype == "f32" else torch.bfloat16
    assert seen and all(s[:3] == (want,) * 3 for s in seen)
    # 2 encoder layers, then per decoder layer self (causal) and cross
    assert [s[3] for s in seen] == [False, False, True, False, True, False]
    seen.clear()
    _, _, jp = _cross_layer("bf16")
    p = P.from_numpy(_np(jp))
    kv = A.cross_kv(p, P.from_numpy(_np(_x("bf16", (1, 24), 1))))
    A.cross_attention_seq(cfg, p, P.from_numpy(_np(_x("f32", (1, 5), 2))),
                          *kv)
    assert seen == [(torch.float32,) * 3 + (False,)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_encode_matches_jax_and_is_bidirectional(dtype):
    """``_encode`` of whisper-smoke (2 encoder groups) within the whole
    models' tolerances (f32 ``max(1e-4, 2 u)``, bf16 ``max(2e-2, 2 g)``);
    changing the last frame moves the first position's output (no causal
    mask)."""
    arch = ARCHS[1]
    cfg, jcfg = get_config(arch), jax_config(arch)
    jp, params = _jax_params(arch, dtype), _port_params(arch, dtype)
    fr = np.random.default_rng(6).standard_normal((2, 24, 128)).astype(
        np.float32)
    enc = jax.jit(lambda p, f: JR._encode(jcfg, p, f, impl="ref"))
    jp32 = _jax_params(arch, "f32")
    want32 = enc(jp32, jnp.asarray(fr))
    want = enc(jp, jnp.asarray(fr).astype(_jdt(dtype)))
    got = R._encode(cfg, params, torch.from_numpy(fr).to(
        torch.float32 if dtype == "f32" else torch.bfloat16))
    assert tuple(got.shape) == want.shape == (2, 24, 64)
    assert _rel(got, want) <= (
        _f32_tol(enc, jp32, want32, jnp.asarray(fr)) if dtype == "f32"
        else _bf16_tol(want, want32))
    fr2 = fr.copy()
    fr2[:, -1] += 1.0
    moved = R._encode(cfg, params, torch.from_numpy(fr2).to(got.dtype))
    assert (moved[:, 0] != got[:, 0]).any()


@pytest.mark.parametrize("arch", ARCHS[1:])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_frontend_rounds_its_input_to_bf16(arch, dtype):
    """Frames and patch embeddings are rounded to bf16 before their
    projection on either tree; the image prefix and the token
    embeddings are concatenated in JAX's promoted dtype, the positions
    run over the whole sequence."""
    cfg = get_config(arch)
    params = _port_params(arch, dtype)
    key = "frames" if cfg.enc_dec else "patch_embeds"
    x = torch.randn((1, 6, R.FRONTEND_DIMS[cfg.embed_frontend]),
                    generator=torch.Generator().manual_seed(0))
    exact = {key: x, "tokens": torch.zeros((1, 4), dtype=torch.int32)}
    rounded = dict(exact, **{key: x.to(torch.bfloat16).float()})
    if cfg.enc_dec:
        torch.testing.assert_close(R._encode(cfg, params, exact[key]),
                                   R._encode(cfg, params, rounded[key]),
                                   rtol=0, atol=0)
        return
    e, pos = R._embed_input(cfg, params, exact)
    torch.testing.assert_close(e, R._embed_input(cfg, params, rounded)[0],
                               rtol=0, atol=0)
    assert e.shape == (1, 10, 64) and pos.tolist() == list(range(10))
    jp = _jax_params(arch, dtype)
    je, jpos = JR._embed_input(jax_config(arch), jp, {
        key: jnp.asarray(x.numpy()), "tokens": jnp.zeros((1, 4), jnp.int32)})
    assert _dtype_name(je.dtype) == _dtype_name(e.dtype)
    assert _rel(e, je) <= (1e-6 if dtype == "f32" else 2.0 ** -8)
    # a bf16 token table after an f32 projection promotes to f32
    mixed = dict(params, embed={"tokens": params["embed"]["tokens"].to(
        torch.bfloat16)}, frontend={"proj": params["frontend"]["proj"]
                                    .float()})
    assert R._embed_input(cfg, mixed, exact)[0].dtype == torch.float32


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_fns(arch: str, **over):
    """Jitted (full forward, prefill at ``MAX_LEN`` with lengths, decode
    step) of ``arch`` (with ``over`` replaced in its config)."""
    jcfg = replace(jax_config(arch), **dict(over)) if over \
        else jax_config(arch)
    logits = jax.jit(lambda p, b: JR.lm_logits(jcfg, p, b, impl="ref"))
    prefill = jax.jit(lambda p, b, n: JR.prefill(jcfg, p, b, MAX_LEN,
                                                 impl="ref", lengths=n))
    decode = jax.jit(lambda p, c, t, pos: JR.decode_step(jcfg, p, c, t, pos,
                                                         impl="ref"))
    return logits, prefill, decode


def _eager(fn):
    """``fn`` run op by op (``jax.disable_jit``)."""
    def run(*args):
        with jax.disable_jit():
            return fn(*args)
    return run


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lm_logits_match_jax(arch, dtype):
    cfg = get_config(arch)
    jlogits = _jax_fns(arch)[0]
    jb, tb = _batch(arch, 1, dtype)
    jp32 = _jax_params(arch, "f32")
    j32 = jlogits(jp32, _batch(arch, 1)[0])
    got = R.lm_logits(cfg, _port_params(arch, dtype), tb)
    if dtype == "f32":
        tol = _f32_tol(jlogits, jp32, j32, _batch(arch, 1)[0])
        assert _rel(got, j32) <= tol
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(j32.argmax(-1)))
    else:
        j16 = jlogits(_jax_params(arch, "bf16"), jb)
        assert got.dtype == torch.bfloat16
        assert _rel(got, j16) <= _bf16_tol(j16, j32)


def _spec_dtypes(cache):
    """JAX's decode cache with the conv tails rounded to bf16, their spec
    dtype (JAX's decode returns them in f32; see
    ``tests/test_torch_mamba.py``)."""
    return {k: {leaf: (v.astype(jnp.bfloat16) if leaf.startswith("conv")
                       else v) for leaf, v in e.items()}
            for k, e in cache.items()}


def _cache_close(got: dict, want: dict, want32=None) -> bool:
    """Every position's cache entry: positions equal, ``ek``/``ev`` bf16.
    f32 parameters (``want32`` None): each bf16 value within one bf16
    step of JAX's plus ``F32_TOL`` of the leaf's largest entry, as
    ``tests/test_torch_dense_variants.py`` holds K/V; the f32 Mamba state
    within ``F32_TOL`` (``tests/test_torch_mamba.py``).  bf16 parameters:
    each leaf within the bf16 tolerance, JAX's own error read against its
    f32 cache ``want32``.  -> whether every bf16 value equals JAX's."""
    assert set(got) == set(want)
    same = True
    for name, entry in want.items():
        assert set(got[name]) == set(entry), name
        for leaf, w in entry.items():
            g = got[name][leaf]
            assert tuple(g.shape) == w.shape, (name, leaf)
            if leaf == "pos":
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
                continue
            if leaf in ("ek", "ev"):
                assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
            gw, ww = _f32(g), _f32(w)
            if want32 is not None:
                assert _rel(gw, ww) <= _bf16_tol(
                    ww, want32[name][leaf]), (name, leaf)
            elif g.dtype == torch.bfloat16:
                lim = 2.0 ** -7 * np.abs(ww) + F32_TOL * np.abs(ww).max()
                assert (np.abs(gw - ww) <= lim).all(), (name, leaf)
                same &= bool((gw == ww).all())
            else:
                assert _rel(gw, ww) <= F32_TOL, (name, leaf)
    return same


def _run_prefill_decode(arch: str, dtype: str, over=None, seed: int = 2):
    """Prefill of a batch of 2 and ``DECODE_STEPS`` decode steps fed
    JAX's f32 greedy tokens.  Before every step the port's cache is reset
    to JAX's (the caches are bf16 on both sides: a value on a rounding
    boundary can round apart, and such flips pile up), so each step is
    held alone: f32 to ``F32_TOL``, or ``F32_FLIP_TOL`` where the step's
    new bf16 cache values rounded apart, each widened to ``2 u``; jamba's
    bf16 prefill and decode against JAX run op by op (jitted, XLA rounds
    its Mamba conv tails elsewhere: conv_B 0.1395 from the port, against
    a bound of 0.1277).  A cross block's ``ek``/``ev`` are read, never
    written."""
    over = dict(over or {})
    cfg = replace(get_config(arch), **over)
    _, jprefill32, jdecode32 = _jax_fns(arch, **over)
    jprefill, jdecode = jprefill32, jdecode32
    if dtype == "bf16" and cfg.moe is not None:
        jprefill, jdecode = (_eager(f.__wrapped__)
                             for f in (jprefill32, jdecode32))
    jp = _jax_params(arch, dtype, **over)
    jp32 = _jax_params(arch, "f32", **over)
    params = P.from_numpy(_np(jp))
    jb, tb = _batch(arch, seed, dtype)
    jb32 = _batch(arch, seed)[0]
    S = SHAPES[arch][0] + (SHAPES[arch][1] if cfg.embed_frontend == "patch"
                           else 0)
    n = jnp.full((2,), S, jnp.int32)
    jl, jcache, jlen = jprefill(jp, jb, n)
    tl, tcache, tlen = R.prefill(cfg, params, tb, MAX_LEN,
                                 lengths=torch.from_numpy(np.array(n)))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    j32, jcache32, _ = jprefill32(jp32, jb32, n)
    if dtype == "bf16":
        assert _rel(tl, jl) <= _bf16_tol(jl, j32)
        _cache_close(tcache, jcache, jcache32)
    else:
        assert _rel(tl, jl) <= _f32_tol(jprefill32, jp32, jl, jb32, n)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl.argmax(-1)))
        _cache_close(tcache, jcache)
    if cfg.enc_dec:
        assert tcache["pos0"]["ek"].shape == (
            cfg.n_groups, 2, SHAPES[arch][1], cfg.num_kv_heads,
            cfg.resolved_head_dim)
    tok, pos = j32.argmax(-1).astype(jnp.int32), jlen
    for _ in range(DECODE_STEPS):
        tcache = P.from_numpy(_np(jcache))
        before = {k: (v["ek"].clone(), v["ev"].clone())
                  for k, v in tcache.items() if "ek" in v}
        jcache_in = jcache
        jl, jcache = jdecode(jp, jcache, tok, pos)
        jcache = _spec_dtypes(jcache)
        tl, tcache = R.decode_step(cfg, params, tcache,
                                   torch.from_numpy(np.array(tok)),
                                   torch.from_numpy(np.array(pos)))
        if dtype == "bf16":
            j32, jcache32 = jdecode32(jp32, jcache32, tok, pos)
            jcache32 = _spec_dtypes(jcache32)
            assert _rel(tl, jl) <= _bf16_tol(jl, j32)
            _cache_close(tcache, jcache, jcache32)
        else:
            j32 = jl
            same = _cache_close(tcache, jcache)
            assert _rel(tl, jl) <= _f32_tol(
                jdecode32, jp32, jl, jcache_in, tok, pos,
                floor=F32_TOL if same else F32_FLIP_TOL)
            np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                          np.asarray(jl.argmax(-1)))
        for k, (ek, ev) in before.items():
            assert torch.equal(tcache[k]["ek"], ek)
            assert torch.equal(tcache[k]["ev"], ev)
        tok, pos = j32.argmax(-1).astype(jnp.int32), pos + 1
    return cfg


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_jax(arch, dtype):
    _run_prefill_decode(arch, dtype)


def test_unequal_encoder_and_decoder_group_counts():
    """whisper-smoke with 3 encoder groups and 2 decoder groups: the
    encoder runs its own stack's count, and every decoder group's cross
    attention reads the encoder's output."""
    cfg = _run_prefill_decode(ARCHS[1], "f32",
                              over=(("num_encoder_layers", 3),))
    assert (cfg.num_encoder_layers, cfg.n_groups) == (3, 2)


@pytest.mark.parametrize("pattern", [(ATTN, ENC_ATTN), (ENC_ATTN,)])
def test_enc_attn_in_a_decoder_pattern_matches_jax(pattern):
    """JAX builds an ``ENC_ATTN`` position of a decoder pattern as
    bidirectional attention at prefill (its decode reads the cache as
    ``ATTN`` does): the port builds the same tree and computes the same
    logits and caches."""
    arch = "phi3-mini-3.8b-smoke"
    over = dict(pattern=pattern, num_layers=2 * len(pattern))
    cfg = replace(get_config(arch), **over)
    jcfg = replace(jax_config(arch), **over)
    assert _spec_tree(R.model_specs(cfg), lambda s: isinstance(s, P.Spec)) \
        == _spec_tree(JR.model_specs(jcfg), JP.is_spec)
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        JR.init_params(jcfg, jax.random.PRNGKey(0)))
    params = P.from_numpy(_np(jp))
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (2, 12)).astype(np.int32)
    want = JR.lm_logits(jcfg, jp, {"tokens": jnp.asarray(toks)}, impl="ref")
    got = R.lm_logits(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert _rel(got, want) <= F32_TOL
    # bidirectional: the first position sees the last token
    toks2 = toks.copy()
    toks2[:, -1] = (toks2[:, -1] + 1) % cfg.vocab_size
    moved = R.lm_logits(cfg, params, {"tokens": torch.from_numpy(toks2)})
    assert (moved[:, 0] != got[:, 0]).any()
    jl, jcache, jlen = JR.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                  32, impl="ref")
    tl, tcache, tlen = R.prefill(cfg, params,
                                 {"tokens": torch.from_numpy(toks)}, 32)
    assert _rel(tl, jl) <= F32_TOL
    _cache_close(tcache, jcache)
    tok = jl.argmax(-1).astype(jnp.int32)
    jl, _ = JR.decode_step(jcfg, jp, jcache, tok, jlen, impl="ref")
    tl, _ = R.decode_step(cfg, params, tcache, torch.from_numpy(
        np.array(tok)), torch.from_numpy(np.array(jlen)))
    assert _rel(tl, jl) <= F32_TOL


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _jax_engine_greedy(arch, jparams, prompt, n_new: int) -> list:
    """Greedy decode as the JAX engine runs one request: the prompt
    right-padded to its bucket (exact length for a model with Mamba
    layers), prefilled with its length, then one decode step a token.
    A batch row's experts are routed alone, so a slot of the engine's
    batch decodes as this batch of one."""
    jcfg = jax_config(arch)
    L = len(prompt)
    width = L if MAMBA in jcfg.resolved_pattern \
        else min(jax_bucket(L), MAX_LEN)
    row = np.zeros((1, width), np.int32)
    row[0, :L] = prompt
    _, prefill, decode = _jax_fns(arch)
    logits, cache, pos = prefill(jparams, {"tokens": jnp.asarray(row)},
                                 jnp.array([L], jnp.int32))
    out = [int(jnp.argmax(logits[0]))]
    while len(out) < n_new:
        logits, cache = decode(jparams, cache,
                               jnp.array([out[-1]], jnp.int32), pos)
        pos = pos + 1
        out.append(int(jnp.argmax(logits[0])))
    return out


@pytest.mark.parametrize("arch", [ARCHS[0], ARCHS[2]])
def test_engine_greedy_matches_jax_prefill_decode(arch):
    """Three ragged prompts on two slots, f32 parameters: the third waits
    for a slot and is prefilled into a reused one; every request's tokens
    equal JAX's prefill/decode greedy.  Jamba's prompts of 40 cross its
    smoke chunk of 32 (exact-length prefill); llava's are bucketed,
    without an image prefix, as JAX's engine serves them."""
    cfg = get_config(arch)
    jparams = _jax_params(arch, "f32")
    params = _port_params(arch, "f32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (40, 9, 40)]
    eng = InferenceEngine(cfg, params, max_batch=2, max_len=MAX_LEN)
    assert eng._exact_prefill == (arch == ARCHS[0])
    for i, p in enumerate(prompts):
        eng.submit(p, 6, i)
    done = {c.req_id: c for c in eng.run_until_idle()}
    assert sorted(done) == [0, 1, 2] and eng.prefill_count == 3
    for i, p in enumerate(prompts):
        assert done[i].tokens == _jax_engine_greedy(arch, jparams, p, 6), i


def test_engine_refuses_whisper_as_the_reference_fails():
    """The port's engine refuses an encoder-decoder model at once; the
    reference's engine fails at its first admission, whose prefill has no
    frames for the encoder."""
    cfg = get_config(ARCHS[1])
    with pytest.raises(ValueError, match="encoder-decoder model"):
        InferenceEngine(cfg, _port_params(ARCHS[1], "f32"), max_batch=2,
                        max_len=MAX_LEN)
    with pytest.raises(KeyError, match="frames"):
        jax_warmed(jax_config(ARCHS[1]), _jax_params(ARCHS[1], "f32"),
                   max_batch=2, prompt_len=8, max_new_tokens=2)


@pytest.mark.parametrize("arch", FULL)
def test_batched_service_from_arch_builds(arch):
    """``BatchedService.from_arch``: a decode step streams the active
    bf16 parameters over 8 cards at 3.35 TB/s, 2 FLOPs a parameter a
    token at 989 TFLOP/s; the ``batched-serving`` scenario builds on
    it."""
    n = FULL_COUNTS[arch][1]
    svc = BatchedService.from_arch(arch)
    assert svc.name == f"batched:{arch}"
    assert svc.t_memory == 2.0 * n / (8 * 3.35e12)
    assert svc.t_compute_per_seq == 2.0 * n / (8 * 989e12)
    assert tsc.get("batched-serving", arch=arch).service_model == svc


def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_launch_serve_llava_smoke_on_cpu():
    out = _run("repro_torch.launch.serve", "--arch", LLAVA, "--smoke",
               "--device", "cpu", "--duration", "2", "--qps", "6",
               "--prompt-len", "24")
    assert out.returncode == 0, out.stderr[-2000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("serve: ")]
    rep = json.loads(line[-1][len("serve: "):])
    assert rep["n"] == rep["submitted"] > 0 and rep["dropped"] == 0
    assert rep["decode_steps"] > 0 and rep["tokens"] >= 4 * rep["n"]
    for key in ("p50_ms", "p99_ms", "ttft_p50_ms", "decode_step_ms",
                "tokens_per_s"):
        assert math.isfinite(rep[key]) and rep[key] > 0, key
