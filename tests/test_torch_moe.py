"""The port's MoE layers on the CPU against the JAX package:
``repro_torch.models.moe`` (router, capacity-bounded dispatch, the dense
oracle, shared experts, int8 expert banks, the auxiliary loss) and the
two MoE models, deepseek-moe-16b (64 routed experts of d_ff 1408, top-6,
2 shared; its smoke form 4 experts, top-2, 1 shared) and mixtral-8x22b
(8 experts, top-2, sliding-window attention; smoke window 16).

JAX's own parameters for each ``-smoke`` config are carried across with
``param.from_numpy``; layer inputs and token batches are drawn with
numpy from a seed.  The JAX side runs ``repro.models`` with
``impl="ref"``, the path the JAX engine takes off the TPU.

Tolerances, relative to the largest magnitude of the reference's output:

* ``_router``: indices equal, weights and probabilities within 1e-6 (an
  f32 softmax computed in another order); ties rank the lower index
  first, as ``jax.lax.top_k``.
* ``apply_moe`` on one layer: f32 within 1e-5 (f32 products summed in
  another order), bf16 within 2e-2 (every product rounds to bf16 in
  both frameworks, at their own places: 2.5 bf16 steps).  The dispatch
  form's keep mask, which assignments the capacity drops, is equal.
* whole smoke models through ``prefill`` and ``decode_step`` (greedy
  decode and the full forward differ by design for MoE: the capacity
  depends on the length a model is called with): f32 within 1e-4 with
  greedy tokens equal, bf16 within ``max(2e-2, 2 g)`` where ``g`` is
  the JAX package's own bf16 gap on the same tokens (its bf16 logits
  against its f32 logits), as in ``tests/test_torch_dense_variants.py``.
* the auxiliary loss within 1e-6; parameter counts equal.
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
from repro.models import moe as JM  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.serving.engine import _bucket as jax_bucket  # noqa: E402

from repro_torch import scenarios as tsc  # noqa: E402
from repro_torch.configs.base import ATTN_SWA, get_config  # noqa: E402
from repro_torch.core.profiles import BatchedService  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FULL = ("deepseek-moe-16b", "mixtral-8x22b")
ARCHS = tuple(a + "-smoke" for a in FULL)
DEEPSEEK, MIXTRAL = ARCHS
#: the reference's parameter counts at full width (JR.count_params):
#: total, active
FULL_COUNTS = {"deepseek-moe-16b": (16_879_568_896, 2_830_747_648),
               "mixtral-8x22b": (140_630_071_296, 39_161_468_928)}
ROUTER_TOL = 1e-6
MOE_TOL = {"f32": 1e-5, "bf16": 2e-2}
F32_TOL = 1e-4
BF16_FLOOR = 2e-2
MAX_LEN = 64
DECODE_STEPS = 10


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


def _layer(arch: str, dtype: str, seed: int = 0, **moe_kw):
    """(port cfg, JAX cfg, JAX MoE params) for one layer of ``arch``:
    numpy draws at the spec's shapes, the router in f32, the other
    leaves in ``dtype``."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    if moe_kw:
        cfg = replace(cfg, moe=replace(cfg.moe, **moe_kw))
        jcfg = replace(jcfg, moe=replace(jcfg.moe, **moe_kw))
    rng = np.random.default_rng(seed)
    jp = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32)
                              / math.sqrt(s.shape[-2] if len(s.shape) > 1
                                          else 1)),
        JM.moe_specs(jcfg), is_leaf=lambda s: hasattr(s, "axes"))
    jp = {k: (v if k == "router" else
              jax.tree_util.tree_map(lambda a: a.astype(_jdt(dtype)), v))
          for k, v in jp.items()}
    return cfg, jcfg, jp


def _x(cfg, dtype: str, shape, seed: int = 1):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)).astype(_jdt(dtype))


def _jax_keep(jcfg, idx, s: int) -> np.ndarray:
    """The reference's keep mask, per (b, s, k) assignment: the lines of
    ``repro.models.moe.apply_moe`` that place each assignment in its
    expert's queue."""
    moe = jcfg.moe
    e = moe.num_experts
    b = idx.shape[0]
    cap = max(1, int(moe.top_k * s * moe.capacity_factor / e))
    sel = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    pos = jnp.cumsum(sel.reshape(b, s * moe.top_k, e), axis=1)
    pos = pos.reshape(b, s, moe.top_k, e) - 1
    keep = (pos < cap) & (sel > 0)
    return np.asarray(keep.any(-1))


# ---------------------------------------------------------------------------
# Configs, counts, parameter trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FULL)
def test_smoke_reduction_of_the_moe_configs(arch):
    """``smoke()``: 4 experts, top-2, at most 1 shared expert, expert
    d_ff 64 where the full config sets one (the field comparison with
    the reference is ``tests/test_torch_models.py``'s)."""
    assert asdict(get_config(arch + "-smoke").moe) == \
        asdict(jax_config(arch + "-smoke").moe)
    smoke = get_config(arch + "-smoke").moe
    assert (smoke.num_experts, smoke.top_k) == (4, 2)
    assert smoke.num_shared_experts == (1 if arch == FULL[0] else 0)
    assert smoke.expert_d_ff == (64 if arch == FULL[0] else None)


@pytest.mark.parametrize("arch", FULL)
def test_count_params_total_and_active(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    total, active = FULL_COUNTS[arch]
    assert R.count_params(cfg) == JR.count_params(jcfg) == total
    assert R.count_params(cfg, active=True) == \
        JR.count_params(jcfg, active=True) == active


def test_count_params_w8_experts(monkeypatch):
    """The int8 banks' ``*_scale`` leaves are counted whole."""
    monkeypatch.setenv("REPRO_OPTS", "w8_experts")
    for arch in FULL:
        cfg, jcfg = get_config(arch), jax_config(arch)
        for active in (False, True):
            assert R.count_params(cfg, active=active) == \
                JR.count_params(jcfg, active=active)
        assert R.count_params(cfg) == FULL_COUNTS[arch][0] + \
            3 * cfg.moe.num_experts * cfg.num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_from_numpy_keeps_the_tree(arch):
    """The port's spec tree is JAX's parameter tree: keys, shapes and
    dtypes (router f32, expert banks bf16 in a bf16 model)."""
    jparams = _jax_params(arch, "bf16")
    port = P.from_numpy(_np(jparams))
    specs = R.model_specs(get_config(arch))
    flat = dict(P.leaves(port))
    assert set(flat) == {p for p, _ in P.leaves(specs)}
    for path, s in P.leaves(specs):
        assert tuple(flat[path].shape) == s.shape, path
        assert flat[path].dtype == s.dtype, path
    moe = port["groups"]["pos0"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wi_0"].dtype == moe["wo"].dtype == torch.bfloat16
    assert ("shared" in moe) == (arch == DEEPSEEK)
    assert "mlp" not in port["groups"]["pos0"]


def test_init_tree_scales_in_place_bit_equal():
    """``init_tree`` scales each f32 draw in place: the same draws and
    the same weights as scaling into a new tensor."""
    specs = R.model_specs(get_config(DEEPSEEK))
    got = dict(P.leaves(P.init_tree(specs, torch.Generator().manual_seed(5))))
    g = torch.Generator().manual_seed(5)
    for path, s in P.leaves(specs):
        t = got[path]
        if s.init != "normal":
            continue
        std = s.scale if s.scale is not None else 1.0 / math.sqrt(s.shape[0])
        x = torch.randn(s.shape, generator=g, dtype=torch.float32)
        assert torch.equal(t, (x * std).to(s.dtype)), path


# ---------------------------------------------------------------------------
# The router
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_router_matches_jax(arch, dtype):
    cfg, jcfg, jp = _layer(arch, dtype)
    x = _x(cfg, dtype, (3, 17))
    jidx, jw, jprobs = JM._router(jcfg, jp, x)
    idx, w, probs = M._router(cfg, P.from_numpy(_np(jp)),
                              P.from_numpy(_np(x)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert w.dtype == probs.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ROUTER_TOL,
                               rtol=0)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                               atol=ROUTER_TOL, rtol=0)


def test_router_ties_rank_the_lower_index_first():
    """A zero router gives every expert the same probability: the top-2
    are experts 0 and 1 for every token, as ``lax.top_k`` gives.  Equal
    router columns tie experts 1, 2, 3 and 5 at the top: top-3 is
    [1, 2, 3] (``torch.topk`` gives another order on such ties)."""
    cfg, jcfg, jp = _layer(DEEPSEEK, "f32")
    x = _x(cfg, "f32", (2, 9))
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    jidx, _, _ = JM._router(jcfg, jp, x)
    idx, w, _ = M._router(cfg, P.from_numpy(_np(jp)), P.from_numpy(_np(x)))
    assert (idx.numpy() == [0, 1]).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (w.numpy() == 0.5).all()
    e = 6
    cfg6 = replace(cfg, moe=replace(cfg.moe, num_experts=e, top_k=3))
    jcfg6 = replace(jcfg, moe=replace(jcfg.moe, num_experts=e, top_k=3))
    col = np.abs(np.random.default_rng(2).standard_normal(cfg.d_model))
    router = np.zeros((cfg.d_model, e), np.float32)
    for j, c in zip(range(e), (0.1, 0.3, 0.3, 0.3, 0.0, 0.3)):
        router[:, j] = c * col
    xs = jnp.ones((1, 4, cfg.d_model), jnp.float32)
    jidx, _, _ = JM._router(jcfg6, {"router": jnp.asarray(router)}, xs)
    idx, _, _ = M._router(cfg6, {"router": torch.from_numpy(router)},
                          torch.ones((1, 4, cfg.d_model)))
    assert (np.asarray(jidx) == [1, 2, 3]).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


# ---------------------------------------------------------------------------
# apply_moe on one layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["dispatch", "dense"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("squeezed", [False, True])
def test_apply_moe_matches_jax(arch, impl, dtype, squeezed):
    cfg, jcfg, jp = _layer(arch, dtype)
    x = _x(cfg, dtype, (3,) if squeezed else (3, 20))
    want = JM.apply_moe(jcfg, jp, x, impl=impl)
    got = M.apply_moe(cfg, P.from_numpy(_np(jp)), P.from_numpy(_np(x)),
                      impl=impl)
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    assert _rel(got, want) <= MOE_TOL[dtype]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dispatch_drops_the_reference_assignments(arch, dtype):
    """A router biased towards expert 0 overfills its queue: the port
    drops the reference's (token, k) assignments, row by row (row 1
    repeats row 0's tokens, so its queues must drop the same ones), and
    its output under the drops matches."""
    cfg, jcfg, jp = _layer(arch, dtype, seed=3)
    rng = np.random.default_rng(4)
    bias = np.zeros((cfg.d_model, cfg.moe.num_experts), np.float32)
    bias[:, 0] = 0.5 / math.sqrt(cfg.d_model)
    jp = dict(jp, router=jp["router"] + jnp.asarray(bias))
    x0 = np.abs(rng.standard_normal((1, 24, cfg.d_model))).astype(np.float32)
    x = jnp.asarray(np.concatenate([x0, x0, -x0])).astype(_jdt(dtype))
    jidx, _, _ = JM._router(jcfg, jp, x)
    want_keep = _jax_keep(jcfg, jidx, 24)
    p = P.from_numpy(_np(jp))
    idx, _, _ = M._router(cfg, p, P.from_numpy(_np(x)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _, keep = M._queue_slots(idx, cfg.moe.num_experts,
                             M._capacity(cfg, 24))
    keep = keep.reshape(want_keep.shape).numpy()
    np.testing.assert_array_equal(keep, want_keep)
    assert (~keep[0]).sum() > 0 and (keep[0] == keep[1]).all()
    # one queue over the batch's 3 x 24 tokens would drop others
    _, one_queue = M._queue_slots(idx.reshape(1, -1, cfg.moe.top_k),
                                  cfg.moe.num_experts, M._capacity(cfg, 24))
    assert (one_queue.reshape(keep.shape).numpy() != keep).any()
    want = JM.apply_moe(jcfg, jp, x, impl="dispatch")
    got = M.apply_moe(cfg, p, P.from_numpy(_np(x)), impl="dispatch")
    assert _rel(got, want) <= MOE_TOL[dtype]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dispatch_matches_dense_generous_capacity(dtype):
    """Capacity factor 8: nothing is dropped, so the two forms agree
    (``tests/test_models.py``'s check, at its tolerance in bf16, where
    ``dispatch`` rounds its combine weights to bf16; to 1e-5 in f32)."""
    cfg = get_config(DEEPSEEK)
    cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=8.0))
    params = _port_params(DEEPSEEK, dtype)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    a = R.lm_logits(cfg, params, {"tokens": toks}, moe_impl="dispatch")
    b = R.lm_logits(cfg, params, {"tokens": toks}, moe_impl="dense")
    if dtype == "f32":
        assert _rel(a, b) <= 1e-5
    else:
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_shared_experts_match_jax(dtype):
    """deepseek's two shared experts (one MLP 2 x 64 wide at the smoke
    width), beside the routed path and alone (routed banks zeroed)."""
    cfg, jcfg, jp = _layer(DEEPSEEK, dtype, seed=5, num_shared_experts=2)
    assert jp["shared"]["wi_0"].shape == (cfg.d_model, 128)
    x = _x(cfg, dtype, (2, 12))
    for params in (jp, dict(jp, **{k: jnp.zeros_like(jp[k])
                                   for k in ("wi_0", "wi_1", "wo")})):
        want = JM.apply_moe(jcfg, params, x)
        got = M.apply_moe(cfg, P.from_numpy(_np(params)),
                          P.from_numpy(_np(x)))
        assert _rel(got, want) <= MOE_TOL[dtype]


def test_w8_experts_match_jax(monkeypatch):
    """``REPRO_OPTS=w8_experts``: int8 banks with per-expert f32 scales,
    drawn with numpy; ``_dq`` is bit-equal, ``apply_moe`` within the
    bf16 tolerance."""
    monkeypatch.setenv("REPRO_OPTS", "w8_experts")
    cfg, jcfg = get_config(DEEPSEEK), jax_config(DEEPSEEK)
    specs = M.moe_specs(cfg)
    assert specs["wi_0"].dtype == torch.int8
    assert specs["wo_scale"].shape == (cfg.moe.num_experts,)
    jspecs = JM.moe_specs(jcfg)
    assert set(specs) == set(jspecs)
    rng = np.random.default_rng(8)
    jp = {"router": jnp.asarray(rng.standard_normal(
        specs["router"].shape).astype(np.float32) / 8)}
    for name in ("wi_0", "wi_1", "wo"):
        jp[name] = jnp.asarray(rng.integers(-127, 128, specs[name].shape,
                                            dtype=np.int8))
        jp[name + "_scale"] = jnp.asarray(rng.uniform(
            0.01, 0.2, specs[name + "_scale"].shape).astype(np.float32))
    jp["shared"] = {k: jnp.asarray(rng.standard_normal(s.shape).astype(
        np.float32) / 8).astype(jnp.bfloat16)
        for k, s in jspecs["shared"].items()}
    p = P.from_numpy(_np(jp))
    assert p["wi_0"].dtype == torch.int8
    for name in ("wi_0", "wi_1", "wo"):
        want = JM._dq(jp, name)
        got = M._dq(p, name)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(got), _f32(want))
    x = _x(cfg, "bf16", (2, 16))
    for impl in ("dispatch", "dense"):
        want = JM.apply_moe(jcfg, jp, x, impl=impl)
        got = M.apply_moe(cfg, p, P.from_numpy(_np(x)), impl=impl)
        assert _rel(got, want) <= MOE_TOL["bf16"]


def test_aux_load_balance_loss_matches_jax():
    cfg, jcfg, jp = _layer(DEEPSEEK, "f32")
    x = _x(cfg, "f32", (3, 21))
    jidx, _, jprobs = JM._router(jcfg, jp, x)
    want = JM.aux_load_balance_loss(jcfg, jprobs, jidx)
    idx, _, probs = M._router(cfg, P.from_numpy(_np(jp)),
                              P.from_numpy(_np(x)))
    got = M.aux_load_balance_loss(cfg, probs, idx)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - float(want)) <= ROUTER_TOL


def test_unknown_moe_impl_raises():
    cfg, _, jp = _layer(DEEPSEEK, "f32")
    with pytest.raises(ValueError, match="moe impl"):
        M.apply_moe(cfg, P.from_numpy(_np(jp)),
                    torch.zeros((1, 2, cfg.d_model)), impl="sparse")


# ---------------------------------------------------------------------------
# Whole models: prefill + decode
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_fns(arch: str):
    """Jitted (prefill at ``MAX_LEN`` with lengths, decode step)."""
    jcfg = jax_config(arch)
    prefill = jax.jit(lambda p, t, n: JR.prefill(
        jcfg, p, {"tokens": t}, MAX_LEN, impl="ref", lengths=n))
    decode = jax.jit(lambda p, c, t, pos: JR.decode_step(jcfg, p, c, t, pos,
                                                         impl="ref"))
    return prefill, decode


def _eager(fn):
    """``fn`` run op by op (``jax.disable_jit``): every bf16 operation
    rounds where the JAX package's source says, where XLA's fusions in a
    jitted function may keep a value in f32."""
    def run(*args):
        with jax.disable_jit():
            return fn(*args)
    return run


CASES = [(a, s, d) for a, s in ((DEEPSEEK, 20), (MIXTRAL, 24), (MIXTRAL, 9))
         for d in ("f32", "bf16")]


@pytest.mark.parametrize("arch,S,dtype", CASES)
def test_prefill_and_decode_match_reference(arch, S, dtype):
    """A batch of 2 prompts of ``S`` tokens prefilled together, then
    ``DECODE_STEPS`` decode steps fed JAX's f32 greedy tokens.  Before
    every step the port's cache is reset to JAX's (the caches are bf16 on
    both sides; a K/V value on a rounding boundary can round apart and
    such flips pile up), so each step is held alone.  mixtral-smoke's
    window is 16: at S = 24 the prefill fills the ring and every decode
    step writes past its wrap, with the MoE layer behind it.

    bf16 is held against the JAX package run op by op (``_eager``): its
    jitted form rounds elsewhere, and a router whose 2nd and 3rd
    probabilities lie 5.7e-7 apart (mixtral-smoke, S = 9, step 6, layer
    0) picks another expert there: 7.2e-2 from the port, which equals the
    op-by-op reference bit for bit on that step."""
    cfg = get_config(arch)
    jprefill32, jdecode32 = _jax_fns(arch)
    if dtype == "bf16":
        jprefill, jdecode = (_eager(f.__wrapped__)
                             for f in (jprefill32, jdecode32))
    else:
        jprefill, jdecode = jprefill32, jdecode32
    jp, params = _jax_params(arch, dtype), _port_params(arch, dtype)
    jp32 = _jax_params(arch, "f32")
    toks = np.random.default_rng(S).integers(0, cfg.vocab_size,
                                             (2, S)).astype(np.int32)
    n = jnp.full((2,), S, jnp.int32)
    jl, jcache, jlen = jprefill(jp, jnp.asarray(toks), n)
    tl, tcache, tlen = R.prefill(cfg, params,
                                 {"tokens": torch.from_numpy(toks)}, MAX_LEN,
                                 lengths=torch.from_numpy(np.array(n)))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    j32, jcache32, _ = jprefill32(jp32, jnp.asarray(toks), n)
    if dtype == "bf16":      # JAX's own bf16 error, on the same tokens
        assert _rel(tl, jl) <= _bf16_tol(jl, j32)
    else:
        assert _rel(tl, jl) <= F32_TOL
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl.argmax(-1)))
    if arch == MIXTRAL:
        assert tcache["pos0"]["pos"].shape[-1] == 16
    tok, pos = j32.argmax(-1).astype(jnp.int32), jlen
    for _ in range(DECODE_STEPS):
        tcache = P.from_numpy(_np(jcache))
        jl, jcache = jdecode(jp, jcache, tok, pos)
        tl, tcache = R.decode_step(cfg, params, tcache,
                                   torch.from_numpy(np.array(tok)),
                                   torch.from_numpy(np.array(pos)))
        if dtype == "bf16":
            j32, jcache32 = jdecode32(jp32, jcache32, tok, pos)
            assert _rel(tl, jl) <= _bf16_tol(jl, j32)
        else:
            j32 = jl
            assert _rel(tl, jl) <= F32_TOL
            np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                          np.asarray(jl.argmax(-1)))
        for name in tcache:
            np.testing.assert_array_equal(tcache[name]["pos"].numpy(),
                                          np.asarray(jcache[name]["pos"]))
        tok, pos = j32.argmax(-1).astype(jnp.int32), pos + 1


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _jax_engine_greedy(arch, jparams, prompt, n_new: int,
                       max_len: int) -> list:
    """Greedy decode as the JAX engine runs one request: the prompt
    right-padded to its bucket (exact length for a model with
    sliding-window layers), prefilled with its length, then one decode
    step a token.  A batch row's experts are routed alone (each row has
    capacity queues of its own; one token a row at decode), so a slot
    of the engine's batch decodes as this batch of one."""
    jcfg = jax_config(arch)
    L = len(prompt)
    swa = ATTN_SWA in jcfg.resolved_pattern
    width = L if swa else min(jax_bucket(L), max_len)
    row = np.zeros((1, width), np.int32)
    row[0, :L] = prompt
    logits, cache, pos = JR.prefill(jcfg, jparams, {"tokens": jnp.asarray(
        row)}, max_len, impl="ref", lengths=jnp.array([L], jnp.int32))
    out = [int(jnp.argmax(logits[0]))]
    decode = _jax_fns(arch)[1] if max_len == MAX_LEN else jax.jit(
        lambda p, c, t, q: JR.decode_step(jcfg, p, c, t, q, impl="ref"))
    while len(out) < n_new:
        logits, cache = decode(jparams, cache,
                               jnp.array([out[-1]], jnp.int32), pos)
        pos = pos + 1
        out.append(int(jnp.argmax(logits[0])))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_jax_prefill_decode(arch):
    """Three ragged prompts on two slots, f32 parameters: the third waits
    for a slot and is prefilled into a reused one; every request's tokens
    equal JAX's prefill/decode greedy (for mixtral two prompts are past
    its window of 16, and the short one decodes past the ring's wrap)."""
    cfg = get_config(arch)
    jparams = _jax_params(arch, "f32")
    params = _port_params(arch, "f32")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (24, 9, 37)]
    eng = InferenceEngine(cfg, params, max_batch=2, max_len=MAX_LEN)
    for i, p in enumerate(prompts):
        eng.submit(p, 10, i)
    done = {c.req_id: c for c in eng.run_until_idle()}
    assert sorted(done) == [0, 1, 2] and eng.prefill_count == 3
    for i, p in enumerate(prompts):
        assert done[i].tokens == _jax_engine_greedy(arch, jparams, p, 10,
                                                    MAX_LEN), i


def test_engine_buckets_deepseek_and_prefills_mixtral_exactly(monkeypatch):
    """deepseek (full attention) pads a 21-token prompt to the 32 bucket,
    the pads routed like tokens, as the JAX engine does; mixtral (sliding
    window) prefills it at its exact length."""
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
        assert eng._exact_prefill == (arch == MIXTRAL)
        eng.submit(np.arange(21) % cfg.vocab_size, 3, 0)
        eng.run_until_idle()
        assert seen[-1] == (arch, (1, 21 if arch == MIXTRAL else 32))


def test_batched_service_from_arch_counts_active_parameters():
    """``BatchedService.from_arch`` on an MoE arch: a decode step streams
    the active bf16 parameters (``count_params(active=True)``, JAX's
    count) over 8 cards at 3.35 TB/s; 2 FLOPs a parameter a token at
    989 TFLOP/s; the ``batched-serving`` scenario builds on it."""
    arch = FULL[0]
    n = R.count_params(get_config(arch), active=True)
    assert n == JR.count_params(jax_config(arch), active=True)
    svc = BatchedService.from_arch(arch)
    assert svc.name == f"batched:{arch}"
    assert svc.t_memory == 2.0 * n / (8 * 3.35e12)
    assert svc.t_compute_per_seq == svc.t_prefill_per_token == \
        2.0 * n / (8 * 989e12)
    assert tsc.get("batched-serving", arch=arch).service_model == svc


def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


@pytest.mark.parametrize("arch,prompt", [("deepseek-moe-16b", "24"),
                                         ("mixtral-8x22b", "40")])
def test_launch_serve_moe_smoke_on_cpu(arch, prompt):
    """mixtral's 40-token prompts are past its smoke window of 16."""
    out = _run("repro_torch.launch.serve", "--arch", arch, "--smoke",
               "--device", "cpu", "--duration", "2", "--qps", "6",
               "--prompt-len", prompt)
    line = [ln for ln in out.splitlines() if ln.startswith("serve: ")]
    rep = json.loads(line[-1][len("serve: "):])
    assert rep["n"] == rep["submitted"] > 0 and rep["dropped"] == 0
    assert rep["decode_steps"] > 0 and rep["tokens"] >= 4 * rep["n"]
    for key in ("p50_ms", "p99_ms", "ttft_p50_ms", "decode_step_ms",
                "tokens_per_s"):
        assert math.isfinite(rep[key]) and rep[key] > 0, key
