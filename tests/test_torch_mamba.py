"""The port's Mamba-2 model and its serving on the CPU against the JAX
package.

JAX's own parameters for ``mamba2-1.3b-smoke`` (``repro.models.registry
.init_params``) are carried across with ``param.from_numpy``, and the
same token batches go through ``repro.models.registry`` (``impl="ref"``,
the path the JAX engine takes off the TPU) and
``repro_torch.models.registry``.  The smoke form keeps the family
(2 layers, d_model 64, 8 heads of head_dim 16, d_state 16, chunk 32) and,
as every smoke config, a dense MLP after each mixer (d_ff 128).

Tolerances, relative to max|logit|:

* f32 parameters: 1e-4, greedy tokens identical.  Both run the same f32
  operations in another summation order (measured: <= 1.1e-6).  The
  decode caches are held to their spec dtypes on both sides: JAX's
  ``decode_mamba`` concatenates its bf16 conv cache with an f32 token and
  returns the f32 window as the new cache, where the port writes it back
  into its bf16 cache in place: the port follows the cache's spec dtype
  and so departs from JAX in f32.  The main test rounds JAX's returned
  cache to the spec dtypes after every step, so both decode from the
  same values; ``test_f32_decode_against_unrounded_jax_cache`` holds the
  port against JAX's unmodified decode, where the f32 logits part by up
  to 6.4e-3 from the second step on (six seeds): within 1e-2 there.
* bf16 parameters: 3e-2.  The JAX package's own ref and
  Pallas-interpret paths agree bit for bit on this model (gap 0: the
  SSD's f32 output is rounded to bf16 straight after, and their f32
  differences cross no rounding boundary here), so that gap cannot
  serve as the bound.  The port's first layer matches JAX's to ~1e-5
  (its conv caches bit for bit, see the cache test); from there on a
  bf16 product that oneDNN and XLA round to neighbouring values (~0.01 %
  of the projection outputs) propagates (the MLP's activation rounds
  each step as ``jax.nn.silu`` does, ``layers.silu``).  Measured
  over seeds 0-4 (prefill and three decode steps): at most 0.0164
  (0.0232 while the MLP used ``F.silu``), where JAX's own bf16 run
  differs from its f32 run by up to 0.0348 (six seeds): the port's gap
  is within bf16's own error on this model.
"""
from __future__ import annotations

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
from repro.models import registry as JR  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.serving.engine import InferenceEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mamba2-1.3b-smoke"
TOL = {"f32": 1e-4, "bf16": 3e-2}
LEAVES = ("h", "conv_x", "conv_B", "conv_C")


def _jax_params(dtype: str, seed: int = 0):
    params = JR.init_params(jax_config(ARCH), jax.random.PRNGKey(seed))
    if dtype == "f32":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        params)
    return params


def _port_params(jparams):
    return P.from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def _np32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got: torch.Tensor, want) -> float:
    want = _np32(want)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def test_config_and_count_are_the_reference_ones():
    for name in ("mamba2-1.3b", ARCH):
        port, ref = get_config(name), jax_config(name)
        for f in ("num_layers", "d_model", "d_ff", "vocab_size", "family",
                  "resolved_pattern", "tie_embeddings", "norm"):
            assert getattr(port, f) == getattr(ref, f), (name, f)
        assert asdict(port.mamba) == asdict(ref.mamba), name
    cfg = get_config("mamba2-1.3b")
    assert (cfg.mamba.d_inner(cfg.d_model), cfg.mamba.n_heads(cfg.d_model),
            cfg.mamba.head_dim, cfg.mamba.d_state, cfg.mamba.chunk) == \
        (4096, 64, 64, 128, 256)
    assert R.count_params(cfg) == JR.count_params(jax_config(
        "mamba2-1.3b")) == 1_446_714_368


def test_specs_init_and_from_numpy_cover_the_mamba_leaves():
    jparams = _jax_params("bf16")
    port = _port_params(jparams)
    specs = R.model_specs(get_config(ARCH))
    flat = dict(P.leaves(port))
    assert set(flat) == {p for p, _ in P.leaves(specs)}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = tuple(k.key for k in path)
        t = flat[keys]
        assert tuple(t.shape) == leaf.shape, keys
        np.testing.assert_array_equal(t.float().numpy(), _np32(leaf))
    m = R.init_params(get_config(ARCH),
                      torch.Generator().manual_seed(0))["groups"]["pos0"][
        "mamba"]
    for name, dtype in (("A_log", torch.float32), ("dt_bias", torch.float32),
                        ("D", torch.float32), ("conv_bx", torch.float32),
                        ("conv_x", torch.bfloat16), ("wz", torch.bfloat16)):
        assert m[name].dtype == dtype, name
    assert torch.equal(m["A_log"], torch.full_like(m["A_log"], 1.386))
    assert torch.equal(m["dt_bias"], torch.full_like(m["dt_bias"], -4.6))
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    for name in ("conv_bx", "conv_bB", "conv_bC"):
        assert not m[name].any(), name
    assert abs(m["conv_x"].float().std().item() - 0.2) < 0.02
    cache = P.init_tree(R.cache_specs(get_config(ARCH), 3, 40),
                        torch.Generator())
    assert cache["pos0"]["h"].dtype == torch.float32
    assert tuple(cache["pos0"]["h"].shape) == (2, 3, 8, 16, 16)
    assert cache["pos0"]["conv_x"].dtype == torch.bfloat16
    assert tuple(cache["pos0"]["conv_x"].shape) == (2, 3, 3, 128)


def _spec_dtypes(cache):
    """JAX's decode cache rounded to the spec dtypes (module doc)."""
    return {k: {leaf: (v.astype(jnp.bfloat16) if leaf.startswith("conv")
                       else v) for leaf, v in e.items()}
            for k, e in cache.items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(dtype):
    """A 45-token prompt (the scan pads it into a second chunk), then
    three greedy decode steps from the prefilled cache."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    jparams = _jax_params(dtype)
    params = _port_params(jparams)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 45)).astype(np.int32)
    jl, jcache, jlen = JR.prefill(jcfg, jparams,
                                  {"tokens": jnp.asarray(toks)}, 64,
                                  impl="ref")
    tl, tcache, tlen = R.prefill(cfg, params,
                                 {"tokens": torch.from_numpy(toks)}, 64)
    assert _rel(tl, jl) <= TOL[dtype]
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    if dtype == "f32":
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl.argmax(-1)))
    jtok, ttok = jl.argmax(-1).astype(jnp.int32), tl.argmax(-1).to(torch.int32)
    for _ in range(3):
        jl, jcache = JR.decode_step(jcfg, jparams, jcache, jtok, jlen,
                                    impl="ref")
        jcache = _spec_dtypes(jcache)
        tl, tcache = R.decode_step(cfg, params, tcache, ttok, tlen)
        assert _rel(tl, jl) <= TOL[dtype]
        jtok = jl.argmax(-1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        if dtype == "f32":
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlen, tlen = jlen + 1, tlen + 1
    for leaf in LEAVES:
        assert tcache["pos0"][leaf].dtype == \
            (torch.float32 if leaf == "h" else torch.bfloat16)
        # bf16: the state measured <= 0.028 (six seeds)
        assert _rel(tcache["pos0"][leaf], jcache["pos0"][leaf]) \
            <= (TOL[dtype] if dtype == "f32" else 6e-2), leaf


def test_f32_decode_against_unrounded_jax_cache():
    """The departure in f32 (module doc), measured against JAX's own
    decode: the prefill and the first decode step, whose conv window JAX
    still reads from its bf16 prefill cache, within ``TOL["f32"]``; the
    later steps, where JAX's window holds f32 tokens and the port's bf16
    ones, within 1e-2; greedy tokens identical throughout."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    jparams = _jax_params("f32")
    params = _port_params(jparams)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 45)).astype(np.int32)
    jl, jcache, jlen = JR.prefill(jcfg, jparams,
                                  {"tokens": jnp.asarray(toks)}, 64,
                                  impl="ref")
    tl, tcache, tlen = R.prefill(cfg, params,
                                 {"tokens": torch.from_numpy(toks)}, 64)
    assert _rel(tl, jl) <= TOL["f32"]
    jtok, ttok = jl.argmax(-1).astype(jnp.int32), tl.argmax(-1).to(torch.int32)
    for step in range(3):
        jl, jcache = JR.decode_step(jcfg, jparams, jcache, jtok, jlen,
                                    impl="ref")
        tl, tcache = R.decode_step(cfg, params, tcache, ttok, tlen)
        assert _rel(tl, jl) <= (TOL["f32"] if step == 0 else 1e-2), step
        jtok = jl.argmax(-1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jlen, tlen = jlen + 1, tlen + 1
    assert jcache["pos0"]["conv_x"].dtype == jnp.float32
    assert tcache["pos0"]["conv_x"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_cache_matches_jax_mamba_prefill_cache(dtype):
    """The cache the port takes from the layer's own scan against the one
    JAX builds by running the scan a second time
    (``transformer._mamba_prefill_cache``).  In f32 every state and
    every conv tail (the bf16 pre-activation projections) is within 1e-4
    of JAX's, relative to its largest entry (measured: states <= 1.1e-5
    over six seeds, tails bit-equal but for a near-zero entry that the
    f32 sum order moves across a bf16 step).  In bf16 the first layer,
    which sees the same input on both sides, is as close (state within
    1e-4, measured <= 8e-6; tails within one bf16 step of the largest
    entry, 2^-7, measured bit-equal); the second layer's input has
    passed one bf16 block: its state within 6e-2 (measured <= 0.038),
    its tails within 2e-2 (<= 0.0123)."""
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    jparams = _jax_params(dtype, seed=1)
    params = _port_params(jparams)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (1, 70)).astype(np.int32)
    _, jcache, _ = JR.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                              80, impl="ref")
    _, tcache, _ = R.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                             80)
    for leaf in LEAVES:
        got, want = tcache["pos0"][leaf], jcache["pos0"][leaf]
        assert tuple(got.shape) == want.shape, leaf
        if dtype == "f32":
            for g in (0, 1):
                assert _rel(got[g], want[g]) <= 1e-4, (leaf, g)
        elif leaf == "h":
            assert _rel(got[0], want[0]) <= 1e-4
            assert _rel(got[1], want[1]) <= 6e-2
        else:
            assert _rel(got[0], want[0]) <= 2.0 ** -7, leaf
            assert _rel(got[1], want[1]) <= 2e-2, leaf


def test_short_prompt_conv_tail_is_zero_padded():
    """A prompt shorter than d_conv - 1 leaves zero rows in front of its
    conv tail, the conv's own padding, and decodes on from it as the
    full prompt would (the same token fed one at a time)."""
    cfg = get_config(ARCH)
    params = _port_params(_jax_params("f32"))
    toks = torch.tensor([[5, 77]], dtype=torch.int32)
    logits, cache, pos = R.prefill(cfg, params, {"tokens": toks}, 16)
    assert not cache["pos0"]["conv_x"][:, 0, 0].any()
    l3, _ = R.decode_step(cfg, params, cache, torch.tensor([9],
                                                           dtype=torch.int32),
                          pos)
    full = R.lm_logits(cfg, params, {"tokens": torch.tensor(
        [[5, 77, 9]], dtype=torch.int32)})[:, -1]
    assert _rel(l3, full.numpy()) <= 1e-2      # bf16 conv cache vs f32


def _jax_greedy(jparams, prompt, n_new: int, width: int = 64) -> list:
    """Full-forward greedy decode without a cache, right-padded to
    ``width`` (the causal scan never carries a pad back to ``len - 1``)."""
    jcfg = jax_config(ARCH)
    fwd = jax.jit(lambda p, t: JR.lm_logits(jcfg, p, {"tokens": t},
                                            impl="ref"))
    toks = [int(t) for t in prompt]
    out = []
    for _ in range(n_new):
        row = np.zeros((1, width), np.int32)
        row[0, :len(toks)] = toks
        logits = fwd(jparams, jnp.asarray(row))[0, len(toks) - 1]
        out.append(int(jnp.argmax(logits)))
        toks.append(out[-1])
    return out


def test_engine_greedy_matches_jax_full_forward():
    """Three ragged prompts on two slots, the JAX package's bf16
    parameters: the third waits for a slot and is prefilled into a
    reused one; every request's tokens equal JAX's full-forward greedy
    (the counterpart of tests/test_serving.py's mamba2 case)."""
    cfg = get_config(ARCH)
    jparams = _jax_params("bf16")
    params = _port_params(jparams)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (24, 9, 37)]
    eng = InferenceEngine(cfg, params, max_batch=2, max_len=96)
    for i, p in enumerate(prompts):
        eng.submit(p, 6, i)
    done = {c.req_id: c for c in eng.run_until_idle()}
    assert sorted(done) == [0, 1, 2] and eng.prefill_count == 3
    for i, p in enumerate(prompts):
        assert done[i].tokens == _jax_greedy(jparams, p, 6), i


def test_engine_prefills_mamba_at_exact_length(monkeypatch):
    """No bucket for Mamba layers: the prompt goes in at its own length
    (a bucket's pad tokens would run through the scan into the state);
    phi3 still pads to its bucket."""
    seen = []
    real = R.prefill

    def spy(cfg, params, batch, max_len, **kw):
        seen.append((cfg.name, tuple(batch["tokens"].shape)))
        return real(cfg, params, batch, max_len, **kw)
    monkeypatch.setattr(R, "prefill", spy)
    for arch, want in ((ARCH, (1, 21)), ("phi3-mini-3.8b-smoke", (1, 32))):
        cfg = get_config(arch)
        params = R.init_params(cfg, torch.Generator().manual_seed(0))
        eng = InferenceEngine(cfg, params, max_batch=2, max_len=64)
        assert eng._exact_prefill == (arch == ARCH)
        eng.submit(np.arange(21) % cfg.vocab_size, 3, 0)
        eng.run_until_idle()
        assert seen[-1] == (arch, want)
    # the exact-length prefill is what the full forward sees
    cfg = get_config(ARCH)
    params = _port_params(_jax_params("f32"))
    eng = InferenceEngine(cfg, params, max_batch=1, max_len=64)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, 21)
    eng.submit(prompt, 1, 0)
    eng.run_until_idle()
    first = eng.completed[0].tokens[0]
    full = R.lm_logits(cfg, params, {"tokens": torch.from_numpy(
        prompt[None].astype(np.int32))})
    assert first == int(full[0, -1].argmax())


def test_not_ported_layer_kinds_still_raise():
    """An encoder layer beside Mamba in a pattern, with an MoE FFN or
    without, raised before the port had encoder layers: both now build
    JAX's parameter tree, keys and shapes."""
    from repro.configs.base import MoEConfig as JMoE

    from repro_torch.configs.base import MoEConfig
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    for over, jover in (
            (dict(pattern=("enc_attn", "mamba"),
                  moe=MoEConfig(num_experts=4, top_k=2), moe_positions=(0,)),
             dict(moe=JMoE(num_experts=4, top_k=2))),
            (dict(pattern=("mamba", "enc_attn")), {})):
        port = dict(P.leaves(R.model_specs(replace(cfg, **over))))
        flat = jax.tree_util.tree_flatten_with_path(
            JR.model_specs(replace(jcfg, **dict(over, **jover))),
            is_leaf=lambda s: hasattr(s, "axes"))[0]
        ref = {tuple(k.key for k in path): s for path, s in flat}
        assert set(port) == set(ref), over
        for path, s in port.items():
            assert s.shape == tuple(ref[path].shape), path


def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout


def test_launch_serve_mamba_smoke_on_cpu():
    out = _run("repro_torch.launch.serve", "--arch", "mamba2-1.3b",
               "--smoke", "--device", "cpu", "--duration", "2", "--qps", "6",
               "--prompt-len", "40")
    line = [ln for ln in out.splitlines() if ln.startswith("serve: ")]
    rep = json.loads(line[-1][len("serve: "):])
    assert rep["n"] == rep["submitted"] > 0 and rep["dropped"] == 0
    assert rep["decode_steps"] > 0 and rep["tokens"] >= 4 * rep["n"]
    for key in ("p50_ms", "p99_ms", "ttft_p50_ms", "decode_step_ms",
                "tokens_per_s"):
        assert math.isfinite(rep[key]) and rep[key] > 0, key


def test_scenarios_cli_engine_backend_mamba_on_cpu():
    from repro_torch.scenarios.__main__ import main
    assert main(["steady", "--backend", "engine", "--arch", "mamba2-1.3b",
                 "--smoke", "--device", "cpu", "--duration", "0.05"]) == 0


def test_mamba_block_copies_the_reference_elementwise_ops():
    """``silu`` and ``softplus`` as the JAX package computes them: in
    bf16 ``silu`` bit for bit (``F.silu`` rounds once and differs in
    about a third of the values); in f32 both within a few ulps (the two
    libraries' ``exp`` and ``log1p`` differ in the last place)."""
    x = np.random.default_rng(6).standard_normal(4096).astype(np.float32) * 4
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(
        M.silu(xt.to(torch.bfloat16)).float().numpy(),
        _np32(jax.nn.silu(xj.astype(jnp.bfloat16))))
    np.testing.assert_allclose(M.silu(xt).numpy(),
                               np.asarray(jax.nn.silu(xj)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(M._softplus(xt).numpy(),
                               np.asarray(jax.nn.softplus(xj)), rtol=1e-6,
                               atol=1e-7)
