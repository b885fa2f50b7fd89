"""The port's model stack on the CPU against the JAX package.

JAX's own parameters for ``phi3-mini-3.8b-smoke`` (``repro.models
.registry.init_params``) are carried across with ``param.from_numpy``,
and the same token batches go through ``repro.models.registry``
(``impl="ref"``, the path the JAX engine takes off the TPU) and
``repro_torch.models.registry``.

Tolerances:

* f32 parameters: logits within 1e-4 of max|logit| (relative), greedy
  tokens identical.  Both run the same f32 operations in another
  summation order; the decode cache is bf16 on both sides, so a K/V
  value on a bf16 rounding boundary could round apart, which the
  tolerance covers.
* bf16 parameters: logits within 2e-2 of max|logit|.  Every product
  rounds its output to bf16 in both frameworks, at their own places
  (JAX's own ref and Pallas paths differ by 0.0117 of max|logit| on this
  model).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import registry as JR  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402

ARCH = "phi3-mini-3.8b-smoke"
TOL = {"f32": 1e-4, "bf16": 2e-2}


def _jax_params(dtype: str):
    params = JR.init_params(jax_config(ARCH), jax.random.PRNGKey(0))
    if dtype == "f32":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        params)
    return params


def _port_params(jparams):
    return P.from_numpy(jax.tree_util.tree_map(np.asarray, jparams))


def _cache_close(got: torch.Tensor, want, dtype: str) -> None:
    """bf16 cache entries: in f32 each within one bf16 step of the
    reference's (2^-7 relative: bf16 keeps 8 significant bits), since
    only the final rounding to bf16 can differ; in bf16 within the
    logits' tolerance."""
    assert got.dtype == torch.bfloat16
    if dtype == "bf16":
        assert _rel(got, want) <= TOL[dtype]
        return
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert (np.abs(got.float().numpy() - w) <= 2.0 ** -7 * np.abs(w)).all()


def _rel(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


def test_config_is_the_reference_config():
    for name in ("phi3-mini-3.8b", ARCH):
        port, ref = get_config(name), jax_config(name)
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "resolved_head_dim", "rope_theta",
                  "rope_fraction", "norm", "glu", "act", "tie_embeddings",
                  "resolved_pattern"):
            assert getattr(port, f) == getattr(ref, f), (name, f)
    with pytest.raises(KeyError, match="not ported"):
        get_config("gemma3-12b")


def test_count_params_full_width():
    cfg = get_config("phi3-mini-3.8b")
    assert R.count_params(cfg) == JR.count_params(jax_config(
        "phi3-mini-3.8b")) == 3_821_079_552


def test_from_numpy_is_bit_exact_and_keeps_the_tree():
    jparams = _jax_params("bf16")
    port = _port_params(jparams)
    specs = R.model_specs(get_config(ARCH))
    flat = dict(P.leaves(port))
    assert set(flat) == {p for p, _ in P.leaves(specs)}
    for path, s in P.leaves(specs):
        t = flat[path]
        assert tuple(t.shape) == s.shape and t.dtype == s.dtype, path
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = tuple(k.key for k in path)
        want = np.asarray(leaf.astype(jnp.float32))
        np.testing.assert_array_equal(flat[keys].float().numpy(), want)


def test_init_params_follows_the_reference_scheme():
    """Seeded draws: std 1/sqrt(shape[0]) for matrices (the stacked
    group count, as in the JAX package), std 1 for the embedding, ones
    for the norms; f32 norms, bf16 matrices."""
    cfg = get_config(ARCH)
    p = R.init_params(cfg, torch.Generator().manual_seed(0))
    again = R.init_params(cfg, torch.Generator().manual_seed(0))
    for (path, a), (_, b) in zip(P.leaves(p), P.leaves(again)):
        assert torch.equal(a, b), path
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model))
    assert p["groups"]["pos0"]["attn"]["q"].dtype == torch.bfloat16
    emb = p["embed"]["tokens"].float()
    assert abs(emb.std().item() - 1.0) < 0.05
    wq = p["groups"]["pos0"]["attn"]["q"].float()
    assert abs(wq.std().item() - cfg.n_groups ** -0.5) < 0.05


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_prefill_and_decode_match_reference(dtype):
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    jparams = _jax_params(dtype)
    params = _port_params(jparams)
    g = np.random.default_rng(0)
    B, S, max_len = 2, 32, 48
    toks = g.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.array([S, 19], np.int32)          # right-padded ragged row

    jl, jcache, jlen = JR.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                                  max_len, impl="ref",
                                  lengths=jnp.asarray(lengths))
    tl, tcache, tlen = R.prefill(cfg, params,
                                 {"tokens": torch.from_numpy(toks)}, max_len,
                                 lengths=torch.from_numpy(lengths))
    assert _rel(tl, jl) <= TOL[dtype]
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    for leaf in ("k", "v", "pos"):
        got, want = tcache["pos0"][leaf], jcache["pos0"][leaf]
        assert tuple(got.shape) == want.shape
        if leaf == "pos":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _cache_close(got, want, dtype)
    if dtype == "f32":
        np.testing.assert_array_equal(tl.argmax(-1).numpy(),
                                      np.asarray(jl.argmax(-1)))

    # three decode steps from the prefilled cache, greedy on each side
    jtok, ttok = jl.argmax(-1).astype(jnp.int32), tl.argmax(-1).to(torch.int32)
    jpos, tpos = jlen, tlen.clone()
    for _ in range(3):
        jl, jcache = JR.decode_step(jcfg, jparams, jcache, jtok, jpos,
                                    impl="ref")
        tl, tcache = R.decode_step(cfg, params, tcache, ttok, tpos)
        assert _rel(tl, jl) <= TOL[dtype]
        jtok = jl.argmax(-1).astype(jnp.int32)
        ttok = tl.argmax(-1).to(torch.int32)
        if dtype == "f32":
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        jpos, tpos = jpos + 1, tpos + 1
    for leaf in ("k", "v", "pos"):
        got, want = tcache["pos0"][leaf], jcache["pos0"][leaf]
        if leaf == "pos":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            _cache_close(got, want, dtype)


def test_full_forward_matches_reference():
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    jparams = _jax_params("f32")
    params = _port_params(jparams)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (1, 20)).astype(np.int32)
    want = JR.lm_logits(jcfg, jparams, {"tokens": jnp.asarray(toks)},
                        impl="ref")
    got = R.lm_logits(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert _rel(got, want) <= TOL["f32"]


def test_not_ported_model_parts_raise():
    from dataclasses import replace
    cfg = get_config(ARCH)
    for bad in (replace(cfg, pattern=("attn_swa",)),
                replace(cfg, parallel_block=True),
                replace(cfg, enc_dec=True, num_encoder_layers=2),
                replace(cfg, embed_frontend="patch")):
        with pytest.raises(NotImplementedError, match="not ported"):
            R.model_specs(bad)
