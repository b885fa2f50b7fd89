"""The port's training path on the CPU against the JAX package:
``repro_torch.training`` (the synthetic stream, AdamW, chunked
cross-entropy, the loss and the train step), remat in the stack, and
the autograd ``Function``s that put the CUDA kernels on the training
path (their backward is the plain version's).

JAX's own parameters for each ``-smoke`` config are carried across with
``param.from_numpy``; batches come from the synthetic stream and other
inputs are drawn with numpy from a seed.  The JAX side runs
``repro.training`` with ``impl="ref"``, the path the reference takes off
the TPU (it has no backward kernel: its gradient is the jnp oracle's).

Tolerances:

* data batches bit-equal (the same NumPy stream);
* ``chunked_ce_loss`` within 1e-6 relative (f32 sums in another order);
* the loss within 1e-5 relative and every gradient leaf within
  ``max(1e-4, 3 g)`` of its max|g| in f32, ``g`` the model's own gap
  when every weight moves one ulp (the test's docstring has the
  readings); in bf16 within ``max(2e-2, 2 g)`` of max|g|, ``g``
  the JAX package's own bf16 gradient against its f32 one on the same
  leaf (the repo's bf16 convention);
* ``adamw_update``: parameters and moments bit-equal to the op-by-op
  reference, and within one rounding step of their dtype (relative to
  the leaf's max) of the jitted one, whose CPU fusion contracts the
  update's multiply-adds into FMAs;
* three train steps in f32: losses within 1e-4 relative (parameters are
  not compared: Adam's first step moves a near-zero gradient by ±lr);
* remat on against off, ``REPRO_OPTS=remat_dots`` against the full
  remat, and the ``Function``s against autograd of the plain versions:
  bit-equal; ``remat_dots`` against JAX's under the same flag at the f32
  tolerances above.
"""
from __future__ import annotations

import collections
import functools
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jstep  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.training import data as tdata  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tstep  # noqa: E402

KEY = jax.random.PRNGKey(0)
ARCHS = ["phi3-mini-3.8b-smoke", "mamba2-1.3b-smoke",
         "deepseek-moe-16b-smoke"]


def _jax_params(arch: str, dtype: str):
    params = JR.init_params(jax_config(arch), KEY)
    if dtype == "f32":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        params)
    return params


def _port(tree):
    return P.from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _batch(arch: str, batch: int = 4, seq: int = 64, seed: int = 0):
    cfg = jdata.DataConfig(vocab_size=jax_config(arch).vocab_size,
                           batch=batch, seq_len=seq, seed=seed)
    return jdata.SyntheticLM(cfg).next_batch()


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _rel(got, want) -> float:
    g, w = _f32(got), _f32(want)
    scale = np.abs(w).max()
    err = np.abs(g - w).max()
    return float(err / scale) if scale else float(err)


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch: str):
    fn = jstep.make_loss_fn(jax_config(arch), impl="ref")
    return jax.jit(jax.value_and_grad(fn, has_aux=True))


def _jax_loss_and_grads(arch: str, jp, batch):
    (loss, _), grads = _jax_value_and_grad(arch)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), grads


def _one_ulp_off(tree, seed: int = 1):
    """Every f32 weight moved one ulp up or down (a seeded coin)."""
    r = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        to = np.where(r.random(a.shape) < 0.5, np.inf, -np.inf)
        return jnp.asarray(np.nextafter(a, to.astype(a.dtype)))
    return jax.tree_util.tree_map(move, tree)


def _port_loss_and_grads(arch: str, tp, batch, remat: bool = True):
    paths, flat = zip(*((p, t.requires_grad_(True))
                        for p, t in P.leaves(tp)))
    loss, _ = tstep.make_loss_fn(get_config(arch), remat=remat)(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat)
    return float(loss.detach()), dict(zip(paths, grads))


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# The synthetic stream
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 5])
def test_data_batches_bit_equal_to_reference(seed):
    kw = dict(vocab_size=300, batch=3, seq_len=17, seed=seed)
    mine = tdata.SyntheticLM(tdata.DataConfig(**kw))
    theirs = jdata.SyntheticLM(jdata.DataConfig(**kw))
    for _ in range(4):
        a, b = mine.next_batch(), theirs.next_batch()
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.state() == theirs.state() == {"step": 4, "seed": seed}
    resumed = tdata.SyntheticLM.from_state(tdata.DataConfig(**kw),
                                           {"step": 2, "seed": seed})
    want = jdata.SyntheticLM.from_state(jdata.DataConfig(**kw),
                                        {"step": 2, "seed": seed})
    np.testing.assert_array_equal(resumed.next_batch()["tokens"],
                                  want.next_batch()["tokens"])
    with pytest.raises(AssertionError):
        tdata.SyntheticLM.from_state(tdata.DataConfig(**kw),
                                     {"step": 0, "seed": seed + 1})


def test_prefetcher_serves_the_stream_in_order():
    """Every batch in stream order, also behind a consumer slower than
    the producer's 0.5 s put timeout (the reference's ``Prefetcher``
    drops the batch it holds there, and serves step 3 as the third)."""
    cfg = tdata.DataConfig(vocab_size=50, batch=2, seq_len=8, seed=1)
    pf = tdata.Prefetcher(tdata.SyntheticLM(cfg))
    try:
        time.sleep(1.2)            # the queue is full: two puts time out
        got = [pf.next_batch()["tokens"] for _ in range(5)]
    finally:
        pf.close()
    ref_stream = jdata.SyntheticLM(jdata.DataConfig(**cfg.__dict__))
    for g in got:
        np.testing.assert_array_equal(g, ref_stream.next_batch()["tokens"])


# ---------------------------------------------------------------------------
# Chunked cross-entropy and the loss
# ---------------------------------------------------------------------------
def test_chunked_ce_loss_matches_reference():
    arch = "phi3-mini-3.8b-smoke"
    jp = _jax_params(arch, "f32")
    r = np.random.default_rng(3)
    hidden = r.normal(size=(3, 64, 64)).astype(np.float32)
    targets = r.integers(0, 256, size=(3, 64)).astype(np.int32)
    targets[r.random(targets.shape) < 0.2] = -1            # masked tokens
    want, wm = jstep.chunked_ce_loss(jax_config(arch), jp,
                                     jnp.asarray(hidden),
                                     jnp.asarray(targets), chunk=16)
    got, gm = tstep.chunked_ce_loss(get_config(arch), _port(jp),
                                    torch.from_numpy(hidden),
                                    torch.from_numpy(targets), chunk=16)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert float(gm["acc"]) == pytest.approx(float(wm["acc"]), rel=1e-6)
    assert float(gm["tokens"]) == float(wm["tokens"])
    with pytest.raises(ValueError):
        tstep.chunked_ce_loss(get_config(arch), _port(jp),
                              torch.from_numpy(hidden[:, :60]),
                              torch.from_numpy(targets[:, :60]), chunk=16)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_f32(arch):
    """f32 gradients within ``max(1e-4, 3 g)`` of max|g|, ``g`` the
    largest gap over the model's leaves between JAX's gradient and JAX's
    gradient with every weight one ulp off: the smoke models amplify f32
    rounding in the backward to ~1e-4 (phi3: g = 1.35e-4; the port's own
    gap reached 2.05 g, on deepseek's embedding)."""
    jp = _jax_params(arch, "f32")
    batch = _batch(arch)
    want, jg = _jax_loss_and_grads(arch, jp, batch)
    _, jg_ulp = _jax_loss_and_grads(arch, _one_ulp_off(jp), batch)
    g = max(_rel(a, b) for a, b in zip(jax.tree_util.tree_leaves(jg_ulp),
                                       jax.tree_util.tree_leaves(jg)))
    got, tg = _port_loss_and_grads(arch, _port(jp), batch)
    assert got == pytest.approx(want, rel=1e-5)
    assert len(tg) == len(jax.tree_util.tree_leaves(jg))
    for path, grad in tg.items():
        w = _leaf(jg, path)
        assert grad.shape == w.shape and grad.dtype == torch.float32, path
        assert _rel(grad, w) <= max(1e-4, 3 * g), (path, _rel(grad, w), g)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference_bf16(arch):
    batch = _batch(arch)
    jp = _jax_params(arch, "bf16")
    want, jg = _jax_loss_and_grads(arch, jp, batch)
    want32, jg32 = _jax_loss_and_grads(arch, _jax_params(arch, "f32"), batch)
    got, tg = _port_loss_and_grads(arch, _port(jp), batch)
    assert abs(got - want) <= max(2e-2, 2 * abs(want - want32) / want32) \
        * want
    for path, g in tg.items():
        w = _leaf(jg, path)
        assert g.dtype == P.from_numpy({"x": np.asarray(w)})["x"].dtype
        gap = _rel(w, _leaf(jg32, path))
        assert _rel(g, w) <= max(2e-2, 2 * gap), (path, _rel(g, w), gap)


def test_remat_gives_the_same_gradients():
    for arch in ("phi3-mini-3.8b-smoke", "mamba2-1.3b-smoke"):
        jp = _jax_params(arch, "f32")
        batch = _batch(arch, batch=2, seq=64)
        la, ga = _port_loss_and_grads(arch, _port(jp), batch, remat=True)
        lb, gb = _port_loss_and_grads(arch, _port(jp), batch, remat=False)
        assert la == lb
        for path in ga:
            assert torch.equal(ga[path], gb[path]), path


class _OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(arch: str, tp, batch, opts: str, monkeypatch):
    """Loss, gradients and the aten ops of the backward (the remat
    recompute included) under ``REPRO_OPTS=opts``."""
    monkeypatch.setenv("REPRO_OPTS", opts)
    paths, flat = zip(*((p, t.requires_grad_(True))
                        for p, t in P.leaves(tp)))
    loss, _ = tstep.make_loss_fn(get_config(arch))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    count = _OpCount()
    with count:
        grads = torch.autograd.grad(loss, flat)
    return loss, dict(zip(paths, grads)), count.n


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_gives_the_same_gradients(arch, monkeypatch):
    """``REPRO_OPTS=remat_dots``: the group checkpoint keeps the
    unbatched products' outputs, so the backward's recompute runs fewer
    ``aten.mm`` (and the same ``aten.bmm``); loss and every gradient leaf
    are the full remat's bit for bit."""
    jp = _jax_params(arch, "f32")
    batch = _batch(arch, batch=2, seq=64)
    la, ga, na = _backward_ops(arch, _port(jp), batch, "", monkeypatch)
    lb, gb, nb = _backward_ops(arch, _port(jp), batch, "remat_dots",
                               monkeypatch)
    assert torch.equal(la, lb)
    for path in ga:
        assert torch.equal(ga[path], gb[path]), path
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert nb[mm] < na[mm]
    assert nb[bmm] == na[bmm]


def test_remat_dots_loss_matches_reference(monkeypatch):
    """JAX's loss and gradient under ``REPRO_OPTS=remat_dots`` (its
    ``dots_with_no_batch_dims_saveable`` policy) against the port's, at
    the f32 training tolerances."""
    arch = "phi3-mini-3.8b-smoke"
    monkeypatch.setenv("REPRO_OPTS", "remat_dots")
    jp = _jax_params(arch, "f32")
    batch = _batch(arch, batch=2, seq=64)
    fn = jax.jit(jax.value_and_grad(
        jstep.make_loss_fn(jax_config(arch), impl="ref"), has_aux=True))
    (want, _), jgrads = fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, grads = _port_loss_and_grads(arch, _port(jp), batch)
    assert got == pytest.approx(float(want), rel=1e-5)
    for path, g in grads.items():
        assert _rel(g, _leaf(jgrads, path)) <= 1e-4, path


def test_lm_hidden_without_remat_is_the_serving_forward():
    """remat changes nothing forward: ``lm_hidden`` with and without it,
    under no_grad, bit-equal."""
    arch = "phi3-mini-3.8b-smoke"
    cfg, tp = get_config(arch), _port(_jax_params(arch, "bf16"))
    tokens = torch.from_numpy(_batch(arch)["tokens"])
    with torch.no_grad():
        a = R.lm_hidden(cfg, tp, {"tokens": tokens})
        b = R.lm_hidden(cfg, tp, {"tokens": tokens}, remat=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_silu_gradient_is_the_reference_one_where_exp_overflows(dtype):
    """``layers.silu``'s gradient against ``jax.grad(jax.nn.silu)``, on
    inputs far below -88 too, where ``exp(-x)`` overflows f32: the
    composed ops' backward gave NaN there (``0 * inf``), JAX's
    ``lax.logistic`` derivative does not.  The forward is unchanged."""
    from repro_torch.models.layers import silu
    x = np.array([-1e4, -300.0, -100.0, -89.0, -87.0, -20.0, -1.0, -1e-3,
                  0.0, 0.5, 3.0, 40.0, 1e4], np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    want = jax.vmap(jax.grad(lambda v: jax.nn.silu(v).astype(jnp.float32)))(
        jnp.asarray(x).astype(jdt))
    t = _port({"x": jnp.asarray(x).astype(jdt)})["x"].requires_grad_(True)
    y = silu(t)
    (got,) = torch.autograd.grad(y.float().sum(), [t])
    assert torch.isfinite(got.float()).all()
    # f32: within an ulp (JAX's vmapped grad fuses the product chain)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               rtol=1e-6 if dtype == "f32" else 0,
                               atol=0 if dtype == "f32" else 2 ** -7)
    with torch.no_grad():
        assert torch.equal(silu(t), y.detach())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
#: one rounding step of a stored dtype, relative to a leaf's max|x|
STEP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -22}


@pytest.mark.parametrize("which", ["default", "planner"])
def test_adamw_update_matches_reference(which):
    """Three updates of phi3-smoke's bf16 tree from random gradients:
    the default ``OptConfig`` (bf16 m, f32 v, decay 0.1) and the
    planner's (no decay, f32 m).  Against the op-by-op reference every
    leaf is bit-equal; against the jitted one (XLA contracts the
    multiply-adds into FMAs) within one rounding step of its dtype
    relative to its max|x| (bf16 m after a near-tie: 6.4e-3).  The
    gradients' norm stays under the clip, so the scale is 1 on both
    sides: the norm itself (a sum of squares in another order) is held
    to 1e-5, and the clip to ``test_grad_clip_engages`` and the step
    test."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    if which == "planner":
        kw.update(weight_decay=0.0, grad_clip=5.0, m_dtype="float32")
    cfg, jcfg = topt.OptConfig(**kw), jopt.OptConfig(**kw)
    jp = _jax_params("phi3-mini-3.8b-smoke", "bf16")
    tp = _port(jp)
    js, ts = jopt.init_opt_state(jp, jcfg), topt.init_opt_state(tp, cfg)
    assert ts["m"]["embed"]["tokens"].dtype == getattr(torch, cfg.m_dtype)
    jit_update = jax.jit(jopt.adamw_update, static_argnums=3)
    jjp, jjs = jp, js
    r = np.random.default_rng(7)
    for _ in range(3):
        g = jax.tree_util.tree_map(
            lambda a: jnp.asarray(r.normal(scale=1e-3, size=a.shape),
                                  a.dtype), jp)
        with jax.disable_jit():
            jp, js, jm = jopt.adamw_update(jp, g, js, jcfg)
        jjp, jjs, _ = jit_update(jjp, g, jjs, jcfg)
        tp, ts, tm = topt.adamw_update(tp, _port(g), ts, cfg)
        assert float(jm["grad_norm"]) < min(cfg.grad_clip, 1.0)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        assert float(tm["lr"]) == float(jm["lr"])
        for path, t in P.leaves(tp):
            for mine, theirs, jitted in (
                    (t, _leaf(jp, path), _leaf(jjp, path)),
                    (_leaf(ts["m"], path), _leaf(js["m"], path),
                     _leaf(jjs["m"], path)),
                    (_leaf(ts["v"], path), _leaf(js["v"], path),
                     _leaf(jjs["v"], path))):
                want = P.from_numpy({"x": np.asarray(theirs)})["x"]
                assert mine.dtype == want.dtype
                assert torch.equal(mine, want), path
                assert _rel(mine, jitted) <= STEP[mine.dtype], path
    assert int(ts["step"]) == int(js["step"]) == 3


def test_adamw_update_slices_give_the_same_bits(monkeypatch):
    """A leaf updated slice by slice equals the leaf updated whole."""
    r = np.random.default_rng(2)
    p0 = torch.from_numpy(r.normal(size=(5, 7, 3)).astype(np.float32))
    g = {"w": torch.from_numpy(r.normal(size=(5, 7, 3)).astype(np.float32))}
    cfg = topt.OptConfig(lr=0.1, warmup_steps=0)
    runs = []
    for size in (1 << 26, 8):
        monkeypatch.setattr(topt, "UPDATE_SLICE", size)
        params = {"w": p0.clone()}
        state = topt.init_opt_state(params, cfg)
        for _ in range(2):
            params, state, _ = topt.adamw_update(params, g, state, cfg)
        runs.append((params["w"], state["m"]["w"], state["v"]["w"]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_global_norm_walks_the_jax_leaf_order():
    """Nested keys in ``jax.tree_util``'s order: sorted at each level,
    so ("a", "x") comes before ("a.b",), though "a.b" < "a/x"."""
    tree = {"a.b": torch.tensor([1e8]), "a": {"x": torch.tensor([1.0])},
            "b": torch.tensor([-1e8])}
    order = [p for p, _ in P.leaves(tree)]
    jorder = [tuple(k.key for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(
                  {"a.b": 0, "a": {"x": 0}, "b": 0})[0]]
    assert order == jorder == [("a", "x"), ("a.b",), ("b",)]
    want = jopt.global_norm({k: jnp.asarray(np.asarray(v)) if not
                             isinstance(v, dict) else
                             {"x": jnp.asarray(np.asarray(v["x"]))}
                             for k, v in tree.items()})
    assert float(topt.global_norm(tree)) == float(want)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference_losses(microbatches):
    arch = "phi3-mini-3.8b-smoke"
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    jp = _jax_params(arch, "f32")
    tp = _port(jp)
    jcfg = jopt.OptConfig(**kw)
    js = jopt.init_opt_state(jp, jcfg)
    ts = topt.init_opt_state(tp, topt.OptConfig(**kw))
    jfn = jax.jit(jstep.make_train_step(jax_config(arch), jcfg, impl="ref",
                                        microbatches=microbatches))
    tfn = tstep.make_train_step(get_config(arch), topt.OptConfig(**kw),
                                microbatches=microbatches)
    stream = jdata.SyntheticLM(jdata.DataConfig(256, batch=4, seq_len=64))
    for _ in range(3):
        b = stream.next_batch()
        jp, js, jm = jfn(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tm = tfn(tp, ts, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-3)
        assert float(tm["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-6)
    assert int(ts["step"]) == 3


def _setup(arch="phi3-mini-3.8b-smoke", **opt_kw):
    cfg = get_config(arch)
    params = R.init_params(cfg, torch.Generator().manual_seed(0))
    opt_cfg = topt.OptConfig(**{"lr": 1e-3, "warmup_steps": 2,
                                "total_steps": 100, **opt_kw})
    data = tdata.SyntheticLM(tdata.DataConfig(vocab_size=cfg.vocab_size,
                                              batch=4, seq_len=64))
    return cfg, params, opt_cfg, data


def _torch_batch(data):
    return {k: torch.from_numpy(v) for k, v in data.next_batch().items()}


def test_loss_decreases():
    cfg, params, opt_cfg, data = _setup()
    opt = topt.init_opt_state(params, opt_cfg)
    step = tstep.make_train_step(cfg, opt_cfg)
    losses = []
    for _ in range(10):
        params, opt, m = step(params, opt, _torch_batch(data))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_grad_clip_engages():
    cfg, params, opt_cfg, data = _setup(grad_clip=1e-6, warmup_steps=0,
                                        total_steps=10)
    before = {p: t.detach().float().clone() for p, t in P.leaves(params)}
    opt = topt.init_opt_state(params, opt_cfg)
    params, _, m = tstep.make_train_step(cfg, opt_cfg)(params, opt,
                                                       _torch_batch(data))
    # with a tiny clip, the update magnitude is bounded
    delta = max(float((t.detach().float() - before[p]).abs().max())
                for p, t in P.leaves(params))
    assert delta < 0.2
    assert float(m["grad_norm"]) > 1e-6


# ---------------------------------------------------------------------------
# The kernels' autograd Functions (kernel forward, plain backward)
# ---------------------------------------------------------------------------
def _plain_grads(fn, inputs, upstream):
    xs = [x.detach().requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return outs, torch.autograd.grad(outs, xs, upstream)


@pytest.mark.parametrize("case", [(True, None), (True, 5), (False, None)])
def test_flash_function_backward_is_the_plain_gradient(monkeypatch, case):
    """The kernel's forward replaced by the plain version (the CPU has no
    kernel): the ``Function``'s output and its gradients equal autograd
    of ``ref.flash_attention``, bit for bit, and the forward is one
    launch."""
    causal, window = case
    launches = []

    def fake_kernel(q, k, v, *, causal, window):
        launches.append(1)
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(ops._flash, "flash_attention", fake_kernel)
    r = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(r.normal(size=s).astype(np.float32))
               for s in ((2, 12, 4, 8), (2, 12, 2, 8), (2, 12, 2, 8)))
    up = torch.from_numpy(r.normal(size=(2, 12, 4, 8)).astype(np.float32))

    def plain(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    (want,), wgrads = _plain_grads(plain, (q, k, v), (up,))
    xs = [t.detach().requires_grad_(True) for t in (q, k, v)]
    got = ops.FlashAttentionFn.apply(*xs, causal, window)
    ggrads = torch.autograd.grad(got, xs, up)
    assert launches == [1]
    assert torch.equal(got, want)
    for a, b in zip(ggrads, wgrads):
        assert torch.equal(a, b)
    # only the inputs that need a gradient get one
    xs = [q.detach(), k.detach().requires_grad_(True), v.detach()]
    out = ops.FlashAttentionFn.apply(*xs, causal, window)
    (gk,) = torch.autograd.grad(out, [xs[1]], up)
    assert torch.equal(gk, wgrads[1])


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_function_backward_is_the_plain_gradient(monkeypatch, with_h0):
    launches = []

    def fake_kernel(x, dt, A, B, C, *, chunk, h0=None):
        launches.append(1)
        return ref.ssd_chunked(x, dt, A, B, C, chunk=chunk, h0=h0)
    monkeypatch.setattr(ops._ssd, "ssd_scan", fake_kernel)
    r = np.random.default_rng(5)
    b, s, h, p, n = 2, 16, 3, 4, 5
    x = torch.from_numpy(r.normal(size=(b, s, h, p)).astype(np.float32))
    dt = torch.from_numpy(r.uniform(0.01, 0.2, (b, s, h)).astype(np.float32))
    A = torch.from_numpy(-r.uniform(0.5, 2.0, h).astype(np.float32))
    B = torch.from_numpy(r.normal(size=(b, s, 1, n)).astype(np.float32))
    C = torch.from_numpy(r.normal(size=(b, s, 1, n)).astype(np.float32))
    h0 = torch.from_numpy(r.normal(size=(b, h, p, n)).astype(np.float32))
    gy = torch.from_numpy(r.normal(size=(b, s, h, p)).astype(np.float32))
    gh = torch.from_numpy(r.normal(size=(b, h, p, n)).astype(np.float32))
    inputs = (x, dt, A, B, C) + ((h0,) if with_h0 else ())

    def plain(*a):
        return ref.ssd_chunked(*a[:5], chunk=8, h0=a[5] if with_h0 else None)
    want, wgrads = _plain_grads(plain, inputs, (gy, gh))
    xs = [t.detach().requires_grad_(True) for t in inputs]
    got = ops.SSDScanFn.apply(*xs[:5], xs[5] if with_h0 else None, 8)
    ggrads = torch.autograd.grad(got, xs, (gy, gh))
    assert launches == [1]
    for a, b_ in zip(got, want):
        assert torch.equal(a, b_)
    for a, b_ in zip(ggrads, wgrads):
        assert torch.equal(a, b_)


def test_cpu_dispatch_differentiates_the_plain_versions():
    """On the CPU ``ops`` never enters a ``Function``: the plain
    versions are differentiated directly."""
    r = np.random.default_rng(6)
    q = torch.from_numpy(r.normal(size=(1, 6, 2, 4)).astype(np.float32))
    q.requires_grad_(True)
    out = ops.flash_attention(q, q.detach(), q.detach())
    assert out.grad_fn is not None
    assert "FlashAttentionFn" not in type(out.grad_fn).__name__
