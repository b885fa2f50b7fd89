"""The MoE layer on local shards, seen from inside, and the reference's
three remaining ``REPRO_OPTS`` in the port.

The sharded MoE's values are held in ``test_torch_sharded_families.py``
and ``test_torch_sharded_models.py`` (four gloo ranks).  Here one rank
of a fake four-rank world (``distributed.sharding.fake_world``: the
collectives return shapes, not values) runs ``apply_moe`` on DTensors of
``meta`` shards, on (1, 4) and (2, 2), under ``tp`` and ``sp``, for
deepseek-moe-16b-smoke (4 experts: expert parallel), the same with 2
experts (d_ff parallel on (1, 4)) and with ``REPRO_OPTS=w8_experts``
(int8 banks).  It shows, on any torch release, what an older release's
DTensor rules need (they lack some of the newer ones' op rules):

* the router, the queue slots, the dispatch or dense combine, the
  dequantisation and the expert products receive and return plain
  tensors only;
* between the sharding helpers' calls (``to_local_as``, ``from_local_as``,
  ``reduce_partial``) no aten op runs on a DTensor;
* each rank's banks are its slice of the experts (expert parallel) or of
  their d_ff (d_ff parallel), an int8 bank still int8 after its gather.

The options, each read through ``util.opt_flags()`` as the reference
reads it, against the reference run with the same ``REPRO_OPTS``:

* ``sp_naive_attn``: the plain flash attention over 1100 positions (past
  its 512-row chunks) is one ``naive_attention``, no chunk checkpoint,
  within 1e-6 of the reference's ``chunked_attention`` under the option
  and bit-equal to the chunked run without it (the chunks split the
  queries only; each row's sums are the same);
* ``ssd_shard_state``: the plain SSD scan constrains each chunk's state
  (the identity off a mesh: bit-equal, within 1e-6 of the reference's
  ``ssd_chunked`` under the option); inside ``kernels.ops``' sharded
  scan every chunk's constraint passes a rank's local state through;
* ``microbatch8``: the dry-run's train cell builds an 8-microbatch step;
  its step on phi3-smoke at batch 8 is held against ``repro.training``'s
  ``make_train_step(microbatches=8)`` with the existing training test's
  tolerances (loss 1e-4, gradient norm 1e-3 relative), and against the
  port's one-batch step within 1e-5 (the f32 accumulation order only).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.training import data as jdata  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jstep  # noqa: E402

from repro_torch.configs.base import ShapeCell, get_config  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh, device_mesh  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tstep  # noqa: E402

ARCH = "deepseek-moe-16b-smoke"
#: the MoE variants: (experts override or 0, REPRO_OPTS)
VARIANTS = {"ep": (0, ""), "dff": (2, ""), "w8": (0, "w8_experts")}
INNER = ("_router", "_queue_slots", "_dispatch", "_dense", "_expert_ffn",
         "_dq", "_bmm")
HELPERS = ("to_local_as", "from_local_as", "reduce_partial")


def _cfg(experts: int):
    cfg = get_config(ARCH)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    return cfg


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class _DTensorOps(TorchDispatchMode):
    """Records every aten op that reaches a DTensor while no sharding
    helper is running, and hands it on to DTensor."""

    def __init__(self):
        super().__init__()
        self.helper = 0
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            if not self.helper:
                self.ops.append(str(func))
            return NotImplemented
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("strategy", ["tp", "sp"])
@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("impl", ["dispatch", "dense"])
def test_moe_dispatch_sees_plain_tensors_only(monkeypatch, variant,
                                              mesh_shape, strategy, impl):
    experts, opts = VARIANTS[variant]
    monkeypatch.setenv("REPRO_OPTS", opts)
    cfg = _cfg(experts)
    specs = M.moe_specs(cfg)
    params = P.abstract_tree(specs)
    mesh = Mesh(mesh_shape, ("data", "model"))
    prules, arules = SH.strategy_rules(strategy)
    seen = {name: 0 for name in INNER}
    mode = _DTensorOps()

    def plain_only(name, fn):
        def spy(*args, **kw):
            for t in _tensors((args, kw)):
                assert not SH.is_dtensor(t), (name, tuple(t.shape))
            out = fn(*args, **kw)
            for t in _tensors(out):
                assert not SH.is_dtensor(t), (name, tuple(t.shape))
            seen[name] += 1
            return out
        return spy

    def helper(fn):
        def run(*args, **kw):
            mode.helper += 1
            try:
                return fn(*args, **kw)
            finally:
                mode.helper -= 1
        return run

    for name in INNER:
        monkeypatch.setattr(M, name, plain_only(name, getattr(M, name)))
    for name in HELPERS:
        monkeypatch.setattr(M, name, helper(getattr(M, name)))
    real = M._sharded_moe
    banks = {}

    def watched(cfg, p, x, route):
        def route_spy(cfg, lp, *a):
            banks.update(lp)
            return route(cfg, lp, *a)
        with mode:
            return real(cfg, p, x, route_spy)
    monkeypatch.setattr(M, "_sharded_moe", watched)

    with SH.fake_world(4):
        dm = device_mesh(mesh, "cuda")
        dp = SH.distribute_tree(params, SH.tree_shardings(
            P.axes_tree(specs), params, mesh, prules), dm)
        x = torch.empty((4, 16, cfg.d_model), device="meta")
        dx = SH.distribute_tree(x, SH.spec_for(
            x.shape, ("batch", "res_seq", "embed"), arules, mesh), dm)
        with SH.mesh_context(mesh, arules, dm):
            out = M.apply_moe(cfg, dp, dx, impl=impl)
            out1 = M.apply_moe(cfg, dp, dx[:, 0], impl=impl)
    assert SH.is_dtensor(out) and out.shape == x.shape
    assert out1.shape == (4, cfg.d_model)
    assert mode.ops == [], mode.ops
    for name in ("_router", "_expert_ffn", "_dq", "_bmm",
                 "_dense" if impl == "dense" else "_dispatch"):
        assert seen[name] > 0, name
    e, fe = cfg.moe.num_experts, cfg.moe.expert_d_ff
    model = mesh_shape[1]
    if e % model == 0:              # expert parallel: a slice of experts
        want = (e // model, cfg.d_model, fe)
    else:                           # d_ff parallel: every expert, f / model
        want = (e, cfg.d_model, fe // model)
    assert tuple(banks["wi_0"].shape) == want
    assert tuple(banks["wo"].shape) == (want[0], want[2], want[1])
    wdt = torch.int8 if opts else torch.bfloat16
    assert banks["wi_0"].dtype == banks["wo"].dtype == wdt
    if opts:
        assert tuple(banks["wi_0_scale"].shape) == (want[0],)


def test_sp_naive_attn_materialises_the_whole_sequence(monkeypatch):
    g = np.random.default_rng(0)
    b, s, h, kv, hd = 1, 1100, 4, 2, 16
    q, k, v = (g.standard_normal((b, s, n, hd)).astype(np.float32)
               for n in (h, kv, kv))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    chunked = ref.flash_attention(tq, tk, tv, causal=True, window=300)
    monkeypatch.setenv("REPRO_OPTS", "sp_naive_attn")
    calls = []
    real = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    naive = ref.flash_attention(tq, tk, tv, causal=True, window=300)
    grads = torch.autograd.grad(ref.flash_attention(
        tq.requires_grad_(), tk, tv, causal=True, window=300).sum(), tq)
    assert calls == [] and grads[0].shape == tq.shape
    want = np.asarray(jref.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=300))
    assert torch.equal(naive, chunked)
    assert np.abs(naive.numpy() - want).max() <= 1e-6 * np.abs(want).max()


def test_ssd_shard_state_constrains_each_chunk(monkeypatch):
    g = np.random.default_rng(1)
    b, s, h, p, n, chunk = 2, 96, 4, 8, 16, 32
    x = g.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (0.1 + 0.1 * g.random((b, s, h))).astype(np.float32)
    A = -(0.5 + g.random(h)).astype(np.float32)
    B, C = (g.standard_normal((b, s, 1, n)).astype(np.float32)
            for _ in range(2))
    args = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    y0, h0 = ref.ssd_chunked(*args, chunk=chunk)
    monkeypatch.setenv("REPRO_OPTS", "ssd_shard_state")
    calls = []
    real = ref.shard
    monkeypatch.setattr(ref, "shard", lambda t, *ax: calls.append(ax)
                        or real(t, *ax))
    y1, h1 = ref.ssd_chunked(*args, chunk=chunk)
    assert calls == [("batch", "mamba_heads", None, None)] * (s // chunk)
    assert torch.equal(y0, y1) and torch.equal(h0, h1)
    jy, jh = jref.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)),
                              chunk=chunk)
    for got, want in ((y1, jy), (h1, jh)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            1e-6 * np.abs(want).max()

    # inside the sharded scan every constraint sees a rank's local state
    calls.clear()
    mesh = Mesh((1, 4), ("data", "model"))
    with SH.fake_world(4):
        dm = device_mesh(mesh, "cuda")
        arules = SH.strategy_rules("tp")[1]
        meta = [torch.empty(a.shape, device="meta") for a in args]
        dx = SH.distribute_tree(meta[0], SH.spec_for(
            meta[0].shape, ("batch", "res_seq", "mamba_heads", None),
            arules, mesh), dm)
        with SH.mesh_context(mesh, arules, dm):
            y, hN = ops.ssd_scan(dx, *meta[1:], chunk=chunk)
    assert len(calls) == s // chunk
    assert SH.is_dtensor(hN) and hN.shape == (b, h, p, n)
    assert tuple(hN.to_local().shape) == (b, h // 4, p, n)


def test_microbatch8_builds_the_dry_run_train_step(monkeypatch):
    built = []
    real = dryrun.make_train_step
    monkeypatch.setattr(dryrun, "make_train_step",
                        lambda *a, **kw: built.append(kw) or real(*a, **kw))
    cfg = get_config("phi3-mini-3.8b-smoke")
    cell = ShapeCell("smoke_train", "train", 32, 16)
    card = Mesh((1, 1), ("data", "model"))
    dryrun.build_cell(cfg, cell, card, "sp")
    monkeypatch.setenv("REPRO_OPTS", "microbatch8")
    dryrun.build_cell(cfg, cell, card, "sp")
    assert [kw.get("microbatches", 1) for kw in built] == [1, 8]
    r = dryrun.dryrun_cell(cfg, cell, card, "sp")
    assert r["flops"] > 0 and "sharded_error" not in r


def test_microbatch8_step_matches_the_reference():
    arch = "phi3-mini-3.8b-smoke"
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=100)
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        JR.init_params(jax_config(arch), jax.random.PRNGKey(0)))
    tp = P.from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    t1 = P.tree_map(torch.clone, tp)
    jcfg = jopt.OptConfig(**kw)
    jfn = jax.jit(jstep.make_train_step(jax_config(arch), jcfg, impl="ref",
                                        microbatches=8))
    b = jdata.SyntheticLM(jdata.DataConfig(256, batch=8, seq_len=32)
                          ).next_batch()
    _, _, jm = jfn(jp, jopt.init_opt_state(jp, jcfg),
                   {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    ocfg = topt.OptConfig(**kw)
    tp, _, tm = tstep.make_train_step(get_config(arch), ocfg, microbatches=8)(
        tp, topt.init_opt_state(tp, ocfg), tb)
    t1, _, m1 = tstep.make_train_step(get_config(arch), ocfg)(
        t1, topt.init_opt_state(t1, ocfg), tb)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-3)
    assert float(tm["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(m1["grad_norm"]),
                                                   rel=1e-5)
