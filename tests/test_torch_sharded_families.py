"""Sharded execution of the six families ``test_torch_sharded_models``
leaves out, and the MoE layer's two sharded regimes, on four gloo ranks.

The harness is ``test_torch_sharded_models``'s: four processes (one gloo
world) run each case in f32 with the JAX package's parameters on a
(1, 4) and a (2, 2) mesh, a prefill of 40 tokens (whisper over 24
frames), 3 decode steps on a cache of 48 slots sharded along its slots
with the same forced tokens everywhere, under the ``tp`` rules, and one
train step under ``sp``.  The cases:

* gemma3-12b-smoke at 6 layers, one 5:1 group (qk-norm, the embedding
  scale, sliding-window layers of 16 slots: rings on a slot-sharded
  cache, wrapped by the prefill and by every decode step),
  stablelm-3b-smoke (partial rotary, LayerNorm),
  command-r-35b-smoke (the parallel block), mixtral-8x22b-smoke (MoE,
  4 experts: expert parallel on both meshes), jamba-1.5-large-398b-smoke
  at 8 layers, one group (Mamba, attention and MoE layers in one stack;
  40 tokens cross its scan chunk of 32) and whisper-small-smoke (the
  encoder, cross attention over a cross cache written once at the
  prefill);
* ``mixtral-8x22b-smoke/e2``: the same config with 2 experts, built the
  same way in both packages.  On (1, 4) ``model`` does not divide the
  experts, so the banks' ``expert_mlp`` takes it (d_ff parallel: every
  rank every expert on its quarter of d_ff); on (2, 2) each rank of
  ``model`` holds one expert;
* ``mixtral-8x22b-smoke/dense`` and ``/e2-dense``: the two, with the
  dense form of the MoE (``moe_impl="dense"``: every local expert on
  every token, a partial sum) in both packages and in the train step;
* ``deepseek-moe-16b-smoke/w8``: ``REPRO_OPTS=w8_experts``, int8 banks
  gathered in int8 (no train step: int8 leaves take no gradient);
* ``mamba2-1.3b-smoke/ssd``: ``REPRO_OPTS=ssd_shard_state`` in both
  packages (the reference constrains its scan carry to the heads' shard;
  the port's sharded scan holds each rank's heads).

Tolerances:

* against the port unsharded: logits within 1e-5 of max|logit| at the
  prefill and every decode step (the worst case, jamba at 8 layers on
  (1, 4), reads 8.0e-6), and equal greedy tokens; the train step's loss
  and gradient norm within ``max(1e-5, 2 u)`` relative, u how far each
  moves with every f32 weight one ulp off (measured in the same run,
  chip_smoke 7c's rule), and the gradient it hands the optimizer, leaf
  by leaf, within ``max(1e-5, 2 u)`` of the leaf's norm, u that leaf's
  own one-ulp gap.  The ranks change only the order of f32 sums, a
  perturbation of the size of one ulp; where the model amplifies it, u
  says by how much.  whisper-smoke's gradient moves 1.9e-3 of its norm
  with one ulp of its weights (its sharded step 1.8e-3): its f32 step
  is only that accurate.  Its scores reach 120-140, so that the softmax
  puts over 0.99 on one key in 65-76% of the rows and its backward
  cancels: the gradient's error grows at each attention's backward, to
  1.0e-3 of its norm against the same step in f64
  (``scripts/grad_conditioning.py``, at the port's own draw).  So its
  sharded gradient is also held, leaf by leaf, no farther from the f64
  one than twice the unsharded f32 gradient is;
* against the reference's own sharded run (the JAX package on 4 forced
  host devices in subprocesses, on an Auto-axis mesh): the prefill
  logits within ``max(1e-4, 2 u)`` of max|logit| (the two packages'
  f32 rule, ``tests/test_torch_model_families.py``: jamba-smoke's
  unsharded port lies 1.2e-4 from the reference at 8 layers, where one
  ulp moves it 8.7e-5), equal greedy tokens, and each decode
  step within the triangle through the two unsharded runs, in
  max|error|: 1e-5 of max|logit|, plus the two packages' unsharded
  gap, plus the reference's own sharded-vs-unsharded gap (the existing
  file's gap rule).

Each rank also records the MoE router's choices and the dispatch's
keep masks at every call: every rank's equal the unsharded run's rows,
so the same assignments are dropped.
"""
from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jax_config  # noqa: E402
from repro.models import registry as JR  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.training import train_step as TS  # noqa: E402
from repro_torch.training.optimizer import (  # noqa: E402
    OptConfig, init_opt_state)
from test_torch_sharded_models import _free_port, _rel  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: case -> (arch, experts override or 0, REPRO_OPTS, with a train step,
#: layers override or 0: gemma3 and jamba run one group of their
#: pattern, 6 and 8 layers, every kind of layer once; the MoE's form)
CASES = {
    "gemma3-12b-smoke": ("gemma3-12b-smoke", 0, "", True, 6, "dispatch"),
    "stablelm-3b-smoke": ("stablelm-3b-smoke", 0, "", True, 0, "dispatch"),
    "command-r-35b-smoke": ("command-r-35b-smoke", 0, "", True, 0,
                            "dispatch"),
    "mixtral-8x22b-smoke": ("mixtral-8x22b-smoke", 0, "", True, 0,
                            "dispatch"),
    "jamba-1.5-large-398b-smoke": ("jamba-1.5-large-398b-smoke", 0, "",
                                   True, 8, "dispatch"),
    "whisper-small-smoke": ("whisper-small-smoke", 0, "", True, 0,
                            "dispatch"),
    "mixtral-8x22b-smoke/e2": ("mixtral-8x22b-smoke", 2, "", True, 0,
                               "dispatch"),
    "mixtral-8x22b-smoke/dense": ("mixtral-8x22b-smoke", 0, "", True, 0,
                                  "dense"),
    "mixtral-8x22b-smoke/e2-dense": ("mixtral-8x22b-smoke", 2, "", True, 0,
                                     "dense"),
    "deepseek-moe-16b-smoke/w8": ("deepseek-moe-16b-smoke", 0, "w8_experts",
                                  False, 0, "dispatch"),
    "mamba2-1.3b-smoke/ssd": ("mamba2-1.3b-smoke", 0, "ssd_shard_state",
                              True, 0, "dispatch"),
}
MOE_CASES = ("mixtral-8x22b-smoke", "jamba-1.5-large-398b-smoke",
             "mixtral-8x22b-smoke/e2", "mixtral-8x22b-smoke/dense",
             "mixtral-8x22b-smoke/e2-dense", "deepseek-moe-16b-smoke/w8")
#: the cases of each reference subprocess (run side by side)
REFERENCE_GROUPS = (("gemma3-12b-smoke", "stablelm-3b-smoke",
                     "command-r-35b-smoke", "mamba2-1.3b-smoke/ssd"),
                    ("jamba-1.5-large-398b-smoke", "mixtral-8x22b-smoke",
                     "mixtral-8x22b-smoke/dense"),
                    ("whisper-small-smoke", "mixtral-8x22b-smoke/e2",
                     "mixtral-8x22b-smoke/e2-dense",
                     "deepseek-moe-16b-smoke/w8"))
#: sharded against unsharded logits, relative to max|logit|
LOGIT_TOL = 1e-5
#: the cases whose train step also runs unsharded in f64
F64_CASES = ("whisper-small-smoke",)
MESHES = ["1x4", "2x2"]
B, S, MAX_LEN, STEPS, FRAMES, TRAIN_S = 2, 40, 48, 3, 24, 32

#: each process builds a case's config the same way (the two packages'
#: ``get_config`` and ``dataclasses.replace``)
_CASE_CONFIG = r'''
import dataclasses, os
def case_config(get_config, arch, experts, opts, layers):
    os.environ["REPRO_OPTS"] = opts
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    return cfg
'''

# one rank of the gloo world: every case on both meshes; rank 0 saves
_WORKER = _CASE_CONFIG + r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch.dryrun import _batch_axes
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.models import moe as M
from repro_torch.models import registry as R
from repro_torch.models.param import leaves, tree_map, unflatten
from repro_torch.training import train_step as TS
from repro_torch.training.optimizer import OptConfig, init_opt_state

rank, port, inp, out, cases, meshes = sys.argv[1:]
rank = int(rank)
cases = json.loads(cases)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=4)
data = np.load(inp)


def tree(prefix):
    return unflatten((tuple(k[len(prefix):].split("/")),
                      torch.from_numpy(data[k].copy()))
                     for k in data.files if k.startswith(prefix))


def full(x):
    return x.full_tensor() if SH.is_dtensor(x) else x


def placed(t, spec_tree, mesh, dm, rules):
    return SH.distribute_tree(
        t, SH.tree_shardings(spec_tree, t, mesh, rules), dm)


routes, keeps, grads = [], [], {}
real_router, real_slots, real_update = M._router, M._queue_slots, \
    TS.adamw_update


def spy(cfg, p, x):
    out = real_router(cfg, p, x)
    routes.append(out[0].clone())
    return out


def slots_spy(idx, e, cap):
    out = real_slots(idx, e, cap)
    keeps.append(out[1].clone())
    return out


def update_spy(params, g, opt_state, cfg):
    # the gradients the train step hands the optimizer, gathered whole
    grads.update((path, full(t).float().numpy()) for path, t in leaves(g))
    return real_update(params, g, opt_state, cfg)


M._router, M._queue_slots, TS.adamw_update = spy, slots_spy, update_spy
saved = {}
for case, (arch, experts, opts, train, layers, impl) in cases.items():
    cfg = case_config(get_config, arch, experts, opts, layers)
    params = tree(f"{case}/p/")
    batch = {k: torch.from_numpy(data[f"{case}/{k}"])
             for k in ("tokens", "frames") if f"{case}/{k}" in data.files}
    forced = torch.from_numpy(data[f"{case}/forced"])
    for m in meshes.split(","):
        mesh = Mesh(tuple(int(v) for v in m.split("x")), ("data", "model"))
        dm = device_mesh(mesh, "cpu")
        prules, arules = SH.strategy_rules("tp")
        axes = R.param_axes(cfg)
        dp = placed(params, axes, mesh, dm, prules)
        db = placed(batch, _batch_axes(batch), mesh, dm, arules)
        routes.clear()
        keeps.clear()
        with SH.mesh_context(mesh, arules, dm), torch.no_grad():
            logits, cache, pos = R.prefill(cfg, dp, db, 48, moe_impl=impl)
            outs = [full(logits)]
            for i in range(forced.shape[0]):
                logits, cache = R.decode_step(cfg, dp, cache, forced[i], pos,
                                              moe_impl=impl)
                outs.append(full(logits))
                pos = pos + 1
        saved[f"{case}/{m}/logits"] = torch.stack(outs).numpy()
        for i, r in enumerate(routes):
            saved[f"{case}/{m}/route{i}/rank{rank}"] = r.numpy()
        for i, r in enumerate(keeps):
            saved[f"{case}/{m}/keep{i}/rank{rank}"] = r.numpy()
        if not train:
            continue
        tb = {"tokens": torch.from_numpy(data[f"{case}/train_tokens"]),
              "targets": torch.from_numpy(data[f"{case}/targets"])}
        if "frames" in batch:
            tb["frames"] = batch["frames"]
        prules, arules = SH.strategy_rules("sp")
        ocfg = OptConfig()
        opt = init_opt_state(params, ocfg)
        tp = placed(tree_map(torch.clone, params), axes, mesh, dm, prules)
        to = {"m": placed(opt["m"], axes, mesh, dm, prules),
              "v": placed(opt["v"], axes, mesh, dm, prules),
              "step": SH.distribute_tree(opt["step"], (), dm)}
        dtb = placed(tb, _batch_axes(tb), mesh, dm, arules)
        grads.clear()
        with SH.mesh_context(mesh, arules, dm):
            _, _, metrics = TS.make_train_step(cfg, ocfg, moe_impl=impl)(
                tp, to, dtb)
        saved[f"{case}/{m}/train"] = np.array(
            [float(full(metrics["loss"])), float(full(metrics["grad_norm"]))])
        if rank == 0:
            for path, g in grads.items():
                saved[f"{case}/{m}/grad/" + "/".join(path)] = g
gathered = [None] * 4
dist.all_gather_object(gathered, saved)
if rank == 0:
    merged = {}
    for s in gathered:
        merged.update(s)
    np.savez(out, **merged)
dist.destroy_process_group()
'''

# the reference's sharded prefill and decode on 4 forced host devices
_REFERENCE = _CASE_CONFIG + r'''
import os, sys, json
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           + os.environ.get("XLA_FLAGS", ""))
import functools
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding
from repro.configs.base import get_config
from repro.distributed.sharding import (mesh_context, spec_for,
                                        strategy_rules, tree_shardings)
from repro.models import registry as JR

inp, out, cases, meshes = sys.argv[1:]
data = np.load(inp)
saved, failed = {}, {}
for case, (arch, experts, opts, _, layers, impl) in json.loads(
        cases).items():
    cfg = case_config(get_config, arch, experts, opts, layers)
    params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        JR.init_params(cfg, jax.random.PRNGKey(0)))
    abstract = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    batch = {k: data[f"{case}/{k}"] for k in ("tokens", "frames")
             if f"{case}/{k}" in data.files}
    for m in ["1x1"] + meshes.split(","):
        shape = tuple(int(v) for v in m.split("x"))
        mesh = Mesh(np.array(jax.devices()[:np.prod(shape)]).reshape(shape),
                    ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        prules, arules = strategy_rules("tp")
        try:
            ps = jax.device_put(params, tree_shardings(
                JR.param_axes(cfg), abstract, mesh, prules))
            bs = {k: jax.device_put(v, NamedSharding(mesh, spec_for(
                v.shape, ("batch", "seq", None)[:v.ndim], arules, mesh)))
                for k, v in batch.items()}
            with mesh_context(mesh, arules):
                logits, cache, pos = jax.jit(functools.partial(
                    JR.prefill, cfg, max_len=48, impl="ref",
                    moe_impl=impl))(ps, bs)
                outs = [np.asarray(logits)]
                dec = jax.jit(functools.partial(JR.decode_step, cfg,
                                                impl="ref", moe_impl=impl))
                for tok in data[f"{case}/forced"]:
                    logits, cache = dec(ps, cache, jnp.asarray(tok), pos)
                    outs.append(np.asarray(logits))
                    pos = pos + 1
        except Exception as e:
            failed[f"{case}/{m}"] = f"{type(e).__name__}: {e}"[:300]
            continue
        saved[f"{case}/{m}/logits"] = np.stack(outs)
np.savez(out, failed=json.dumps(failed), **saved)
'''


def _case_config(case: str, jax_side: bool):
    arch, experts, _, _, layers, _ = CASES[case]
    cfg = (jax_config if jax_side else get_config)(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if experts:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    return cfg


def _jax_params(case: str):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)
                             if jnp.issubdtype(a.dtype, jnp.floating)
                             else a),
        JR.init_params(_case_config(case, True), jax.random.PRNGKey(0)))


def _inputs(case: str, seed: int) -> dict:
    cfg = _case_config(case, False)
    r = np.random.default_rng(seed)
    v = cfg.vocab_size
    d = {"tokens": r.integers(0, v, (B, S)).astype(np.int32),
         "forced": r.integers(0, v, (STEPS, B)).astype(np.int32),
         "train_tokens": r.integers(0, v, (B, TRAIN_S)).astype(np.int32)}
    d["targets"] = np.roll(d["train_tokens"], -1, axis=1).astype(np.int32)
    if cfg.enc_dec:
        d["frames"] = r.normal(size=(B, FRAMES, R.FRONTEND_DIMS["frame"])
                               ).astype(np.float32)
    return d


def _ulp_off(tree, seed: int = 7):
    """Every f32 leaf of ``tree`` moved one ulp up or down (a seeded
    coin), as chip_smoke's ``_ulp_off``."""
    g = torch.Generator().manual_seed(seed)

    def bump(t):
        if t.dtype != torch.float32:
            return t
        up = torch.rand(t.shape, generator=g) < 0.5
        inf = torch.tensor(math.inf)
        return torch.where(up, torch.nextafter(t, inf),
                           torch.nextafter(t, -inf))
    return P.tree_map(bump, tree)


def _unsharded(case: str, params: dict, x: dict, dtype=None) -> dict:
    """The port unsharded: prefill and decode "logits" (steps + 1, B, V),
    the train step's "train" [loss, gradient norm] (or None) and "grads"
    (leaf path -> the gradient the step hands the optimizer, as f64),
    the router's choices ("routes") and the dispatch's keep masks
    ("keeps") at every MoE call of the prefill and the decode steps.
    ``dtype``: the train step alone, the f32 leaves and frames cast to
    it."""
    cfg = _case_config(case, False)
    impl = CASES[case][5]
    batch = {k: torch.from_numpy(x[k]) for k in ("tokens", "frames")
             if k in x}
    out = {"routes": [], "keeps": [], "grads": {}, "train": None}
    real = (M._router, M._queue_slots, TS.adamw_update)

    def spy(cfg, p, x):
        got = real[0](cfg, p, x)
        out["routes"].append(got[0].clone().numpy())
        return got

    def slots_spy(idx, e, cap):
        got = real[1](idx, e, cap)
        out["keeps"].append(got[1].clone().numpy())
        return got

    def update_spy(params, g, opt_state, cfg):
        out["grads"] = {path: t.double().numpy() for path, t in P.leaves(g)}
        return real[2](params, g, opt_state, cfg)
    M._router, M._queue_slots, TS.adamw_update = spy, slots_spy, update_spy
    try:
        if dtype is None:
            with torch.no_grad():
                logits, cache, pos = R.prefill(cfg, params, batch, MAX_LEN,
                                               moe_impl=impl)
                outs = [logits]
                for tok in x["forced"]:
                    logits, cache = R.decode_step(
                        cfg, params, cache, torch.from_numpy(tok), pos,
                        moe_impl=impl)
                    outs.append(logits)
                    pos = pos + 1
            out["logits"] = torch.stack(outs).numpy()
        n_routes, n_keeps = len(out["routes"]), len(out["keeps"])
        if CASES[case][3]:
            tb = {"tokens": torch.from_numpy(x["train_tokens"]),
                  "targets": torch.from_numpy(x["targets"])}
            if "frames" in batch:
                tb["frames"] = batch["frames"]
            params = P.tree_map(torch.clone, params)
            if dtype is not None:
                params = P.tree_map(lambda t: t.to(dtype) if t.dtype ==
                                    torch.float32 else t, params)
                tb = {k: t.to(dtype) if t.is_floating_point() else t
                      for k, t in tb.items()}
            ocfg = OptConfig()
            _, _, m = TS.make_train_step(cfg, ocfg, moe_impl=impl)(
                params, init_opt_state(params, ocfg), tb)
            out["train"] = np.array([float(m["loss"]),
                                     float(m["grad_norm"])])
    finally:
        M._router, M._queue_slots, TS.adamw_update = real
    del out["routes"][n_routes:], out["keeps"][n_keeps:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded port (4 gloo ranks), the reference's sharded run (JAX
    subprocesses, the cases split between them) and the unsharded port,
    on the same inputs; and each case's bounds against the unsharded
    port: ``max(1e-5, 2 u)``, u how far the unsharded run moves with
    every f32 weight one ulp off (the logits relative to max|logit| over
    every step; the loss and the gradient norm relative)."""
    import json
    d = tmp_path_factory.mktemp("sharded_families")
    saved_opts = os.environ.get("REPRO_OPTS")
    flat, inputs, params = {}, {}, {}
    try:
        for i, case in enumerate(CASES):
            os.environ["REPRO_OPTS"] = CASES[case][2]
            inputs[case] = _inputs(case, 10 + i)
            for k, v in inputs[case].items():
                flat[f"{case}/{k}"] = v
            params[case] = _jax_params(case)
            for path, leaf in P.leaves(params[case]):
                flat[f"{case}/p/" + "/".join(path)] = leaf
        inp = d / "inputs.npz"
        np.savez(inp, **flat)
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu",
                   OMP_NUM_THREADS="1")
        # the reference's compiles take most of the file's time; LLVM's
        # optimisation level moves no value (XLA's own passes still run)
        env["XLA_FLAGS"] = ("--xla_backend_optimization_level=0 "
                            + env.get("XLA_FLAGS", ""))
        env.pop("REPRO_OPTS", None)
        port, meshes = _free_port(), ",".join(MESHES)
        procs = [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), str(port), str(inp),
             str(d / "port.npz"), json.dumps(CASES), meshes], env=env,
            cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(4)]
        procs += [subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(inp),
             str(d / f"ref{i}.npz"),
             json.dumps({c: CASES[c] for c in group}), meshes],
            env=env, cwd=d, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for i, group in enumerate(REFERENCE_GROUPS)]

        plain, bounds = {}, {}
        for case in CASES:
            os.environ["REPRO_OPTS"] = CASES[case][2]
            p = P.from_numpy(params[case])
            plain[case] = want = _unsharded(case, p, inputs[case])
            ulp = _unsharded(case, _ulp_off(p), inputs[case])
            u = max(_rel(a, b) for a, b in zip(ulp["logits"],
                                               want["logits"]))
            bound = {"logits": LOGIT_TOL, "ulp": 2 * u}
            if want["train"] is not None:
                bound["train"] = np.maximum(1e-5, 2 * np.abs(
                    ulp["train"] - want["train"]) / np.abs(want["train"]))
                bound["grads"] = {
                    path: max(1e-5, 2 * _norm_rel(ulp["grads"][path], g))
                    for path, g in want["grads"].items()}
            if case in F64_CASES:
                want["grads64"] = _unsharded(case, p, inputs[case],
                                             torch.float64)["grads"]
            bounds[case] = bound
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        if saved_opts is None:
            os.environ.pop("REPRO_OPTS", None)
        else:
            os.environ["REPRO_OPTS"] = saved_opts
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    ref = {}
    for i in range(len(REFERENCE_GROUPS)):
        r = np.load(d / f"ref{i}.npz")
        ref.update({k: r[k] for k in r.files if k != "failed"})
        ref.setdefault("failed", {}).update(json.loads(str(r["failed"])))
    return np.load(d / "port.npz"), ref, plain, bounds


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_family_logits_equal_unsharded(runs, case, mesh):
    port_runs, _, plain, bounds = runs
    got, want = port_runs[f"{case}/{mesh}/logits"], plain[case]["logits"]
    assert got.shape == want.shape == (
        STEPS + 1, B, _case_config(case, False).vocab_size)
    assert _rel(got, want) <= bounds[case]["logits"]
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_family_logits_equal_reference_sharded(runs, case, mesh):
    port_runs, ref_runs, plain, bounds = runs
    assert not ref_runs["failed"], ref_runs["failed"]
    got, want = port_runs[f"{case}/{mesh}/logits"], ref_runs[
        f"{case}/{mesh}/logits"]
    port_plain = plain[case]["logits"]
    ref_plain = ref_runs[f"{case}/1x1/logits"]
    assert got.shape == want.shape == ref_plain.shape
    assert _rel(got[0], want[0]) <= max(1e-4, bounds[case]["ulp"])
    assert (got.argmax(-1) == want.argmax(-1)).all()
    for i in range(1, STEPS + 1):
        # the triangle through the two unsharded runs, in max|error|:
        # the port's sharded-vs-unsharded bound, the packages' unsharded
        # gap, the reference's own sharded-vs-unsharded gap
        allowed = (bounds[case]["logits"] * np.abs(port_plain[i]).max()
                   + _err(port_plain[i], ref_plain[i])
                   + _err(want[i], ref_plain[i]))
        assert _err(got[i], want[i]) <= allowed, i


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][3]])
def test_sharded_family_train_step_equal_unsharded(runs, case, mesh):
    port_runs, _, plain, bounds = runs
    got, want = port_runs[f"{case}/{mesh}/train"], plain[case]["train"]
    assert (np.abs(got - want) <= bounds[case]["train"] * np.abs(want)).all()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][3]])
def test_sharded_family_gradients_equal_unsharded_per_leaf(runs, case,
                                                           mesh):
    """The gradient the sharded train step hands the optimizer, gathered
    whole, leaf by leaf against the unsharded step's: within ``max(1e-5,
    2 u)`` of the leaf's norm, u how far that leaf's gradient moves with
    every f32 weight one ulp off."""
    port_runs, _, plain, bounds = runs
    want = plain[case]["grads"]
    assert want
    for path, g in want.items():
        got = port_runs[f"{case}/{mesh}/grad/" + "/".join(path)]
        assert got.shape == g.shape, path
        assert _norm_rel(got, g) <= bounds[case]["grads"][path], path


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", F64_CASES)
def test_sharded_gradients_as_close_to_f64_as_unsharded(runs, case, mesh):
    """whisper-smoke's gradients move 1e-3 of their norm with one ulp of
    its weights because its f32 train step is only that accurate: the
    unsharded f32 gradient lies about as far from the same step run in
    f64 (the attention softmax's backward cancels where the scores
    saturate it).  The sharded f32 gradient, leaf by leaf, lies no
    farther from the f64 one than twice the unsharded f32 gradient does,
    or 1e-5 of its norm."""
    port_runs, _, plain, _ = runs
    want, exact = plain[case]["grads"], plain[case]["grads64"]
    assert exact.keys() == want.keys()
    for path, g64 in exact.items():
        got = port_runs[f"{case}/{mesh}/grad/" + "/".join(path)]
        own = np.linalg.norm(want[path] - g64)
        assert np.linalg.norm(got - g64) <= max(
            1e-5 * np.linalg.norm(g64), 2 * own), path


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("case", MOE_CASES)
def test_sharded_router_choices_equal_unsharded_on_every_rank(runs, case,
                                                              mesh):
    """Every rank routes its batch rows over all the experts: its top-k
    choices at every MoE call equal the unsharded run's rows, so its
    queue slots and the assignments it drops are the same."""
    port_runs, _, plain, _ = runs
    want, want_keeps = plain[case]["routes"], plain[case]["keeps"]
    data = 2 if mesh == "2x2" else 1
    assert len(want) > 0
    # the dense form drops nothing: it has no queues
    assert len(want_keeps) == (0 if CASES[case][5] == "dense"
                               else len(want))
    for rank in range(4):
        rows = slice(None) if data == 1 else (
            slice(0, B // 2) if rank < 2 else slice(B // 2, B))
        for i, w in enumerate(want):
            got = port_runs[f"{case}/{mesh}/route{i}/rank{rank}"]
            assert (got == w[rows]).all(), (rank, i)
        for i, w in enumerate(want_keeps):
            got = port_runs[f"{case}/{mesh}/keep{i}/rank{rank}"]
            assert (got == w[rows]).all(), (rank, i)
        assert f"{case}/{mesh}/route{len(want)}/rank{rank}" not in port_runs
        assert f"{case}/{mesh}/keep{len(want_keeps)}/rank{rank}" \
            not in port_runs


def _err(a, b) -> float:
    return float(np.abs(a - b).max())


def _norm_rel(got, want) -> float:
    """|got - want| over |want| (Frobenius); 0 where both are zero."""
    diff, norm = np.linalg.norm(got - want), np.linalg.norm(want)
    return float(diff / norm) if norm else (0.0 if diff == 0 else math.inf)
