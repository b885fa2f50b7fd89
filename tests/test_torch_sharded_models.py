"""Sharded execution of the models: ``distributed.sharding.shard`` as a
DTensor constraint, the kernels on each rank's local shard and the
flash-decode across ranks (``kernels.ops``), on four gloo ranks.

Four processes (one gloo world, as ``test_torch_launch_tooling``'s
placements test opens its group) run phi3-smoke, llava-smoke (GQA: 4
query heads over 2 KV heads) and mamba2-smoke, and deepseek-moe-smoke
(the MoE dispatch on experts sharded over ``model``), in f32 with the
JAX package's parameters, on a (1, 4) and a (2, 2) mesh: a prefill of
40 tokens (llava behind an 8-patch prefix), 3 decode steps on a cache of
48 slots sharded along its slots, with the same forced tokens everywhere,
under the ``tp`` rules; one train step under ``sp`` (the dry-run's
strategies).

Tolerances, each held as stated:

* against the port unsharded: prefill and decode logits within 1e-5 of
  max|logit| with equal greedy tokens; the train step's loss and
  gradient norm within 1e-5 relative.  The sharded run differs only by
  the order of f32 sums (the all-reduces, the flash-decode's partials;
  measured at most 8e-7 of max|logit|);
* against the reference's own sharded run (the JAX package on 4 forced
  host devices, in a subprocess, on a mesh this test builds with
  ``axis_types=Auto``: its ``make_mesh`` gives Explicit axes on jax
  0.9.0, which its ``with_sharding_constraint`` refuses): the forward
  (prefill) logits within 1e-4 of max|logit| (the f32 contract; measured
  at most 7.4e-6), and equal greedy tokens at every step.  The decode
  steps' logits are held to the gaps the two packages show without the
  mesh: the port's sharded decode is no farther from the reference's
  sharded decode than the port's unsharded decode is from the
  reference's unsharded one, plus the reference's own sharded-vs-
  unsharded gap, plus 1e-5.  Both gaps are large on these smoke models
  and neither is the port's sharding: the bf16 decode cache turns f32
  differences of 1e-7 into bf16 steps, which the smoke models amplify
  (the two packages' unsharded decodes differ by up to 4e-3 of
  max|logit| by the third step; the reference's sharded flash-decode,
  which GSPMD partitions with other roundings, differs from its own
  unsharded one by up to 4.6e-3), while the port's sharded decode stays
  within 8e-7 of its unsharded one.

Also: ``shard`` returns the same object with no mesh and on a (1, 1)
mesh, raises for a plain tensor under a (1, 4) mesh, and the plain
versions' two rounds of the flash-decode over two slices of a cache equal
one call over the whole.
"""
from __future__ import annotations

import os
import socket
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
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.training.optimizer import OptConfig, init_opt_state  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["phi3-mini-3.8b-smoke", "llava-next-mistral-7b-smoke",
         "mamba2-1.3b-smoke", "deepseek-moe-16b-smoke"]
MESHES = ["1x4", "2x2"]
B, S, MAX_LEN, STEPS, PATCHES, TRAIN_S = 2, 40, 48, 3, 8, 32

# one rank of the gloo world: every arch on both meshes; rank 0 saves
_WORKER = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs.base import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch.dryrun import _batch_axes
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.models import registry as R
from repro_torch.models.param import tree_map, unflatten
from repro_torch.training.optimizer import OptConfig, init_opt_state
from repro_torch.training.train_step import make_train_step

rank, port, inp, out, archs, meshes = sys.argv[1:]
rank = int(rank)
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


saved = {}
for arch in archs.split(","):
    cfg = get_config(arch)
    params = tree(f"{arch}/p/")
    batch = {"tokens": torch.from_numpy(data[f"{arch}/tokens"])}
    tb = {"tokens": torch.from_numpy(data[f"{arch}/train_tokens"]),
          "targets": torch.from_numpy(data[f"{arch}/targets"])}
    if f"{arch}/patch_embeds" in data.files:
        batch["patch_embeds"] = torch.from_numpy(data[f"{arch}/patch_embeds"])
        tb["patch_embeds"] = batch["patch_embeds"]
    forced = torch.from_numpy(data[f"{arch}/forced"])
    for m in meshes.split(","):
        mesh = Mesh(tuple(int(v) for v in m.split("x")), ("data", "model"))
        dm = device_mesh(mesh, "cpu")
        prules, arules = SH.strategy_rules("tp")
        axes = R.param_axes(cfg)
        dp = placed(params, axes, mesh, dm, prules)
        db = placed(batch, _batch_axes(batch), mesh, dm, arules)
        with SH.mesh_context(mesh, arules, dm), torch.no_grad():
            logits, cache, pos = R.prefill(cfg, dp, db, 48)
            outs = [full(logits)]
            for i in range(forced.shape[0]):
                logits, cache = R.decode_step(cfg, dp, cache, forced[i], pos)
                outs.append(full(logits))
                pos = pos + 1
        saved[f"{arch}/{m}/logits"] = torch.stack(outs).numpy()
        prules, arules = SH.strategy_rules("sp")
        ocfg = OptConfig()
        opt = init_opt_state(params, ocfg)
        tp = placed(tree_map(torch.clone, params), axes, mesh, dm, prules)
        to = {"m": placed(opt["m"], axes, mesh, dm, prules),
              "v": placed(opt["v"], axes, mesh, dm, prules),
              "step": SH.distribute_tree(opt["step"], (), dm)}
        dtb = placed(tb, _batch_axes(tb), mesh, dm, arules)
        with SH.mesh_context(mesh, arules, dm):
            _, _, metrics = make_train_step(cfg, ocfg)(tp, to, dtb)
        saved[f"{arch}/{m}/train"] = np.array(
            [float(full(metrics["loss"])), float(full(metrics["grad_norm"]))])
if rank == 0:
    np.savez(out, **saved)
dist.destroy_process_group()
'''

# the reference's sharded prefill and decode on 4 forced host devices
_REFERENCE = r'''
import os, sys
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

inp, out, archs, meshes = sys.argv[1:]
data = np.load(inp)
saved = {}
for arch in archs.split(","):
    cfg = get_config(arch)
    params = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32),
        JR.init_params(cfg, jax.random.PRNGKey(0)))
    abstract = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    batch = {"tokens": data[f"{arch}/tokens"]}
    if f"{arch}/patch_embeds" in data.files:
        batch["patch_embeds"] = data[f"{arch}/patch_embeds"]
    for m in ["1x1"] + meshes.split(","):
        shape = tuple(int(v) for v in m.split("x"))
        mesh = Mesh(np.array(jax.devices()[:np.prod(shape)]).reshape(shape),
                    ("data", "model"), axis_types=(AxisType.Auto,) * 2)
        prules, arules = strategy_rules("tp")
        ps = jax.device_put(params, tree_shardings(JR.param_axes(cfg),
                                                   abstract, mesh, prules))
        bs = {k: jax.device_put(v, NamedSharding(mesh, spec_for(
            v.shape, ("batch", "seq", None)[:v.ndim], arules, mesh)))
            for k, v in batch.items()}
        with mesh_context(mesh, arules):
            logits, cache, pos = jax.jit(functools.partial(
                JR.prefill, cfg, max_len=48, impl="ref"))(ps, bs)
            outs = [np.asarray(logits)]
            dec = jax.jit(functools.partial(JR.decode_step, cfg, impl="ref"))
            for tok in data[f"{arch}/forced"]:
                logits, cache = dec(ps, cache, jnp.asarray(tok), pos)
                outs.append(np.asarray(logits))
                pos = pos + 1
        saved[f"{arch}/{m}/logits"] = np.stack(outs)
np.savez(out, **saved)
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_params(arch: str):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)),
        JR.init_params(jax_config(arch), jax.random.PRNGKey(0)))


def _inputs(arch: str, seed: int) -> dict:
    r = np.random.default_rng(seed)
    v = get_config(arch).vocab_size
    d = {"tokens": r.integers(0, v, (B, S)).astype(np.int32),
         "forced": r.integers(0, v, (STEPS, B)).astype(np.int32),
         "train_tokens": r.integers(0, v, (B, TRAIN_S)).astype(np.int32)}
    targets = np.roll(d["train_tokens"], -1, axis=1)
    if get_config(arch).embed_frontend == "patch":
        d["patch_embeds"] = r.normal(size=(B, PATCHES, 1024)).astype(
            np.float32)
        targets = np.concatenate(
            [np.full((B, PATCHES), -1, np.int32), targets], axis=1)
    d["targets"] = targets.astype(np.int32)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded port (4 gloo ranks), the reference's sharded run (a JAX
    subprocess) and the unsharded port, on the same inputs."""
    d = tmp_path_factory.mktemp("sharded")
    flat, inputs = {}, {}
    for i, arch in enumerate(ARCHS):
        inputs[arch] = _inputs(arch, i)
        for k, v in inputs[arch].items():
            flat[f"{arch}/{k}"] = v
        for path, leaf in P.leaves(_jax_params(arch)):
            flat[f"{arch}/p/" + "/".join(path)] = leaf
    inp = d / "inputs.npz"
    np.savez(inp, **flat)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    port, archs, meshes = _free_port(), ",".join(ARCHS), ",".join(MESHES)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(port), str(inp),
         str(d / "port.npz"), archs, meshes], env=env, cwd=d,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    jref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(inp), str(d / "ref.npz"),
         archs, meshes], env=env, cwd=d, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    logs = [p.communicate(timeout=240)[0] for p in procs + [jref]]
    for p, log in zip(procs + [jref], logs):
        assert p.returncode == 0, log[-4000:]
    port_runs, ref_runs = np.load(d / "port.npz"), np.load(d / "ref.npz")

    plain = {}
    for arch in ARCHS:
        cfg, x = get_config(arch), inputs[arch]
        params = P.from_numpy(_jax_params(arch))
        batch = {"tokens": torch.from_numpy(x["tokens"])}
        if "patch_embeds" in x:
            batch["patch_embeds"] = torch.from_numpy(x["patch_embeds"])
        with torch.no_grad():
            logits, cache, pos = R.prefill(cfg, params, batch, MAX_LEN)
            outs = [logits]
            for tok in x["forced"]:
                logits, cache = R.decode_step(cfg, params, cache,
                                              torch.from_numpy(tok), pos)
                outs.append(logits)
                pos = pos + 1
        tb = {"tokens": torch.from_numpy(x["train_tokens"]),
              "targets": torch.from_numpy(x["targets"])}
        if "patch_embeds" in x:
            tb["patch_embeds"] = batch["patch_embeds"]
        ocfg = OptConfig()
        _, _, m = make_train_step(cfg, ocfg)(
            params, init_opt_state(params, ocfg), tb)
        plain[arch] = (torch.stack(outs).numpy(),
                       np.array([float(m["loss"]), float(m["grad_norm"])]))
    return port_runs, ref_runs, plain


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_logits_equal_unsharded(runs, arch, mesh):
    port_runs, _, plain = runs
    got, want = port_runs[f"{arch}/{mesh}/logits"], plain[arch][0]
    assert got.shape == want.shape == (STEPS + 1, B,
                                       get_config(arch).vocab_size)
    assert _rel(got, want) <= 1e-5
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_logits_equal_reference_sharded(runs, arch, mesh):
    port_runs, ref_runs, plain = runs
    got, want = port_runs[f"{arch}/{mesh}/logits"], ref_runs[
        f"{arch}/{mesh}/logits"]
    port_plain, ref_plain = plain[arch][0], ref_runs[f"{arch}/1x1/logits"]
    assert got.shape == want.shape == ref_plain.shape
    assert _rel(got[0], want[0]) <= 1e-4
    assert (got.argmax(-1) == want.argmax(-1)).all()
    for i in range(1, STEPS + 1):
        allowed = (_rel(port_plain[i], ref_plain[i])
                   + _rel(want[i], ref_plain[i]) + 1e-5)
        assert _rel(got[i], want[i]) <= allowed, i


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_equal_unsharded(runs, arch, mesh):
    port_runs, _, plain = runs
    loss, gnorm = port_runs[f"{arch}/{mesh}/train"]
    want_loss, want_gnorm = plain[arch][1]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert abs(gnorm - want_gnorm) <= 1e-5 * abs(want_gnorm)


def test_shard_returns_the_same_object_off_a_larger_mesh():
    x = torch.ones(2, 8, 4)
    assert SH.shard(x, "batch", "seq", "embed") is x
    with SH.mesh_context(Mesh((1, 1), ("data", "model"))):
        assert SH.shard(x, "batch", "seq", "embed") is x


def test_plain_tensor_under_a_larger_mesh_raises():
    with SH.mesh_context(Mesh((1, 4), ("data", "model"))):
        with pytest.raises(TypeError, match=r"shard\('batch', 'seq', "
                                            r"'embed'\).*\(1, 4\) mesh"):
            SH.shard(torch.ones(2, 8, 4), "batch", "seq", "embed")
    assert SH.current_mesh() is None


@pytest.mark.parametrize("window", [None, 5])
def test_two_round_flash_decode_over_slices_equals_one_call(window):
    """The plain versions' LSE output and LSE input over two slices of a
    cache, merged as ``kernels.ops`` merges ranks, equal one call over
    the whole cache within one bf16 step of the output (the f32 sums run
    in another order); a slice with no valid slot adds zeros."""
    g = torch.Generator().manual_seed(0)
    b, t, h, kv, hd = 3, 32, 8, 2, 16
    q = torch.randn(b, h, hd, generator=g)
    k = torch.randn(b, t, kv, hd, generator=g).bfloat16()
    v = torch.randn(b, t, kv, hd, generator=g).bfloat16()
    lengths = torch.tensor([32, 20, 9], dtype=torch.int32)  # row 2: slice 2 empty
    kp = torch.arange(t, dtype=torch.int32).expand(b, t)
    args = dict(lengths=lengths, q_pos=lengths - 1, window=window)
    whole = ref.decode_attention(q, k, v, key_positions=kp, **args)
    cuts = [slice(0, 16), slice(16, 32)]
    lses = torch.stack([ref.decode_attention(
        q, k[:, c], v[:, c], key_positions=kp[:, c], lse_only=True, **args)
        for c in cuts])
    assert lses.dtype == torch.float32 and lses.shape == (2, b, h)
    assert (lses[1, 2] < -1e29).all()          # no valid slot there
    L = torch.logsumexp(lses, dim=0)
    want_l = torch.logsumexp(torch.where(
        ((kp < lengths[:, None]) & (kp >= 0) & (
            kp > (lengths[:, None] - 1 - window) if window else True))[
            :, None, None],
        torch.einsum("bkgd,btkd->bkgt", q.reshape(b, kv, h // kv, hd),
                     k.float()) * hd ** -0.5, ref.NEG_INF), dim=-1)
    assert torch.allclose(L, want_l.reshape(b, h), rtol=1e-6, atol=1e-5)
    parts = [ref.decode_attention(q, k[:, c], v[:, c], key_positions=kp[:, c],
                                  lse=L, **args) for c in cuts]
    assert parts[1][2].abs().max() == 0
    merged = (parts[0] + parts[1]).to(torch.bfloat16)
    step = whole.float().abs().clamp(min=1e-3) * 2.0 ** -7
    assert ((merged.float() - whole.float()).abs() <= step).all()
