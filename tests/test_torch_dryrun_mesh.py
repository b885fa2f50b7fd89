"""The dry-run on a mesh (``repro_torch.launch.dryrun``): the cell's real
step as one rank of the mesh, over the fake process group
(``distributed.sharding.fake_world``), on DTensors of ``meta`` shards.

Every figure below is held EQUAL unless it says otherwise.

* The argument bytes of a mesh's record are the bytes of the local
  shards the step's DTensor arguments hold, on (1, 4), 16x16 and
  2x16x16.
* phi3-smoke prefill at B2 x S64 on (2, 2), where batch, heads, KV heads
  (2), MLP and vocabulary all divide: the per-device FLOPs times the
  mesh size are the one-card FLOPs.  On (1, 4) the smoke config's 2 KV
  heads stay replicated, so every rank computes the whole K and V
  projections: the per-device FLOPs times 4 are the one-card FLOPs plus
  three more copies of those two products.
* The collectives, derived from the config and the layout: one
  all-reduce of the rank's ``B x S x D`` after each row-parallel product
  (the attention's output projection and the MLP's ``wo``, two a layer)
  and one after the embedding's masked lookup on the vocabulary shards;
  on (2, 2) also one all-gather a weight with an ``embed`` dim sharded
  over ``data`` (FSDP: gathered where it is used, since the batch rides
  ``data`` too), of the weight's shard with ``data`` gathered: the
  embedding table, per layer the two norm scales, q, k, v, o, wi_0,
  wi_1 and wo, the final norm's scale and the unembedding; and one
  all-to-all a layer for each of the prefill's K and V caches, which
  move from the KV-head shard of the attention to the slot shard of the
  decode cache (``kv_seq`` takes ``model``; on (1, 4) the KV heads are
  replicated and the move is a local slice).  No other collective runs:
  the logits stay sharded over the vocabulary and the attention runs on
  each rank's heads.
* phi3-smoke ``decode_32k`` on 16x16, the port's record beside the
  reference's own per-device record (its dry-run in a subprocess, on a
  mesh built with ``axis_types=Auto``: its ``make_mesh`` gives Explicit
  axes on jax 0.9.0, which its ``with_sharding_constraint`` refuses):
  the argument bytes are equal.  FLOPs and collectives are printed, not
  equated: XLA counts element-wise FLOPs and fuses, and GSPMD chooses
  its own collectives.
* ``--single-pod-only`` writes the 16x16 file alone; ``load_results``
  reads a mesh's files and ``analyze`` gives them a collective term.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import ShapeCell, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.models import param as P
from repro_torch.models import registry as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHI3 = "phi3-mini-3.8b-smoke"
PREFILL = ShapeCell("p", "prefill", 64, 2)
CELLS = {"train": ShapeCell("t", "train", 64, 2), "prefill": PREFILL,
         "decode": ShapeCell("d", "decode", 64, 4)}
M14, M22 = Mesh((1, 4), ("data", "model")), Mesh((2, 2), ("data", "model"))


def _count(cfg, cell, mesh):
    strategy = dryrun.DEFAULT_STRATEGY[cell.kind]
    step, args, specs = dryrun.build_cell(cfg, cell, mesh, strategy)
    if mesh.size == 1:
        return dryrun.count_step(step, args)
    return dryrun.count_sharded_step(step, args, specs, mesh, strategy)


@pytest.mark.parametrize("mesh", [M14, dryrun.MESHES["pod"],
                                  dryrun.MESHES["multipod"]],
                         ids=["1x4", "pod", "multipod"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_argument_bytes_are_the_local_shards(kind, mesh):
    cfg = get_config(PHI3)
    cell = dataclasses.replace(CELLS[kind], global_batch=32)
    step, args, specs = dryrun.build_cell(cfg, cell, mesh,
                                          dryrun.DEFAULT_STRATEGY[kind])
    want = dryrun.argument_bytes(args, specs, mesh)
    with SH.fake_world(mesh.size):
        dm = device_mesh(mesh, "cuda")
        dargs = [SH.distribute_tree(a, s, dm) for a, s in zip(args, specs)]
        got = sum(t.to_local().numel() * t.element_size()
                  for a in dargs for t in dryrun._tensors(a))
    assert got == want


def test_named_sharding_is_the_placements_of_spec_for():
    """``named_sharding`` on a ``DeviceMesh`` of the fake world: the
    placements of ``spec_for`` on the mesh it describes, for a weight and
    an activation on (2, 2) and 16x16."""
    for mesh in (M22, dryrun.MESHES["pod"]):
        with SH.fake_world(mesh.size):
            dm = device_mesh(mesh, "cuda")
            assert SH.describe(dm) == mesh
            for shape, axes, rules in (
                    ((4096, 32, 128), ("embed", "heads", "head_dim"),
                     SH.PARAM_RULES),
                    ((32, 32768, 8, 128), ("batch", "kv_seq", "kv_heads",
                                           "head_dim"), SH.ACT_RULES)):
                assert SH.named_sharding(shape, axes, dm, rules) == \
                    SH.placements(SH.spec_for(shape, axes, rules, mesh), dm)


def _kv_proj_flops(cfg, tokens: int) -> int:
    return 2 * 2 * tokens * cfg.d_model * cfg.num_kv_heads * \
        cfg.resolved_head_dim


def test_per_device_flops_times_mesh_are_one_card_flops():
    cfg = get_config(PHI3)
    card = _count(cfg, PREFILL, dryrun.MESHES["card"])["flops"]
    assert card == 23_134_208
    assert _count(cfg, PREFILL, M22)["flops"] * 4 == card
    # (1, 4): KV = 2 does not divide 4: K and V projected on every rank
    kv = cfg.num_layers * _kv_proj_flops(cfg, 2 * 64)
    assert _count(cfg, PREFILL, M14)["flops"] * 4 == card + 3 * kv


def _fsdp_gathers(cfg, mesh):
    """(count, result bytes) of the all-gathers of phi3-smoke's prefill on
    ``mesh``: each weight with an ``embed`` dim sharded over ``data``,
    gathered over ``data`` where the prefill uses it (the stacked layer
    weights once a layer, the vocabulary table twice: the lookup and the
    unembedding are two leaves here, ``embed`` and ``unembed``)."""
    prules, _ = SH.strategy_rules("tp")
    specs = R.model_specs(cfg)
    n, nbytes = 0, 0
    for path, s in P.leaves(specs):
        spec = SH.spec_for(s.shape, s.axes, prules, mesh)
        if not any("data" in ax for ax in spec):
            continue
        gathered = tuple(tuple(a for a in ax if a != "data") for ax in spec)
        shape = SH.local_shape(s.shape, gathered, mesh)
        layers = shape[0] if path[0] == "groups" else 1
        per_use = math.prod(shape[1:] if path[0] == "groups" else shape)
        n += layers
        nbytes += layers * per_use * torch.tensor(
            [], dtype=s.dtype).element_size()
    return n, nbytes


@pytest.mark.parametrize("mesh", [M14, M22], ids=["1x4", "2x2"])
def test_collectives_are_what_the_layout_implies(mesh):
    cfg = get_config(PHI3)
    coll = _count(cfg, PREFILL, mesh)["collectives"]
    b_local = 2 // mesh.sizes["data"]
    act = b_local * 64 * cfg.d_model * 2                  # bf16 (B, S, D)
    n_reduce = 1 + 2 * cfg.num_layers
    want_counts = {"all-reduce": n_reduce}
    want_bytes = {"all-reduce": float(n_reduce * act)}
    n_gather, gather_bytes = _fsdp_gathers(cfg, mesh)
    if n_gather:
        assert n_gather == 1 + 9 * cfg.num_layers + 2
        want_counts["all-gather"] = n_gather
        want_bytes["all-gather"] = float(gather_bytes)
    if cfg.num_kv_heads % mesh.sizes["model"] == 0:
        # (B_local, S / model, KV, hd) bf16, for K and V, a layer
        cache = b_local * 64 // mesh.sizes["model"] * cfg.num_kv_heads * \
            cfg.resolved_head_dim * 2
        want_counts["all-to-all"] = 2 * cfg.num_layers
        want_bytes["all-to-all"] = float(2 * cfg.num_layers * cache)
    assert coll["counts"] == want_counts
    assert coll["bytes_by_op"] == want_bytes
    assert coll["total_bytes"] == sum(want_bytes.values())


_REFERENCE = r'''
import json, sys
import repro.launch.dryrun as D          # sets the 512-device flag first
import jax
import numpy as np
from jax.sharding import AxisType, Mesh


def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, names, axis_types=(AxisType.Auto,) * len(shape))


D.make_production_mesh = auto_mesh
r = D.run_cell(sys.argv[1], sys.argv[2], False, save=False)
print(json.dumps(r))
'''


def test_phi3_smoke_decode_32k_on_16x16_beside_the_reference():
    pytest.importorskip("jax")
    ours = dryrun.run_cell(PHI3, "decode_32k", mesh="pod", save=False)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, PHI3,
                          "decode_32k"], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    theirs = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"port      flops {ours['flops']:.6e} bytes "
          f"{ours['bytes_accessed']:.6e} collectives "
          f"{ours['collectives']['bytes_by_op']} "
          f"{ours['collectives']['counts']}")
    print(f"reference flops {theirs['flops']:.6e} bytes "
          f"{theirs['bytes_accessed']:.6e} collectives "
          f"{theirs['collectives']['bytes_by_op']} "
          f"{theirs['collectives']['counts']}")
    assert ours["memory"]["argument_size_in_bytes"] == \
        theirs["memory"]["argument_size_in_bytes"]
    assert ours["chips"] == theirs["chips"] == 256
    assert ours["flops"] > 0 and theirs["flops"] > 0
    assert ours["collectives"]["total_bytes"] > 0


def test_single_pod_only_and_the_pod_roofline(tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr(roofline, "ARTIFACT_DIR", str(tmp_path))
    dryrun.main(["--arch", PHI3, "--shape", "decode_32k", "--both",
                 "--single-pod-only"])
    out = capsys.readouterr().out
    assert out.startswith(f"OK   {PHI3} x decode_32k x 16x16:")
    assert "coll=" in out and "1 cells in" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"{PHI3}_decode_32k_pod.json"]
    [r] = roofline.load_results(mesh="pod")
    assert roofline.load_results() == [] and \
        roofline.load_results(multi_pod=True) == []
    a = roofline.analyze(r)
    assert a.collective_s > 0 and a.compute_s > 0 and a.memory_s > 0
    assert a.collective_s == sum(
        b * roofline._WIRE_FACTOR[op]
        for op, b in r["collectives"]["bytes_by_op"].items()) / \
        roofline.LINK_BW
    assert f"{PHI3},decode_32k," in roofline.table(mesh="pod")


def test_a_failed_sharded_step_keeps_the_memory_record(monkeypatch,
                                                       tmp_path, capsys):
    """An arch whose sharded step raises keeps its argument bytes and
    names the failure; the CLI prints a FAIL line and exits non-zero."""
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))

    def broken(*a, **k):
        raise RuntimeError("aten.fake_op.default: no sharding strategy\n"
                           "more detail")
    monkeypatch.setattr(dryrun, "count_sharded_step", broken)
    r = dryrun.run_cell(PHI3, "decode_32k", mesh="pod", save=False)
    assert "flops" not in r and r["memory"]["argument_size_in_bytes"] > 0
    assert r["sharded_error"] == ("RuntimeError: aten.fake_op.default: no "
                                  "sharding strategy")
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", PHI3, "--shape", "decode_32k", "--both",
                     "--single-pod-only"])
    assert capsys.readouterr().out.startswith(
        f"FAIL {PHI3} x decode_32k x 16x16: sharded step: RuntimeError: "
        f"aten.fake_op.default")

