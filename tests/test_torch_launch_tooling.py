"""The port's launch and distribution tooling against the JAX package's.

Tolerances: everything is held EQUAL (shapes, dtypes, axes, specs,
shard shapes, byte counts, model FLOPs, the attention term, table text),
except the roofline's three terms, which divide by other devices'
figures: ``compute_s * peak``, ``memory_s * HBM rate`` and
``collective_s * link rate`` are held within rel 1e-15 (one division
and one product apart, a couple of ulps) of the reference's.

* configs: the shape cells, ``shapes_for``, ``list_configs``,
  ``param_count`` and ``attn_free`` for all ten archs;
* specs: ``batch_specs``/``decode_specs`` (meta tensors) against the
  reference's ``ShapeDtypeStruct``s, every arch x ``shapes_for`` cell;
* abstract trees: ``abstract_params``, ``param_axes``, ``tree_bytes``,
  ``abstract_opt_state``;
* ``spec_for`` entry for entry, every param, batch and cache leaf of
  every arch, under ``tp``/``tp_infer``/``sp`` on (1,1), (16,16) and
  (2,16,16) (JAX's reads only ``axis_names`` and ``devices.shape``, so a
  duck-typed mesh serves), and its hypothesis twin;
* local shard shapes against ``NamedSharding(...).shard_shape`` in a
  subprocess with 512 host devices, one arch per family;
* the roofline: ``_attn_flops_per_token`` and ``model_flops_for`` bit-equal
  for every arch x cell x chips in {1, 256, 512}; ``analyze`` on the same
  result dicts;
* ``arch_profile`` and ``decode_step_time_fallback`` against their
  formulas (one H100's HBM rate);
* render: ``_replace`` and ``dryrun_table`` text equal to the reference's
  on the same dicts (the reference's in a subprocess: its dry-run module
  sets ``XLA_FLAGS`` when imported);
* DTensor placements on a one-process gloo group, in a subprocess;
* the ``roofline_table`` twin and ``launch.perf`` (a subprocess).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.distributed import sharding as jshard  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import param as jparam  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core.profiles import arch_profile  # noqa: E402
from repro_torch.distributed import sharding as tshard  # noqa: E402
from repro_torch.launch import dryrun, render  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,  # noqa: E402
                                     Mesh, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
ARCHS = jbase.list_configs()
MESH_SHAPES = [((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model"))]
STRATEGIES = ["tp", "tp_infer", "sp"]
FAMILIES = ["phi3-mini-3.8b", "mamba2-1.3b", "deepseek-moe-16b",
            "jamba-1.5-large-398b", "whisper-small", "llava-next-mistral-7b"]


def _jax_mesh(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _norm(spec) -> tuple:
    """A JAX ``PartitionSpec`` as the port's per-dim axis tuples."""
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def _jax_flat(tree, leaf=lambda x: (tuple(x.shape), np.dtype(x.dtype).name),
              is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {tuple(k.key for k in path): leaf(x) for path, x in flat}


def _port_flat(tree, leaf=lambda t: (tuple(t.shape),
                                     str(t.dtype).split(".")[-1])) -> dict:
    return {path: leaf(t) for path, t in tparam.leaves(tree)}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_shape_cells_and_list_configs():
    assert [tuple(vars(c).values()) for c in tbase.ALL_SHAPES] == \
        [tuple(vars(c).values()) for c in jbase.ALL_SHAPES]
    assert tbase.list_configs() == ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_config_helpers(arch):
    t, j = tbase.get_config(arch), jbase.get_config(arch)
    assert [c.name for c in tbase.shapes_for(t)] == \
        [c.name for c in jbase.shapes_for(j)]
    assert t.param_count() == j.param_count()
    assert t.attn_free == j.attn_free


# ---------------------------------------------------------------------------
# specs and abstract trees
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_specs(arch):
    t, j = tbase.get_config(arch), jbase.get_config(arch)
    assert (tspecs.VLM_IMG_FRACTION, tspecs.WHISPER_DEC_LEN,
            tspecs.WHISPER_ENC_LEN) == (jspecs.VLM_IMG_FRACTION,
                                        jspecs.WHISPER_DEC_LEN,
                                        jspecs.WHISPER_ENC_LEN)
    for tc, jc in zip(tbase.shapes_for(t), jbase.shapes_for(j)):
        if tc.kind == "decode":
            got, want = tspecs.decode_specs(t, tc), jspecs.decode_specs(j, jc)
        else:
            got, want = tspecs.batch_specs(t, tc), jspecs.batch_specs(j, jc)
        assert all(x.device.type == "meta" for _, x in tparam.leaves(got))
        assert _port_flat(got) == _jax_flat(want), tc.name


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees(arch):
    t, j = tbase.get_config(arch), jbase.get_config(arch)
    ap = TR.abstract_params(t)
    assert _port_flat(ap) == _jax_flat(JR.abstract_params(j))
    assert _port_flat(TR.param_axes(t), leaf=tuple) == \
        _jax_flat(JR.param_axes(j), leaf=lambda a: a.names,
                  is_leaf=lambda x: isinstance(x, jparam.Axes))
    assert tparam.tree_bytes(TR.model_specs(t)) == \
        jparam.tree_bytes(JR.model_specs(j))
    got = topt.abstract_opt_state(ap, topt.OptConfig())
    want = jopt.abstract_opt_state(JR.abstract_params(j), jopt.OptConfig())
    assert _port_flat(got) == _jax_flat(want)


# ---------------------------------------------------------------------------
# spec_for
# ---------------------------------------------------------------------------
def _leaf_axes(arch):
    """(kind, path, shape, axes) of every param, batch and decode-cache
    leaf of ``arch`` at its shape cells."""
    cfg = tbase.get_config(arch)
    out = [("param", p, s.shape, s.axes)
           for p, s in tparam.leaves(TR.model_specs(cfg))]
    for cell in tbase.shapes_for(cfg):
        if cell.kind == "decode":
            enc = tspecs.WHISPER_ENC_LEN if cfg.enc_dec else None
            out += [("act", (cell.name,) + p, s.shape, s.axes)
                    for p, s in tparam.leaves(TR.cache_specs(
                        cfg, cell.global_batch, cell.seq_len, enc_len=enc))]
            out.append(("act", (cell.name, "tokens"),
                        (cell.global_batch,), ("batch",)))
        else:
            batch = tspecs.batch_specs(cfg, cell)
            axes = dryrun._batch_axes(batch)
            out += [("act", (cell.name, k), tuple(v.shape), tuple(axes[k]))
                    for k, v in batch.items()]
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_equal_to_reference(arch):
    leaves = _leaf_axes(arch)
    for shape, names in MESH_SHAPES:
        port_mesh, jax_mesh = Mesh(shape, names), _jax_mesh(shape, names)
        for strategy in STRATEGIES:
            tp, ta = tshard.strategy_rules(strategy)
            jp, ja = jshard.strategy_rules(strategy)
            for kind, path, dims, axes in leaves:
                got = tshard.spec_for(dims, axes, tp if kind == "param"
                                      else ta, port_mesh)
                want = jshard.spec_for(dims, axes, jp if kind == "param"
                                       else ja, jax_mesh)
                assert got == _norm(want), (shape, strategy, path)


def test_meshes():
    assert make_production_mesh() == Mesh((16, 16), ("data", "model"))
    m = make_production_mesh(multi_pod=True)
    assert (m.shape, m.axis_names, m.size) == \
        ((2, 16, 16), ("pod", "data", "model"), 512)
    assert make_local_mesh() == Mesh((1, 1), ("data", "model"))
    assert (PEAK_FLOPS_BF16, HBM_BW, LINK_BW) == (989e12, 3.35e12, 450e9)


def test_shard_is_identity_off_a_mesh():
    x = torch.ones(4, 8)
    assert tshard.shard(x, "batch", "embed") is x
    with tshard.mesh_context(Mesh((1, 1), ("data", "model"))):
        assert tshard.current_mesh().size == 1
        assert tshard.shard(x, "batch", "embed") is x
    with tshard.mesh_context(make_production_mesh()):
        with pytest.raises(TypeError, match="plain Tensor"):
            tshard.shard(x, "batch", "embed")
    assert tshard.current_mesh() is None


hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


@settings(max_examples=25, deadline=None)
@given(dim=st.sampled_from([1, 2, 3, 8, 16, 64, 128, 256, 524288]),
       name=st.sampled_from(["batch", "kv_seq", "heads", "mlp", None]),
       mesh=st.sampled_from(MESH_SHAPES))
def test_spec_for_divisibility(dim, name, mesh):
    """Assigned mesh axes always divide the dimension (the twin of
    ``tests/test_properties.py::test_spec_for_divisibility``, on every
    mesh shape), and the spec is the reference's."""
    port_mesh = Mesh(*mesh)
    spec = tshard.spec_for((dim,), (name,), tshard.ACT_RULES, port_mesh)
    assert dim % math.prod(port_mesh.sizes[a] for a in spec[0]) == 0
    assert spec == _norm(jshard.spec_for((dim,), (name,), jshard.ACT_RULES,
                                         _jax_mesh(*mesh)))


_SHARD_SHAPES = """
import json, sys
import jax
from jax.sharding import NamedSharding
from repro.configs.base import get_config, shapes_for
from repro.distributed.sharding import spec_for, strategy_rules
from repro.launch import specs as S
from repro.launch.dryrun import _batch_axes
from repro.models import registry as R
from repro.models.param import Axes
out = {}
for multi in (False, True):
    shape = (2, 16, 16) if multi else (16, 16)
    names = ("pod", "data", "model") if multi else ("data", "model")
    mesh = jax.make_mesh(shape, names)
    for arch in sys.argv[1:]:
        cfg = get_config(arch)
        for strategy in ("tp", "sp"):
            prules, arules = strategy_rules(strategy)
            flat = jax.tree_util.tree_flatten_with_path(
                R.model_specs(cfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
            items = [("param", tuple(k.key for k in p), s.shape, s.axes)
                     for p, s in flat]
            for cell in shapes_for(cfg):
                if cell.kind == "decode":
                    enc = S.WHISPER_ENC_LEN if cfg.enc_dec else None
                    flat = jax.tree_util.tree_flatten_with_path(
                        R.cache_specs(cfg, cell.global_batch, cell.seq_len,
                                      enc_len=enc),
                        is_leaf=lambda x: hasattr(x, "axes"))[0]
                    items += [("act", (cell.name,) + tuple(k.key for k in p),
                               s.shape, s.axes) for p, s in flat]
                    items.append(("act", (cell.name, "tokens"),
                                  (cell.global_batch,), ("batch",)))
                else:
                    b = S.batch_specs(cfg, cell)
                    ax = _batch_axes(b)
                    items += [("act", (cell.name, k), v.shape, tuple(ax[k]))
                              for k, v in b.items()]
            for kind, path, dims, axes in items:
                spec = spec_for(dims, axes, prules if kind == "param"
                                else arules, mesh)
                key = "|".join([str(multi), arch, strategy, *path])
                out[key] = list(NamedSharding(mesh, spec).shard_shape(
                    tuple(dims)))
print(json.dumps(out))
"""


def test_local_shard_shapes_equal_to_named_sharding():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    out = subprocess.run([sys.executable, "-c", _SHARD_SHAPES, *FAMILIES],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    seen = 0
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for arch in FAMILIES:
            leaves = _leaf_axes(arch)
            for strategy in ("tp", "sp"):
                prules, arules = tshard.strategy_rules(strategy)
                for kind, path, dims, axes in leaves:
                    spec = tshard.spec_for(dims, axes, prules if kind ==
                                           "param" else arules, mesh)
                    key = "|".join([str(multi), arch, strategy, *path])
                    assert list(tshard.local_shape(dims, spec, mesh)) == \
                        want[key], key
                    seen += 1
    assert seen == len(want)


_PLACEMENTS = """
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.distributed.sharding import local_shape, placements, spec_for, PARAM_RULES, ACT_RULES
from repro_torch.launch.mesh import Mesh
dist.init_process_group("gloo", init_method="tcp://localhost:{port}",
                        world_size=1, rank=0)
try:
    for shape, names in (((1, 1), ("data", "model")),
                         ((1, 1, 1), ("pod", "data", "model"))):
        mesh = Mesh(shape, names)
        dm = init_device_mesh("cpu", shape, mesh_dim_names=names)
        cases = [(((), ("model",)), [Replicate()] * (len(shape) - 1) + [Shard(1)]),
                 ((("data", "model"), ()), [Replicate()] * (len(shape) - 2) + [Shard(0), Shard(0)]),
                 (((), ()), [Replicate()] * len(shape))]
        if len(shape) == 3:
            cases.append(((("pod", "data"), ("model",)),
                          [Shard(0), Shard(0), Shard(1)]))
        for spec, want in cases:
            got = placements(spec, dm)
            assert got == want, (spec, got, want)
            t = distribute_tensor(torch.ones(32, 16), dm, got)
            assert tuple(t.to_local().shape) == local_shape((32, 16), spec, mesh)
        # a spec_for spec of the rules, on this mesh: all replicated
        spec = spec_for((64, 32), ("embed", "mlp"), PARAM_RULES, mesh)
        assert placements(spec, dm) == [Replicate()] * len(shape)
    print("ok")
finally:
    dist.destroy_process_group()
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_placements_on_a_gloo_device_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c",
                          _PLACEMENTS.format(port=_free_port())], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_bit_equal(arch):
    t, j = tbase.get_config(arch), jbase.get_config(arch)
    for ctx in (4096, 32768, 524288):
        for causal in (True, False):
            assert troof._attn_flops_per_token(t, ctx, causal) == \
                jroof._attn_flops_per_token(j, ctx, causal)
    n, na = TR.count_params(t), TR.count_params(t, active=True)
    assert (n, na) == (JR.count_params(j), JR.count_params(j, active=True))
    for cell in tbase.ALL_SHAPES:
        for chips in (1, 256, 512):
            r = {"arch": arch, "shape": cell.name, "chips": chips,
                 "params": n, "params_active": na}
            assert troof.model_flops_for(r) == jroof.model_flops_for(r)


def _result(arch, shape, flops, hbytes, coll, args, chips=256):
    cfg = tbase.get_config(arch)
    return {"arch": arch, "shape": shape, "mesh": [16, 16], "chips": chips,
            "strategy": "tp", "compile_s": 1.5, "flops": flops,
            "bytes_accessed": hbytes,
            "collectives": {"bytes_by_op": coll,
                            "total_bytes": sum(coll.values())},
            "memory": {"argument_size_in_bytes": args,
                       "temp_size_in_bytes": 3 << 30},
            "params": TR.count_params(cfg),
            "params_active": TR.count_params(cfg, active=True)}


RESULTS = [_result("phi3-mini-3.8b", "train_4k", 1.7e14, 3.1e12,
                   {"all-gather": 2.0e10, "all-reduce": 1e9}, 5 << 30),
           _result("deepseek-moe-16b", "decode_32k", 3.3e11, 4.4e11,
                   {"all-to-all": 7e8}, 9 << 30),
           _result("mamba2-1.3b", "long_500k", 0.0, 1e9, {}, 1 << 30,
                   chips=1)]


def test_analyze_on_the_same_results():
    for r in RESULTS:
        a, b = troof.analyze(r), jroof.analyze(r)
        assert (a.model_flops, a.hlo_flops, a.useful_ratio, a.arg_bytes) == \
            (b.model_flops, b.hlo_flops, b.useful_ratio, b.arg_bytes)
        for got, pg, want, pw in (
                (a.compute_s, PEAK_FLOPS_BF16, b.compute_s,
                 jroof.PEAK_FLOPS_BF16),
                (a.memory_s, HBM_BW, b.memory_s, jroof.HBM_BW),
                (a.collective_s, LINK_BW, b.collective_s, jroof.ICI_BW)):
            assert got * pg == pytest.approx(want * pw, rel=1e-15, abs=0)
        assert a.bound_s == max(a.compute_s, a.memory_s, a.collective_s)
        ideal = max(a.model_flops / PEAK_FLOPS_BF16, a.arg_bytes / HBM_BW)
        assert a.ideal_s == ideal
        assert a.roofline_fraction == (ideal / a.bound_s if a.bound_s else 0)


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-moe-16b",
                                  "jamba-1.5-large-398b"])
def test_arch_profile_and_fallback(arch, monkeypatch, tmp_path):
    monkeypatch.setattr(troof, "ARTIFACT_DIR", str(tmp_path))
    n_active = TR.count_params(tbase.get_config(arch), active=True)
    step = troof.decode_step_time_fallback(arch)
    assert step == 2.0 * n_active / HBM_BW
    assert troof.decode_step_time(arch) == step       # no result saved
    p = arch_profile(arch)
    assert (p.name, p.median, p.sigma) == (f"arch:{arch}", 64 * step / 8, 0.6)
    from repro.core.profiles import arch_profile as jarch_profile
    j = jarch_profile(arch, tokens_out=32, step_time=0.02, batch=4)
    q = arch_profile(arch, tokens_out=32, step_time=0.02, batch=4)
    assert (q.name, q.median, q.sigma, q.max_factor) == \
        (j.name, j.median, j.sigma, j.max_factor)
    # a one-card result with flops replaces the fallback by its bound
    r = dict(RESULTS[1], arch=arch, shape="decode_32k", chips=1)
    (tmp_path / f"{arch}_decode_32k_card.json").write_text(json.dumps(r))
    assert troof.decode_step_time(arch) == troof.analyze(r).bound_s


# ---------------------------------------------------------------------------
# render, the twin, perf
# ---------------------------------------------------------------------------
_REF_RENDER = """
import json, sys
from repro.launch import render
rows = json.load(open(sys.argv[1]))
render._load = lambda tag: rows if tag == "pod" else []
text = "a\\n<!-- DRYRUN_TABLE -->\\nb\\n<!-- ROOFLINE_TABLE -->\\n<!-- /ROOFLINE_TABLE -->\\n"
once = render._replace(text, "DRYRUN_TABLE", "T1")
print(json.dumps({"table": render.dryrun_table(), "once": once,
                  "twice": render._replace(render._replace(once, "ROOFLINE_TABLE", "T2"),
                                           "DRYRUN_TABLE", "T3")}))
"""


def test_render_equal_to_reference(tmp_path, monkeypatch):
    rows = [dict(RESULTS[0]),
            dict(RESULTS[1], memory={"argument_size_in_bytes": 90 << 30,
                                     "temp_size_in_bytes": 1 << 30}),
            {"arch": "mamba2-1.3b", "shape": "train_4k",
             "mesh": [2, 16, 16], "strategy": "sp", "compile_s": 0.2,
             "memory": {"argument_size_in_bytes": 123456789}}]
    (tmp_path / "rows.json").write_text(json.dumps(rows))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REF_RENDER,
                          str(tmp_path / "rows.json")], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    monkeypatch.setattr(render, "_load",
                        lambda tag: rows if tag == "card" else [])
    assert render.dryrun_table() == want["table"].replace("fits 16G",
                                                          "fits 80G")
    text = ("a\n<!-- DRYRUN_TABLE -->\nb\n<!-- ROOFLINE_TABLE -->\n"
            "<!-- /ROOFLINE_TABLE -->\n")
    once = render._replace(text, "DRYRUN_TABLE", "T1")
    assert once == want["once"]
    assert render._replace(render._replace(once, "ROOFLINE_TABLE", "T2"),
                           "DRYRUN_TABLE", "T3") == want["twice"]


def test_render_main_and_roofline_table_twin(tmp_path, monkeypatch):
    sys.path.insert(0, REPO)
    from benchmarks import roofline_table as ref_twin
    from benchmarks.torch_port import roofline_table as twin
    from benchmarks.torch_port.common import ART
    for mod in (troof, render):
        monkeypatch.setattr(mod, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr(render, "DOC", str(tmp_path / "DRYRUN.md"))
    assert twin.main() == "cells=0"
    for r in RESULTS[:2]:
        r = dict(r, chips=1, mesh=[1, 1])
        (tmp_path / f"{r['arch']}_{r['shape']}_card.json").write_text(
            json.dumps(r))
    (tmp_path / "phi3-mini-3.8b_train_4k_pod.json").write_text(json.dumps(
        {"arch": "phi3-mini-3.8b", "shape": "train_4k", "mesh": [16, 16],
         "strategy": "sp", "compile_s": 0.1,
         "memory": {"argument_size_in_bytes": 1 << 30}}))
    assert twin.main() == "cells=2"
    rows = [ln.split(",") for ln in open(os.path.join(
        ART, "roofline_table.csv")).read().splitlines()]
    assert rows[0][:2] == ["arch", "shape"] and len(rows) == 3
    # the reference twin on the same two results (under its own tag)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    for f in tmp_path.glob("*_card.json"):
        (ref_dir / f.name.replace("_card", "_pod")).write_text(f.read_text())
    monkeypatch.setattr(jroof, "ARTIFACT_DIR", str(ref_dir))
    assert ref_twin.main() == "cells=2"
    ref_rows = [ln.split(",") for ln in open(os.path.join(
        REPO, "artifacts", "bench", "roofline_table.csv")).read().splitlines()]
    cols = rows[0]
    for a, b in zip(rows[1:], ref_rows[1:]):
        for c in ("arch", "shape", "model_flops", "hlo_flops",
                  "useful_ratio"):
            assert a[cols.index(c)] == b[cols.index(c)], c
    render.main()
    doc = (tmp_path / "DRYRUN.md").read_text()
    assert doc.count("| phi3-mini-3.8b | train_4k |") == 3   # 1x1, 16x16, roofline
    assert "<!-- /DRYRUN_TABLE -->" in doc and "<!-- /ROOFLINE_TABLE -->" in doc


_PERF = """
import sys
from repro_torch.launch import dryrun, perf, roofline
for mod in (dryrun, roofline):
    mod.ARTIFACT_DIR = sys.argv[1]
dryrun.run_cell("deepseek-moe-16b-smoke", "decode_32k")
perf.main(["--arch", "deepseek-moe-16b-smoke", "--shape", "decode_32k",
           "--opts", "w8_experts", "--tag", "w8"])
"""


def test_perf_in_a_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", _PERF, str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2].startswith("[w8] compute=") and "dominant=" in lines[-2]
    assert lines[-1].startswith("[baseline] bound=")
    base = json.loads((tmp_path / "deepseek-moe-16b-smoke_decode_32k_card"
                                   ".json").read_text())
    tagged = json.loads((tmp_path / "deepseek-moe-16b-smoke_decode_32k_card_"
                                     "w8.json").read_text())
    assert tagged["opts"] == "w8_experts" and base["opts"] == ""
    # int8 expert banks: fewer argument bytes than the bf16 baseline
    assert tagged["memory"]["argument_size_in_bytes"] < \
        base["memory"]["argument_size_in_bytes"]
