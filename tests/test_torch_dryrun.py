"""The port's dry-run on the ``meta`` device (``repro_torch.launch.dryrun``).

Tolerances: every figure below is held EQUAL, but the unfused byte
count of a meta run against a CPU run (rel 1e-2, see below).

* ``build_cell`` runs each cell kind's real step (``make_train_step``,
  ``registry.prefill``, ``registry.decode_step``) on ``meta`` tensors for
  the phi3, gemma3, mamba2, deepseek-moe, jamba, whisper and llava smoke
  configs: outputs of the step's shapes, every tensor on ``meta``.
* On the one-device mesh the argument bytes equal the JAX package's
  bytes of its abstract params, optimizer state and batch (or cache and
  tokens), for every arch x ``shapes_for`` cell at full size.
* The counts on ``meta`` equal the same step's on the CPU with real
  tensors at a small ``ShapeCell``: FLOPs against
  ``torch.utils.flop_counter.FlopCounterMode`` run on the CPU, and the
  output bytes and temp estimate against the same tally run on the CPU.
  The unfused bytes are held within rel 1e-2 of the CPU's: PyTorch
  builds ``one_hot`` from other ops on ``meta`` than on the CPU, and a
  host tensor moved to the step's device is a copy only on ``meta``.  The
  memo of meta outputs changes no count (the same meta run without it).
* The train cell's meta arguments equal, leaf by leaf, the state
  ``launch.train`` builds (``init_params``, ``init_opt_state``, a
  ``SyntheticLM`` batch), and so do their bytes.
* phi3-smoke prefill at B2 x S64 counts exactly the analytic sum of its
  matrix products, 23,134,208 FLOPs.  XLA's CPU ``cost_analysis`` of the
  JAX package's prefill reads 12,941,330 FLOPs and 4,238,187 bytes there:
  NOT COMPARABLE, since XLA counts element-wise work too, and fuses (its
  products alone are the same 23.1 M, its total is not a count of them).
* Production meshes record the sharded step's per-device counts too
  (``tests/test_torch_dryrun_mesh.py`` holds them to the layout);
  ``roofline.load_results`` reads each mesh's files; the CLI writes its
  files.
* ``kernels.ops`` sends ``meta`` to the plain versions and still refuses
  any other device that is neither the CPU nor CUDA.
"""
from __future__ import annotations

import json
import math
import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import param as jparam  # noqa: E402
from repro.models import registry as JR  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402

from repro_torch.configs.base import (ShapeCell, get_config,  # noqa: E402
                                      list_configs, shapes_for)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.models import param as P  # noqa: E402
from repro_torch.models import registry as R  # noqa: E402
from repro_torch.training.optimizer import OptConfig, init_opt_state  # noqa: E402

SMOKE = ["phi3-mini-3.8b", "gemma3-12b", "mamba2-1.3b", "deepseek-moe-16b",
         "jamba-1.5-large-398b", "whisper-small", "llava-next-mistral-7b"]
CELLS = {"train": ShapeCell("t", "train", 64, 2),
         "prefill": ShapeCell("p", "prefill", 64, 2),
         "decode": ShapeCell("d", "decode", 64, 2)}
CARD = dryrun.MESHES["card"]


def _strategy(kind):
    return dryrun.DEFAULT_STRATEGY[kind]


@pytest.mark.parametrize("arch", SMOKE)
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_cell_runs_on_meta(arch, kind):
    cfg = get_config(arch + "-smoke")
    cell = CELLS[kind]
    step, args, specs = dryrun.build_cell(cfg, cell, CARD, _strategy(kind))
    assert all(t.device.type == "meta" for t in dryrun._tensors(args))
    out = step(*args)
    assert all(t.device.type == "meta" for t in dryrun._tensors(out))
    if kind == "train":
        assert out[2]["loss"].shape == ()
    else:
        assert out[0].shape == (cell.global_batch, cfg.vocab_size)


def _jax_bytes(tree) -> int:
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(tree))


@pytest.mark.parametrize("arch", list_configs())
def test_argument_bytes_equal_to_reference(arch):
    cfg, jcfg = get_config(arch), jbase.get_config(arch)
    for cell, jcell in zip(shapes_for(cfg), jbase.shapes_for(jcfg)):
        _, args, specs = dryrun.build_cell(cfg, cell, CARD,
                                           _strategy(cell.kind))
        params = jparam.tree_bytes(JR.model_specs(jcfg))
        if cell.kind == "train":
            want = params + _jax_bytes(
                (jopt.abstract_opt_state(JR.abstract_params(jcfg),
                                         jopt.OptConfig()),
                 jspecs.batch_specs(jcfg, jcell)))
        elif cell.kind == "prefill":
            want = params + _jax_bytes(jspecs.batch_specs(jcfg, jcell))
        else:
            want = params + _jax_bytes(jspecs.decode_specs(jcfg, jcell))
        assert dryrun.argument_bytes(args, specs, CARD) == want, cell.name


def _real(cfg, cell, args):
    """CPU tensors for ``build_cell``'s meta arguments: seeded weights,
    zero moments, tokens inside the vocabulary, decode positions inside
    the cache."""
    gen = torch.Generator().manual_seed(0)
    params = R.init_params(cfg, gen, device="cpu")
    rng = np.random.default_rng(0)

    def fill(path, t):
        if t.dtype in (torch.int32, torch.int64):
            hi = cfg.vocab_size if path[-1] in ("tokens", "targets") \
                else cell.seq_len // 2
            return torch.from_numpy(rng.integers(0, hi, t.shape)).to(t.dtype)
        return torch.from_numpy(rng.standard_normal(t.shape)).to(t.dtype)

    if cell.kind == "train":
        return (params, init_opt_state(params, OptConfig()),
                P.unflatten((p, fill(p, t)) for p, t in P.leaves(args[2])))
    if cell.kind == "prefill":
        return (params, P.unflatten((p, fill(p, t))
                                    for p, t in P.leaves(args[1])))
    cache = P.tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                       args[1])
    return (params, cache, fill(("tokens",), args[2]),
            fill(("positions",), args[3]))


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mamba2-1.3b",
                                  "deepseek-moe-16b", "whisper-small",
                                  "llava-next-mistral-7b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_counts_equal_cpu_counts(arch, kind, monkeypatch):
    cfg = get_config(arch + "-smoke")
    cell = CELLS[kind]
    step, args, _ = dryrun.build_cell(cfg, cell, CARD, _strategy(kind))
    meta = dryrun.count_step(step, args)
    real = _real(cfg, cell, args)
    with FlopCounterMode(display=False) as fc:
        step(*real)
    assert meta["flops"] == fc.get_total_flops() > 0
    cpu = dryrun.count_step(step, _real(cfg, cell, args))
    for key in ("flops", "output_size_in_bytes", "temp_size_in_bytes"):
        assert meta[key] == cpu[key], key
    # bytes: PyTorch routes a few ops by device (``one_hot`` builds its
    # result by ``arange`` + ``eq`` on meta, by ``zeros`` + ``scatter_``
    # on the CPU; a host tensor moved to the step's device is a copy on
    # meta and none on the CPU), so the unfused byte counts differ by
    # those ops (deepseek's prefill: 0.27 %)
    assert meta["bytes_accessed"] == pytest.approx(cpu["bytes_accessed"],
                                                   rel=1e-2)
    # the memo of meta outputs changes no count: the same run without it
    step, args, _ = dryrun.build_cell(cfg, cell, CARD, _strategy(kind))

    def never(x):
        raise dryrun._Unmemoizable
    monkeypatch.setattr(dryrun, "_signature", never)
    assert dryrun.count_step(step, args) == meta


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "mamba2-1.3b",
                                  "deepseek-moe-16b"])
def test_train_arguments_are_launch_trains_state(arch):
    """The train cell's meta arguments are, leaf by leaf (path, shape,
    dtype), the state ``launch.train`` builds: ``init_params``,
    ``init_opt_state`` and a ``SyntheticLM`` batch, here on the CPU."""
    from repro_torch.training.data import DataConfig, SyntheticLM
    cfg = get_config(arch + "-smoke")
    cell = CELLS["train"]
    _, args, specs = dryrun.build_cell(cfg, cell, CARD, "sp")
    params = R.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = init_opt_state(params, OptConfig())
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  batch=cell.global_batch,
                                  seq_len=cell.seq_len))
    batch = {k: torch.from_numpy(v) for k, v in data.next_batch().items()}

    def meta(trees):
        return {(i, path): (tuple(t.shape), t.dtype)
                for i, tree in enumerate(trees) for path, t in P.leaves(tree)}
    assert meta(args) == meta((params, opt, batch))
    assert dryrun.argument_bytes(args, specs, CARD) == sum(
        t.numel() * t.element_size()
        for tree in (params, opt, batch) for _, t in P.leaves(tree))


def test_phi3_smoke_prefill_products():
    cfg = get_config("phi3-mini-3.8b-smoke")
    b, s = 2, 64
    step, args, _ = dryrun.build_cell(cfg, ShapeCell("p", "prefill", s, b),
                                      CARD, "tp")
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    tok = b * s
    per_layer = (2 * tok * d * (h + 2 * kv) * hd      # q, k, v
                 + 2 * tok * h * hd * d               # o
                 + 3 * 2 * tok * d * f                # wi_0, wi_1, wo
                 + 2 * 2 * b * h * s * s * hd)        # q k^T, p v
    want = cfg.num_layers * per_layer + 2 * b * d * v  # last-token logits
    assert want == 23_134_208
    assert dryrun.count_step(step, args)["flops"] == want


def test_production_meshes_record_memory_only(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    monkeypatch.setattr(roofline, "ARTIFACT_DIR", str(tmp_path))
    card = dryrun.run_cell("phi3-mini-3.8b", "decode_32k")
    pod = dryrun.run_cell("phi3-mini-3.8b", "decode_32k", mesh="pod")
    multi = dryrun.run_cell("phi3-mini-3.8b", "decode_32k", multi_pod=True)
    assert {"flops", "bytes_accessed", "collectives"} <= card.keys()
    assert card["memory"].keys() == {"argument_size_in_bytes",
                                     "output_size_in_bytes",
                                     "temp_size_in_bytes"}
    assert card["collectives"]["bytes_by_op"] == {} and card["chips"] == 1
    for r, chips in ((pod, 256), (multi, 512)):
        assert r["chips"] == chips and "sharded_error" not in r
        assert r["memory"].keys() == card["memory"].keys()
        assert r["memory"]["argument_size_in_bytes"] < \
            card["memory"]["argument_size_in_bytes"]
        assert 0 < r["flops"] < card["flops"]
        assert r["collectives"]["total_bytes"] > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "phi3-mini-3.8b_decode_32k_card.json",
        "phi3-mini-3.8b_decode_32k_multipod.json",
        "phi3-mini-3.8b_decode_32k_pod.json"]
    assert [r["shape"] for r in roofline.load_results()] == ["decode_32k"]
    assert [r["chips"] for r in roofline.load_results(multi_pod=True)] == \
        [512]
    assert [r["chips"] for r in roofline.load_results(mesh="pod")] == [256]
    assert roofline.decode_step_time("phi3-mini-3.8b") == \
        roofline.analyze(card).bound_s


def test_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    dryrun.main(["--arch", "mamba2-1.3b-smoke", "--shape", "long_500k"])
    out = capsys.readouterr().out
    assert out.startswith("OK   mamba2-1.3b-smoke x long_500k x 1x1:")
    r = json.loads((tmp_path / "mamba2-1.3b-smoke_long_500k_card.json")
                   .read_text())
    assert r["flops"] > 0 and r["strategy"] == "tp"
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "phi3-mini-3.8b"])


def test_on_cuda_admits_meta_and_refuses_other_devices():
    assert ops._on_cuda(torch.empty(2, device="meta")) is False
    assert ops._on_cuda(torch.empty(2)) is False
    q = torch.empty(1, 8, 4, 16, device="meta")
    out = ops.flash_attention(q, q[:, :, :2], q[:, :, :2], causal=True)
    assert out.device.type == "meta" and out.shape == q.shape
    odd = types.SimpleNamespace(is_cuda=False, device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device xpu"):
        ops._on_cuda(odd)
