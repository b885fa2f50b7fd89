"""Dry-run on the ``meta`` device: run every (arch x shape x mesh) cell's
step with no allocation and record what it needs.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for 512 placeholder TPU devices.  Here the cell's real step runs on
``meta`` tensors (shapes and dtypes, no storage): ``make_train_step``
for train cells, ``registry.prefill`` for prefill and
``registry.decode_step`` for decode, on ``abstract_params``,
``abstract_opt_state`` and ``launch.specs``' batch, cache and tokens.
A meta tensor takes each kernel's plain version (``kernels.ops``), as
the reference's dry-run asks for ``impl="ref"``.

What a result holds (the reference's keys, so ``launch.roofline``,
``launch.render`` and the ``roofline_table`` twins read both packages'
files alike):

* ``memory.argument_size_in_bytes``: params, optimizer state and batch
  (or cache and tokens) per device, from ``distributed.sharding``'s
  local shard shapes: exact;
* ``memory.output_size_in_bytes``: the step's returned tensors (a train
  step returns its params and state, updated in place);
* ``memory.temp_size_in_bytes``: an ESTIMATE, the largest live set of
  the tensors the step creates, tallied op by op by a dispatch mode
  (each storage counted while any tensor on it lives, autograd's saved
  tensors included; the outputs the step builds count while they are
  built).  The eager step frees what XLA's buffer assignment would
  reuse, but nothing fuses, so the figure reads high where XLA fuses;
* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count, 2
  FLOPs per multiply-add of every matrix product (``mm``, ``bmm``,
  ``addmm``, ``baddbmm``, convolutions, SDPA) and nothing for
  element-wise ops;
* ``bytes_accessed``: every aten op's operand plus result bytes,
  unfused (a view op moves none), so every intermediate is written and
  read back;
* ``collectives``: empty (one device).

These counts are not XLA's.  XLA's ``cost_analysis`` counts element-wise
FLOPs too and fuses chains, so its bytes are fewer: on phi3-mini-3.8b's
smoke config, prefill at B2 x S64, XLA's CPU count reads 12,941,330
FLOPs and 4,238,187 bytes, this count 23,134,208 FLOPs (the products
alone, ``aten.mm`` 18,939,904 and ``aten.bmm`` 4,194,304).  The port
holds its count to an exact sum of the step's products instead
(``tests/test_torch_dryrun.py``).

Meshes: the one-card mesh (``"card"``, 1x1) is the port's real case
and the default; there the step runs and every key is recorded.  On the
reference's production meshes (``"pod"`` 16x16, ``"multipod"``
2x16x16, over ``launch.mesh``'s descriptions) ``run_cell`` records the
argument bytes per device only, with no ``flops``, so
``roofline.load_results`` skips the file as it skips the reference's
``--no-cost`` results; per-device FLOPs, bytes and collectives there
are ROADMAP Queue A item 9b (multi-GPU).  ``compile_s`` is the seconds
the meta run took: the port compiles nothing.

No cost mode: the reference unrolls its scanned layer groups at G=2 and
G=4 and extrapolates (its ``util.cost_mode``).  The port's layers run as
a Python loop, so every layer, chunk and slice is counted as it runs.

    python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all             # every cell, one card
    python -m repro_torch.launch.dryrun --all --both      # 16x16 and 2x16x16

It needs no card.  Results go to ``launch.roofline.ARTIFACT_DIR``
(``artifacts/dryrun_torch/<arch>_<shape>_<mesh>.json``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import (ALL_SHAPES, ArchConfig, ShapeCell,
                                      get_config, list_configs, shapes_for)
from repro_torch.distributed.sharding import (local_shape, spec_for,
                                              strategy_rules, tree_shardings)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.launch.roofline import ARTIFACT_DIR
from repro_torch.models import registry as R
from repro_torch.models.param import axes_tree, leaves
from repro_torch.training.optimizer import OptConfig, abstract_opt_state
from repro_torch.training.train_step import make_train_step

#: the meshes a cell runs on, by the tag its result file carries
MESHES = {"card": Mesh((1, 1), ("data", "model")),
          "pod": make_production_mesh(),
          "multipod": make_production_mesh(multi_pod=True)}

DEFAULT_STRATEGY = {"train": "sp", "prefill": "tp", "decode": "tp"}


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------
def _batch_axes(batch: dict) -> dict:
    ax = {}
    for k, v in batch.items():
        if k in ("tokens", "targets"):
            ax[k] = ("batch", "seq") if len(v.shape) == 2 else ("batch",)
        elif k in ("patch_embeds", "frames"):
            ax[k] = ("batch", "seq", None)
        elif k == "positions":
            ax[k] = ("batch",)
        else:
            raise KeyError(k)
    return ax


def build_cell(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh, strategy: str):
    """-> (step, abstract args, per-arg spec trees): the cell's step
    function, its ``meta`` arguments and each argument's sharding specs
    on ``mesh`` (``distributed.sharding.spec_for``'s tuples)."""
    prules, arules = strategy_rules(strategy)
    aparams = R.abstract_params(cfg)
    p_axes = R.param_axes(cfg)
    p_sh = tree_shardings(p_axes, aparams, mesh, prules)

    if cell.kind == "train":
        opt_cfg = OptConfig()
        aopt = abstract_opt_state(aparams, opt_cfg)
        o_sh = {"m": tree_shardings(p_axes, aopt["m"], mesh, prules),
                "v": tree_shardings(p_axes, aopt["v"], mesh, prules),
                "step": ()}
        batch = S.batch_specs(cfg, cell)
        b_sh = tree_shardings(_batch_axes(batch), batch, mesh, arules)
        step = make_train_step(cfg, opt_cfg)
        return step, (aparams, aopt, batch), (p_sh, o_sh, b_sh)

    if cell.kind == "prefill":
        batch = S.batch_specs(cfg, cell)
        b_sh = tree_shardings(_batch_axes(batch), batch, mesh, arules)

        def step(params, batch):
            return R.prefill(cfg, params, batch, max_len=cell.seq_len)

        return step, (aparams, batch), (p_sh, b_sh)

    # decode
    d = S.decode_specs(cfg, cell)
    enc_len = S.WHISPER_ENC_LEN if cfg.enc_dec else None
    cache_axes = axes_tree(R.cache_specs(cfg, cell.global_batch, cell.seq_len,
                                         enc_len=enc_len))
    c_sh = tree_shardings(cache_axes, d["cache"], mesh, arules)
    t_sh = spec_for((cell.global_batch,), ("batch",), arules, mesh)

    def step(params, cache, tokens, positions):
        return R.decode_step(cfg, params, cache, tokens, positions)

    return (step, (aparams, d["cache"], d["tokens"], d["positions"]),
            (p_sh, c_sh, t_sh, t_sh))


def _tensors(tree) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def argument_bytes(args, arg_specs, mesh: Mesh) -> int:
    """Bytes of every argument leaf's local shard on ``mesh``."""
    total = 0
    for a, sh in zip(args, arg_specs):
        specs = dict(leaves(sh))
        for path, t in leaves(a):
            total += (math.prod(local_shape(t.shape, specs[path], mesh))
                      * t.element_size())
    return total


class _Unmemoizable(Exception):
    pass


def _signature(x):
    """What a meta op's output metadata can depend on: each tensor's
    shape, strides and dtype (not its storage offset), every other
    argument by type and value."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _Unmemoizable
        return (tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_signature(v) for v in x))
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    return (type(x), x)


class _Tally(TorchDispatchMode):
    """The counters of a meta run, one dispatch mode: FLOPs by
    ``FlopCounterMode``'s formulas (``flop_registry``, each op given the
    chance to decompose first, as that mode does), operand-plus-result
    bytes of every op that moves data (not a view, nor an op whose result
    aliases its input), and the largest live set of the storages the run
    creates (each counted while any tensor on it lives).

    A meta op's outputs are metadata only, fixed by its arguments'
    shapes, strides, dtypes and values: an out-of-place op seen before
    with the same ``_signature`` gets fresh ``meta`` outputs of the
    recorded shapes and its recorded counts, without running its meta
    kernel again.  The plain versions' chunk loops repeat one signature
    chunk after chunk, so the run costs a few dictionary lookups a chunk
    where each meta kernel costs up to a millisecond."""

    def __init__(self, exclude: set):
        super().__init__()
        self.exclude = exclude          # the arguments' storages
        self.flops = 0
        self.bytes_accessed = 0
        self.refs: dict = {}            # storage -> live tensors on it
        self.size: dict = {}            # storage -> its bytes
        self.live = 0
        self.peak = 0
        self.memo: dict = {}            # signature -> (flops, bytes, outs)
        self.decomposes: dict = {}      # op -> it decomposed (False: never)

    def _release(self, key) -> None:
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.live -= self.size.pop(key)

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self.exclude:
                continue
            if key not in self.refs:
                self.refs[key] = 0
                self.size[key] = st.nbytes()
                self.live += self.size[key]
                self.peak = max(self.peak, self.live)
            self.refs[key] += 1
            weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        key = None
        if not (func.is_view or func._schema.is_mutable):
            try:
                key = (func, _signature(args), _signature(kwargs))
                hit = self.memo.get(key)
            except (_Unmemoizable, TypeError):      # TypeError: unhashable
                key = hit = None
            if hit is not None:
                flops, nbytes, metas, kind = hit
                outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                            device="meta")
                        for shape, stride, dtype in metas]
                self.flops += flops
                self.bytes_accessed += nbytes
                self._track(outs)
                return outs[0] if kind is None else kind(outs)
        if self.decomposes.get(func) is not False:
            with self:
                r = func.decompose(*args, **kwargs)
            self.decomposes[func] = r is not NotImplemented
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        aliased = {t.untyped_storage()._cdata for t in ins} & {
            t.untyped_storage()._cdata for t in outs}
        formula = flop_registry.get(func._overloadpacket)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        moves = not func.is_view and (func._schema.is_mutable
                                      or not aliased)
        nbytes = (sum(_nbytes(t) for t in ins + outs)
                  if moves and outs else 0)
        self.flops += flops
        self.bytes_accessed += nbytes
        # memoised: one meta tensor, or a flat tuple or list of them
        kind = None if isinstance(out, torch.Tensor) else type(out)
        if key is not None and not aliased and outs and all(
                t.device.type == "meta" for t in outs) and (
                kind is None or (kind in (tuple, list)
                                 and len(outs) == len(out))):
            self.memo[key] = (flops, nbytes,
                              [(tuple(t.shape), t.stride(), t.dtype)
                               for t in outs], kind)
        self._track(outs)
        return out


def count_step(step, args) -> dict:
    """Run ``step(*args)`` on ``meta`` tensors under the counters ->
    {flops, bytes_accessed, output_size_in_bytes, temp_size_in_bytes}."""
    exclude = {t.untyped_storage()._cdata for t in _tensors(args)}
    tally = _Tally(exclude)
    with tally:
        out = step(*args)
        out_bytes = sum(_nbytes(t) for t in _tensors(out))
    return {"flops": float(tally.flops),
            "bytes_accessed": float(tally.bytes_accessed),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(tally.peak)}


def dryrun_cell(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh,
                strategy: str, with_cost: bool = True) -> dict:
    """One cell on ``mesh``: its argument bytes per device and, on a
    one-device mesh with ``with_cost``, the meta run's counts."""
    t0 = time.perf_counter()
    step, args, arg_specs = build_cell(cfg, cell, mesh, strategy)
    memory = {"argument_size_in_bytes": argument_bytes(args, arg_specs,
                                                       mesh)}
    result = {"memory": memory}
    if with_cost and mesh.size == 1:
        counts = count_step(step, args)
        memory["output_size_in_bytes"] = counts.pop("output_size_in_bytes")
        memory["temp_size_in_bytes"] = counts.pop("temp_size_in_bytes")
        result.update(counts, collectives={"bytes_by_op": {},
                                           "total_bytes": 0.0, "counts": {}})
    result["compile_s"] = round(time.perf_counter() - t0, 1)
    return result


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             save: bool = True, strategy: str = "",
             with_cost: bool = True, opts: str = "", tag: str = "",
             mesh: str = "card") -> dict:
    """Dry-run ``arch`` at ``shape_name`` on the one-card mesh (``mesh``
    ``"pod"`` or ``"multipod"``, or ``multi_pod=True``, for the
    reference's production meshes) -> the result dict, saved under
    ``ARTIFACT_DIR`` as ``<arch>_<shape>_<mesh>[_<tag>].json``."""
    if opts:
        os.environ["REPRO_OPTS"] = opts
    mesh = "multipod" if multi_pod else mesh
    try:
        cfg = get_config(arch)
        cell = {c.name: c for c in ALL_SHAPES}[shape_name]
        strategy = strategy or DEFAULT_STRATEGY[cell.kind]
        m = MESHES[mesh]
        result = {"arch": arch, "shape": shape_name, "mesh": list(m.shape),
                  "chips": m.size, "multi_pod": mesh == "multipod",
                  "strategy": strategy,
                  "params": R.count_params(cfg),
                  "params_active": R.count_params(cfg, active=True)}
        result.update(dryrun_cell(cfg, cell, m, strategy, with_cost))
    finally:
        if opts:
            os.environ.pop("REPRO_OPTS", None)
    result["opts"] = opts
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        name = f"{arch}_{shape_name}_{mesh}"
        if tag:
            name += f"_{tag}"
        with open(os.path.join(ARTIFACT_DIR, name + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true",
                    help="the 2x16x16 production mesh (memory only)")
    ap.add_argument("--both", action="store_true",
                    help="the reference's two production meshes, 16x16 and "
                         "2x16x16 (memory only)")
    ap.add_argument("--strategy", default="")
    ap.add_argument("--no-cost", action="store_true",
                    help="argument bytes only, no meta run")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, cell.name) for arch in list_configs()
                 for cell in shapes_for(get_config(arch))]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    meshes = (["pod", "multipod"] if args.both
              else ["multipod"] if args.multipod else ["card"])

    failures = 0
    t_all = time.perf_counter()
    for arch, shape in cells:
        for mesh in meshes:
            label = f"{arch} x {shape} x {'x'.join(map(str, MESHES[mesh].shape))}"
            try:
                r = run_cell(arch, shape, strategy=args.strategy,
                             with_cost=not args.no_cost, mesh=mesh)
                mem = r["memory"]
                print(f"OK   {label}: {r['compile_s']}s "
                      f"flops={r.get('flops', -1):.3e} "
                      f"bytes={r.get('bytes_accessed', -1):.3e} "
                      f"args={mem['argument_size_in_bytes'] / 2**30:.2f}GiB "
                      f"temp={mem.get('temp_size_in_bytes', 0) / 2**30:.2f}GiB",
                      flush=True)
            except Exception as e:  # one cell's failure is reported, the rest run
                failures += 1
                print(f"FAIL {label}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    print(f"{len(cells) * len(meshes)} cells in "
          f"{time.perf_counter() - t_all:.1f} s", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
