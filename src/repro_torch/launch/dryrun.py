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
* ``collectives``: the result bytes and count of every collective the
  step runs, by the reference's names (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``; ``collective-permute`` where one
  runs), as the reference's ``parse_collectives`` reads them off the
  compiled program: empty on one device.

These counts are not XLA's.  XLA's ``cost_analysis`` counts element-wise
FLOPs too and fuses chains, so its bytes are fewer: on phi3-mini-3.8b's
smoke config, prefill at B2 x S64, XLA's CPU count reads 12,941,330
FLOPs and 4,238,187 bytes, this count 23,134,208 FLOPs (the products
alone, ``aten.mm`` 18,939,904 and ``aten.bmm`` 4,194,304).  The port
holds its count to an exact sum of the step's products instead
(``tests/test_torch_dryrun.py``).

Meshes: the one-card mesh (``"card"``, 1x1) is the port's real case
and the default.  On the reference's production meshes (``"pod"``
16x16, ``"multipod"`` 2x16x16, over ``launch.mesh``'s descriptions)
the same step runs as ONE rank of the mesh: a one-process world over
PyTorch's fake process group (``distributed.sharding.fake_world``),
every argument a DTensor of ``meta`` local shards
(``distribute_tree`` of ``build_cell``'s specs), the step under
``mesh_context`` with the strategy's activation rules.  The counters
read the rank's LOCAL tensors: FLOPs, bytes and the live set are per
device, and each collective's result is tallied at its local shape.
Where an arch's sharded step does not run, the record keeps the
argument bytes only, with ``sharded_error`` naming the op and its
message (the CLI prints it as a ``FAIL`` line).  ``compile_s`` is the
seconds the meta run took: the port compiles nothing.

No cost mode: the reference unrolls its scanned layer groups at G=2 and
G=4 and extrapolates (its ``util.cost_mode``).  The port's layers run as
a Python loop, so every layer, chunk and slice is counted as it runs.

    python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all             # every cell, one card
    python -m repro_torch.launch.dryrun --all --both      # 16x16 and 2x16x16
    python -m repro_torch.launch.dryrun --all --single-pod-only  # 16x16

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
from repro_torch.distributed.sharding import (distribute_tree, fake_world,
                                              is_dtensor, local_shape,
                                              mesh_context, spec_for,
                                              strategy_rules, tree_shardings)
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import Mesh, device_mesh, make_production_mesh
from repro_torch.launch.roofline import ARTIFACT_DIR
from repro_torch.models import registry as R
from repro_torch.models.param import axes_tree, leaves
from repro_torch.training.optimizer import OptConfig, abstract_opt_state
from repro_torch.training.train_step import make_train_step
from repro_torch.util import opt_flags

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
        mb = 8 if "microbatch8" in opt_flags() else 1
        step = make_train_step(cfg, opt_cfg, microbatches=mb)
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


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (this rank's tensor); a plain tensor."""
    return t._local_tensor if is_dtensor(t) else t


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


#: the reference's name of each functional collective (its HLO opcode);
#: DTensor moves a shard from one dim to another with its own op
COLLECTIVES = {"all_reduce": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all",
               "permute_tensor": "collective-permute"}


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
    """The counters of a meta run, one dispatch mode, on the rank's local
    tensors: an op on DTensors is handed back to DTensor
    (``NotImplemented``), which runs it on the local shards (those
    local ops, and the collectives a redistribution runs, come back
    here), and DTensor's own propagation of global shapes (on fake
    tensors) is not counted.  FLOPs by
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
        self.coll_bytes: dict = {}      # reference name -> result bytes
        self.coll_counts: dict = {}

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
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented       # DTensor runs it on local shards
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)   # DTensor's shape propagation
        if func.namespace in ("_c10d_functional", "_dtensor"):
            out = func(*args, **kwargs)
            name = COLLECTIVES.get(func._opname)
            if name is not None:
                self.coll_bytes[name] = (self.coll_bytes.get(name, 0.0)
                                         + sum(_nbytes(t)
                                               for t in _tensors(out)))
                self.coll_counts[name] = self.coll_counts.get(name, 0) + 1
            self._track(_tensors(out))
            return out
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
    """Run ``step(*args)`` on ``meta`` tensors (DTensors of meta shards on
    a mesh) under the counters -> {flops, bytes_accessed,
    output_size_in_bytes, temp_size_in_bytes, collectives}, per device."""
    exclude = {_local(t).untyped_storage()._cdata for t in _tensors(args)}
    tally = _Tally(exclude)
    with tally:
        out = step(*args)
        out_bytes = sum(_nbytes(t) for t in _tensors(out))
    return {"flops": float(tally.flops),
            "bytes_accessed": float(tally.bytes_accessed),
            "output_size_in_bytes": int(out_bytes),
            "temp_size_in_bytes": int(tally.peak),
            "collectives": {"bytes_by_op": dict(tally.coll_bytes),
                            "total_bytes": float(sum(
                                tally.coll_bytes.values())),
                            "counts": dict(tally.coll_counts)}}


def count_sharded_step(step, args, arg_specs, mesh: Mesh,
                       strategy: str) -> dict:
    """``count_step`` as one rank of ``mesh``: a fake world of the mesh's
    size, every argument a DTensor of meta shards with its spec's
    placements, the step under ``mesh_context`` with the strategy's
    activation rules."""
    with fake_world(mesh.size):
        dm = device_mesh(mesh, "cuda")
        dargs = tuple(distribute_tree(a, sh, dm)
                      for a, sh in zip(args, arg_specs))
        with mesh_context(mesh, strategy_rules(strategy)[1], dm):
            return count_step(step, dargs)


def _error_line(e: Exception) -> str:
    """``sharded_error``: the exception's type and first line (DTensor
    names the op there)."""
    msg = str(e).strip().splitlines()
    return f"{type(e).__name__}: {msg[0][:400] if msg else ''}"


def dryrun_cell(cfg: ArchConfig, cell: ShapeCell, mesh: Mesh,
                strategy: str, with_cost: bool = True) -> dict:
    """One cell on ``mesh``: its argument bytes per device and, with
    ``with_cost``, the meta run's counts per device (one rank of the
    mesh where it has more than one device; where that run fails, the
    argument bytes and ``sharded_error``)."""
    t0 = time.perf_counter()
    step, args, arg_specs = build_cell(cfg, cell, mesh, strategy)
    memory = {"argument_size_in_bytes": argument_bytes(args, arg_specs,
                                                       mesh)}
    result = {"memory": memory}
    if with_cost:
        try:
            counts = (count_step(step, args) if mesh.size == 1 else
                      count_sharded_step(step, args, arg_specs, mesh,
                                         strategy))
        except Exception as e:     # recorded, never hidden: see main()
            if mesh.size == 1:
                raise
            result["sharded_error"] = _error_line(e)
        else:
            memory["output_size_in_bytes"] = counts.pop(
                "output_size_in_bytes")
            memory["temp_size_in_bytes"] = counts.pop("temp_size_in_bytes")
            result.update(counts)
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
                    help="the 2x16x16 production mesh")
    ap.add_argument("--both", action="store_true",
                    help="the reference's two production meshes, 16x16 and "
                         "2x16x16")
    ap.add_argument("--single-pod-only", action="store_true",
                    help="the 16x16 production mesh alone")
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
    meshes = (["pod"] if args.single_pod_only
              else ["pod", "multipod"] if args.both
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
                coll = r.get("collectives", {})
                if "sharded_error" in r:
                    failures += 1
                    print(f"FAIL {label}: sharded step: "
                          f"{r['sharded_error']} (argument bytes only: "
                          f"{mem['argument_size_in_bytes'] / 2**30:.2f}GiB)",
                          flush=True)
                    continue
                print(f"OK   {label}: {r['compile_s']}s "
                      f"flops={r.get('flops', -1):.3e} "
                      f"bytes={r.get('bytes_accessed', -1):.3e} "
                      f"coll={coll.get('total_bytes', -1):.3e}B "
                      f"{coll.get('counts', {})} "
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
