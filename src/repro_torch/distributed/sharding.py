"""Logical-axis sharding rules (MaxText-style) -> per-dimension mesh axes.

Copy of ``repro.distributed.sharding``.  Logical names are assigned
greedily onto mesh axes with divisibility checks: a rule maps a logical
axis to a tuple of mesh axes; axes already consumed by an earlier dim of
the same tensor are skipped, and the longest prefix whose product
divides the dim size is used (else the dim stays replicated).  This
resolves e.g. GQA kv_heads=8 on a 16-way "model" axis (-> replicated /
seq-sharded instead) and batch=1 long-context decode (-> KV-sequence
takes data+model).

Where JAX's ``spec_for`` returns a ``PartitionSpec``, this one returns
one tuple of mesh axes per dimension (``()`` = replicated); JAX's spec
holds the same axes, a single axis as its bare name.  ``placements``
turns such a spec into the DTensor placements (``Shard(i)`` /
``Replicate()``) of a ``torch.distributed`` ``DeviceMesh``, and
``local_shape`` gives one device's shard.  The meshes are
``launch.mesh.Mesh`` descriptions (axis names and sizes).

``shard(x, *axes)``, the activation constraint of model code, is the
counterpart of ``with_sharding_constraint``: it returns ``x`` unchanged
where no mesh of more than one device is active, as JAX does on a 1x1
mesh; under a larger mesh it redistributes a DTensor
(``torch.distributed.tensor``) to the placements of ``spec_for`` on its
own ``DeviceMesh``, and raises for a plain tensor, which would otherwise
stay replicated without a word.  ``mesh_context`` holds the mesh
description, its ``DeviceMesh`` and the activation rules, and inside a
larger mesh it lets plain constants (RoPE's frequencies, an ``arange``)
meet DTensors as replicated values (``implicit_replication``).
``named_sharding`` and ``distribute_tree`` are the counterparts of
``NamedSharding`` and ``jax.device_put(tree, tree_shardings(...))``.

``fake_world(size)`` opens a one-process world of ``size`` ranks over
PyTorch's ``FakeProcessGroup`` (registered here as the ``"fake"``
backend): every collective returns at once with a result of the right
shape and meaningless values, which is what the production-mesh dry-run
(``launch.dryrun``) needs to run a step as one rank of 256 or 512.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Rules.  Params and activations use distinct vocabularies so that "embed"
# (FSDP-sharded on params) never collides with activation batch sharding.
# ---------------------------------------------------------------------------
PARAM_RULES: dict[str, tuple] = {
    "layer": (),
    "vocab": ("model",),
    "embed": ("data",),          # FSDP / ZeRO-3: gathered just-in-time
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "expert": ("model",),
    "expert_embed": ("data",),   # expert-weight FSDP dim
    "expert_mlp": ("model",),    # per-expert d_ff TP (mixtral-style)
    "conv": (),
    "mamba_inner": ("model",),
    "mamba_heads": ("model",),
    "mamba_state": (),
}

ACT_RULES: dict[str, tuple] = {
    "batch": ("pod", "data"),
    "seq": (),
    "res_seq": (),                 # inter-block residual (SP shards this)
    "embed": (),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "expert_mlp": ("model",),
    "kv_seq": ("data", "model"),   # decode KV-sequence sharding (flash-decode)
    "mamba_heads": ("model",),
    "mamba_inner": ("model",),
    "mamba_state": (),
    "layer": (),
}


def strategy_rules(strategy: str) -> tuple[dict, dict]:
    """-> (param_rules, act_rules) for a sharding strategy.

    "tp": megatron tensor parallel — heads/mlp/experts on "model";
          residual replicated across model (decode/prefill).
    "tp_infer": the serving layout — weights replicated across "data",
          sharded only on "model"; expert banks keep (data x model).
    "sp": fully-sharded sequence parallel — the residual stream's seq dim
          on "model", params ZeRO-3 over (data, model) (training).
    """
    if strategy == "tp":
        return dict(PARAM_RULES), dict(ACT_RULES)
    if strategy == "tp_infer":
        return dict(PARAM_RULES, embed=()), dict(ACT_RULES)
    if strategy != "sp":
        raise ValueError(f"unknown strategy {strategy!r} "
                         f"(use 'tp', 'tp_infer' or 'sp')")
    param = dict(PARAM_RULES, embed=("data", "model"), heads=(), kv_heads=(),
                 mlp=(), vocab=("model",), mamba_inner=())
    act = dict(ACT_RULES, res_seq=("model",), heads=(), kv_heads=(), mlp=(),
               mamba_inner=())
    return param, act


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: dict, mesh) -> tuple:
    """-> one tuple of mesh axes per dim of ``shape`` (``()`` where the
    dim stays replicated)."""
    used: set[str] = set()
    out = []
    sizes = mesh.sizes
    for dim, name in zip(shape, axes):
        assigned: tuple = ()
        if name is not None:
            cand = tuple(a for a in rules.get(name, ())
                         if a in sizes and a not in used)
            # take the longest prefix whose product divides the dim
            while cand:
                prod = math.prod(sizes[a] for a in cand)
                if prod > 1 and dim % prod == 0:
                    assigned = cand
                    break
                cand = cand[:-1]
        used.update(assigned)
        out.append(assigned)
    return tuple(out)


def local_shape(shape: Sequence[int], spec: tuple, mesh) -> tuple:
    """One device's shard of a tensor of ``shape`` under ``spec`` (every
    assigned product divides its dim, so the shards are equal)."""
    sizes = mesh.sizes
    return tuple(d // math.prod(sizes[a] for a in ax)
                 for d, ax in zip(shape, spec))


def placements(spec: tuple, device_mesh) -> list:
    """The DTensor placements of ``spec`` on a ``DeviceMesh`` whose
    dimension names are the spec's mesh axes: ``Shard(i)`` on each mesh
    dim that tensor dim ``i`` takes, ``Replicate()`` on the rest.  A
    tensor dim over several mesh dims is split in mesh-dim order, as
    JAX splits a tuple of axes."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {a: i for i, ax in enumerate(spec) for a in ax}
    return [Shard(owner[name]) if name in owner else Replicate()
            for name in device_mesh.mesh_dim_names]


def tree_shardings(axes, abstract, mesh, rules=None):
    """Zip a tree of logical-axes tuples with a tree of tensors (meta or real) -> a
    tree of specs."""
    rules = rules or PARAM_RULES

    def walk(ax, a):
        if isinstance(ax, dict):
            return {k: walk(ax[k], a[k]) for k in ax}
        return spec_for(a.shape, tuple(ax), rules, mesh)
    return walk(axes, abstract)


# ---------------------------------------------------------------------------
# DeviceMesh helpers: placements of a spec, whole trees, a fake world.
# ---------------------------------------------------------------------------
def describe(device_mesh):
    """The ``launch.mesh.Mesh`` description of a ``DeviceMesh``."""
    from repro_torch.launch.mesh import Mesh
    return Mesh(tuple(device_mesh.mesh.shape),
                tuple(device_mesh.mesh_dim_names))


def named_sharding(shape, axes, device_mesh, rules=None) -> list:
    """The DTensor placements of a tensor of ``shape`` with logical
    ``axes`` on ``device_mesh`` (default rules ``PARAM_RULES``): the
    counterpart of JAX's ``named_sharding``."""
    spec = spec_for(shape, axes, rules or PARAM_RULES, describe(device_mesh))
    return placements(spec, device_mesh)


def distribute_tree(tree, specs, device_mesh):
    """Every tensor of ``tree`` as a DTensor on ``device_mesh`` with the
    placements of its spec in ``specs`` (a tree of ``spec_for`` tuples of
    the same keys, e.g. ``tree_shardings``'), as ``jax.device_put(tree,
    tree_shardings(...))`` places a tree.  Each rank takes its own shard
    of its own copy of the tensor (no collective): the callers build the
    same tree on every rank from one seed, or on ``meta``."""
    def put(t, spec):
        pl = effective(placements(spec, device_mesh), device_mesh)
        local = t
        for dim, p in enumerate(pl):
            if p.is_shard():
                local = local.tensor_split(device_mesh.size(dim), dim=p.dim)[
                    device_mesh.get_local_rank(dim)]
        return from_local_as(local, device_mesh, pl, t.shape)

    def walk(t, sp):
        if isinstance(t, dict):
            return {k: walk(t[k], sp[k]) for k in t}
        return put(t, sp)
    return walk(tree, specs)        # a bare tensor with its spec too


def _contiguous_stride(shape) -> tuple:
    out, acc = [], 1
    for d in reversed(tuple(shape)):
        out.append(acc)
        acc *= d
    return tuple(reversed(out))


def _create_fake_pg(common_opts, backend_opts):
    from torch._C._distributed_c10d import FakeProcessGroup
    return FakeProcessGroup._create_internal(
        common_opts.group_rank, common_opts.group_size, backend_opts)


def register_fake_backend() -> None:
    """Register PyTorch's ``FakeProcessGroup`` as the ``"fake"`` c10d
    backend (once): its collectives do no communication and return
    tensors of the right shapes."""
    import torch.distributed as dist
    if "FAKE" in getattr(dist.Backend, "_plugins", {}):
        return
    dist.Backend.register_backend("fake", _create_fake_pg,
                                  extended_api=True,
                                  devices=["cpu", "cuda"])


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A world of ``size`` ranks over the fake backend in which this
    process is ``rank``; the group is destroyed on exit."""
    import torch.distributed as dist
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already open")
    register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Activation constraints inside model code: shard(x, "batch", "seq", "embed").
# ---------------------------------------------------------------------------
_CTX = threading.local()


@contextlib.contextmanager
def mesh_context(mesh, rules: Optional[dict] = None, device_mesh=None):
    """Activate ``mesh`` (a ``launch.mesh.Mesh``) and its ``DeviceMesh``
    with the activation ``rules`` laid over ``ACT_RULES``.  On a mesh of
    more than one device, plain tensors meet DTensors as replicated
    values while it is active (``implicit_replication``)."""
    prev = (getattr(_CTX, "mesh", None), getattr(_CTX, "rules", None),
            getattr(_CTX, "device_mesh", None))
    _CTX.mesh, _CTX.rules = mesh, dict(ACT_RULES, **(rules or {}))
    _CTX.device_mesh = device_mesh
    try:
        if mesh is not None and mesh.size > 1:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.device_mesh = prev


def current_mesh():
    return getattr(_CTX, "mesh", None)


def current_device_mesh():
    return getattr(_CTX, "device_mesh", None)


def is_dtensor(x) -> bool:
    """True for a ``torch.distributed.tensor.DTensor`` (without importing
    ``torch.distributed`` for a plain tensor)."""
    if type(x).__name__ != "DTensor":
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicated(x, like):
    """``x`` as a replicated DTensor on the mesh of the DTensor ``like``;
    ``x`` itself where ``like`` is a plain tensor or ``x`` a DTensor."""
    if not is_dtensor(like) or is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def reduce_partial(x):
    """A DTensor with partial sums, those sums reduced (the mesh dims they
    lie on replicated); anything else itself."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def shard(x, *axes):
    """``x`` itself where no mesh of more than one device is active;
    under a larger mesh, the DTensor ``x`` redistributed to the
    placements of ``spec_for(x.shape, axes)`` on its own device mesh
    (``x`` itself where it already has them), the counterpart of
    ``with_sharding_constraint``.  A plain tensor there raises."""
    mesh = getattr(_CTX, "mesh", None)
    if mesh is None or mesh.size == 1:
        return x
    if not is_dtensor(x):
        raise TypeError(f"shard{axes}: a plain {type(x).__name__} of shape "
                        f"{tuple(x.shape)} under a {mesh.shape} mesh (a "
                        f"DTensor is expected)")
    spec = spec_for(x.shape, axes, _CTX.rules, mesh)
    want = tuple(effective(placements(spec, x.device_mesh), x.device_mesh))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# ---------------------------------------------------------------------------
# Local shards: the ops whose DTensor rules differ between torch releases
# (a product, a pad, a stack of layer groups) run on each rank's local
# tensor between plain redistributions (gather, reduce, slice).
# ---------------------------------------------------------------------------
def effective(pl, device_mesh) -> list:
    """``pl`` with a replica on every mesh dim of size 1: a shard there
    is the whole tensor, and some torch releases plan redistributions of
    a tensor dim sharded over two mesh dims wrongly when one is trivial."""
    from torch.distributed.tensor import Replicate
    return [Replicate() if device_mesh.size(d) == 1 else p
            for d, p in enumerate(pl)]


def to_local_as(x, device_mesh, pl, work=None):
    """The local tensor of ``x`` laid out as ``pl`` (a plain ``x`` is taken
    as replicated).  ``work``: the placements of the op that reads it;
    over a mesh dim where that op is split and ``x`` replicated, each
    rank reads ``x`` for its own part, so the gradient of ``x`` there is
    a partial sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if x is None:
        return None
    if not is_dtensor(x):
        x = DTensor.from_local(x, device_mesh,
                               [Replicate()] * device_mesh.ndim,
                               run_check=False)
    pl = list(pl)
    if list(x.placements) != pl:
        x = x.redistribute(device_mesh, pl)
    work = pl if work is None else work
    return x.to_local(grad_placements=[
        Partial() if (w.is_shard() or w.is_partial()) and p.is_replicate()
        else p for w, p in zip(work, pl)])


def from_local_as(local, device_mesh, pl, shape):
    """A DTensor of global ``shape`` (contiguous) laid out as ``pl`` whose
    local tensor on this rank is ``local`` (made contiguous: DTensor's
    views run as views of the local tensor)."""
    import torch
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), device_mesh, list(pl),
                              run_check=False,
                              shape=torch.Size(tuple(shape)),
                              stride=_contiguous_stride(shape))


def mesh_chunk(device_mesh, dims) -> tuple:
    """(index, count) of this rank's chunk of a tensor dim split over the
    mesh dims ``dims`` in mesh-dim order, as ``placements`` splits it."""
    c, n = 0, 1
    for d in dims:
        c = c * device_mesh.size(d) + device_mesh.get_local_rank(d)
        n *= device_mesh.size(d)
    return c, n


def _unshard(x, dim: int):
    """``x`` with its shards of tensor dim ``dim`` gathered."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if p.is_shard() and p.dim == dim else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


def pad_dim(x, dim: int, before: int, after: int, value=0.0):
    """``x`` padded with ``value`` along ``dim`` (``before`` in front,
    ``after`` behind); a DTensor is padded on its local tensor, its
    ``dim`` gathered first where it is sharded."""
    import torch
    pad = [0, 0] * (x.dim() - 1 - dim) + [before, after]
    if not is_dtensor(x):
        return torch.nn.functional.pad(x, pad, value=value)
    x = _unshard(x, dim)
    shape = list(x.shape)
    shape[dim] += before + after
    return from_local_as(
        torch.nn.functional.pad(x.to_local(), pad, value=value),
        x.device_mesh, x.placements, shape)


def stack_groups(tensors: list):
    """``torch.stack`` of the layer groups' tensors (one layout, DTensors
    or plain) along a new leading dim."""
    import torch
    if not is_dtensor(tensors[0]):
        return torch.stack(tensors)
    from torch.distributed.tensor import Shard
    t0 = tensors[0]
    pl = [Shard(p.dim + 1) if p.is_shard() else p for p in t0.placements]
    return from_local_as(torch.stack([t.to_local() for t in tensors]),
                         t0.device_mesh, pl, (len(tensors), *t0.shape))


def group_of(x, g: int):
    """``x[g]`` of a stacked tree's leaf: a view, so in-place writes reach
    the stacked tensor (a DTensor's local view, its layout kept)."""
    if not is_dtensor(x):
        return x[g]
    from torch.distributed.tensor import Shard
    pl = [Shard(p.dim - 1) if p.is_shard() else p for p in x.placements]
    return from_local_as(x.to_local()[g], x.device_mesh, pl, x.shape[1:])
