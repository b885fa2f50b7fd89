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

``shard(x, *axes)``, the activation constraint of model code, returns
``x`` unchanged where no mesh of more than one device is active, as
``with_sharding_constraint`` does on a 1x1 mesh; under a larger mesh it
raises ``NotImplementedError``: sharded execution of the models is
ROADMAP Queue A item 9b (multi-GPU), and the port's model code calls no
``shard`` yet.
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
# Activation constraints inside model code: shard(x, "batch", "seq", "embed").
# ---------------------------------------------------------------------------
_CTX = threading.local()


@contextlib.contextmanager
def mesh_context(mesh, rules: Optional[dict] = None):
    prev = getattr(_CTX, "mesh", None), getattr(_CTX, "rules", None)
    _CTX.mesh, _CTX.rules = mesh, dict(ACT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return getattr(_CTX, "mesh", None)


def shard(x, *axes):
    """``x`` itself where no mesh of more than one device is active;
    under a larger mesh, ``NotImplementedError`` (ROADMAP Queue A item
    9b, multi-GPU)."""
    mesh = getattr(_CTX, "mesh", None)
    if mesh is None or mesh.size == 1:
        return x
    raise NotImplementedError(
        f"shard{axes} on a {mesh.shape} mesh: sharded execution is not "
        f"ported yet (ROADMAP Queue A item 9b, multi-GPU)")

