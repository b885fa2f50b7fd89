"""Mesh descriptions and the device constants of the roofline terms.

Counterpart of ``repro.launch.mesh``.  A mesh here is a description,
axis names and sizes, with no devices behind it:
``make_production_mesh`` gives the reference's production layouts
(``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
``("pod", "data", "model")`` with ``multi_pod=True``), which the
sharding rules (``distributed.sharding``) and the dry-run
(``launch.dryrun``) read by shape alone; ``make_local_mesh`` gives the
local cards as ``(1, N)``.

The constants are one NVIDIA H100 SXM's datasheet figures (per card,
700 W): the dense bf16 tensor-core peak, the HBM3 rate and NVLink.  They
are the card's published peaks, not a measurement.  ``LINK_BW`` is
NVLink 4's 450 GB/s in each direction, half of the 900 GB/s the
datasheet gives as the total of both directions: a ring collective
sends and receives at once, so the time its bytes take on the wire is
set by one direction's rate, as the roofline's collective term counts
them (``launch.roofline``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class Mesh:
    """A logical device mesh: ``shape[i]`` devices along ``axis_names[i]``."""
    shape: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in rank")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def make_local_mesh() -> Mesh:
    """The local cards (one mesh entry when there is none): 1xN over
    ("data", "model")."""
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return Mesh((1, max(n, 1)), ("data", "model"))


PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense (no sparsity)
HBM_BW = 3.35e12                  # B/s
LINK_BW = 450e9                   # B/s, NVLink 4, each direction


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """The ``torch.distributed`` ``DeviceMesh`` of ``mesh`` over the open
    process group (its size must be the group's), with the mesh's axis
    names as its dimension names."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(mesh.shape),
                            mesh_dim_names=tuple(mesh.axis_names))
