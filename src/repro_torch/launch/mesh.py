"""Device meshes of the dry-run and of the sharding rules, the counterpart
of the JAX package's ``launch/mesh.py``.

A mesh here is a small frozen value, its axis names and their extents, and
no devices: the sharding rules read nothing else of a mesh
(``parallel/sharding.py``), and the dry-run counts on the meta device, so
a 16x16 or 2x16x16 mesh needs no card. Where a process group is up,
:func:`as_device_mesh` turns one into a
``torch.distributed.device_mesh.DeviceMesh`` with the same axis names.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> extent, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def name(self) -> str:
        """"16x16", "2x16x16": the dry-run record's ``mesh``."""
        return "x".join(str(s) for s in self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_tiny_mesh(*, data: int = 2, model: int = 4) -> Mesh:
    """Small mesh for the CPU tests (gloo processes)."""
    return Mesh(("data", "model"), (data, model))


def n_chips(mesh: Mesh) -> int:
    return math.prod(mesh.sizes)


def as_device_mesh(mesh: Mesh, device_type: str = "cpu"):
    """The ``DeviceMesh`` of ``mesh`` over the ranks of the default process
    group (which must hold ``n_chips(mesh)`` ranks), its dims named as the
    mesh's axes."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, mesh.sizes,
                            mesh_dim_names=mesh.axis_names)
