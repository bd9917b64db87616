"""Production mesh definitions (counterpart of ``repro.launch.mesh``).

The JAX package builds ``jax.make_mesh`` device meshes for a TPU v5e pod.
One card holds no mesh, so a mesh here is its shape alone: a
:class:`Mesh` maps axis names to sizes (``.shape``, ``.axis_names``), the
form ``repro_torch.sharding.specs`` reads to lay parameters, batches and
caches out over the production mesh (``launch/input_specs.py``).

:func:`make_worker_mesh` and :func:`make_hier_worker_mesh` give the GCN
trainer's axes in the same form, and :func:`mesh_groups` turns such a
mesh into ``torch.distributed`` process groups, one process per device
of the mesh: ``exec.mode=shard_map`` (``launch/spmd.py``) runs its
collectives over them.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class Mesh:
    """Axis names and their sizes, in order."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; multi-pod adds a leading pod axis (512)."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_worker_mesh(nworkers: int, axis: str = "workers") -> Mesh:
    """1-D graph-parallel mesh of the distributed GCN trainer."""
    return Mesh((axis,), (nworkers,))


def make_hier_worker_mesh(num_groups: int, group_size: int,
                          group_axis: str = "group",
                          node_axis: str = "node") -> Mesh:
    """2-D mesh of the two-level halo exchange: (groups, workers a group)."""
    return Mesh((group_axis, node_axis), (num_groups, group_size))


def mesh_groups(mesh: Mesh, rank: int) -> Dict[str, object]:
    """The ``torch.distributed`` process group of each mesh axis that
    ``rank`` belongs to: the ranks that differ from it along that axis
    alone. Ranks number the mesh's devices in row-major order, so on a
    ``(group, node)`` mesh rank ``r = g * W + w``, the order of the stacked
    workers (``core.exchange.StageTopo``'s ``lead = (G, W)``).

    A flat mesh gives the world group. A ``(group, node)`` mesh gives one
    node group per group (``g * W + v`` for v < W) and one group-axis group
    per node position (``b * W + w`` for b < G). Every rank must call this
    in the same order, after ``init_process_group``: ``new_group`` is a
    collective over the world, so each rank creates every group, its own
    or not, in one order."""
    import torch.distributed as dist

    world = 1
    for n in mesh.sizes:
        world *= n
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {mesh.shape} holds {world} devices, the process "
                         f"group {dist.get_world_size()}")
    strides = [1] * len(mesh.sizes)
    for i in range(len(mesh.sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * mesh.sizes[i + 1]
    coord = [rank // strides[i] % n for i, n in enumerate(mesh.sizes)]
    groups: Dict[str, object] = {}
    for a, (name, size) in enumerate(zip(mesh.axis_names, mesh.sizes)):
        if size == world:
            groups[name] = dist.group.WORLD
            continue
        others = [range(n) if i != a else range(1) for i, n in enumerate(mesh.sizes)]
        for fixed in itertools.product(*others):
            base = sum(c * s for c, s in zip(fixed, strides))
            ranks = [base + k * strides[a] for k in range(size)]
            pg = dist.new_group(ranks)
            if all(c == coord[i] for i, c in enumerate(fixed) if i != a):
                groups[name] = pg
    return groups
