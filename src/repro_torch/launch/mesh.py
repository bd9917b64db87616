"""Production mesh definitions (counterpart of ``repro.launch.mesh``).

The JAX package builds ``jax.make_mesh`` device meshes for a TPU v5e pod.
One card holds no mesh, so a mesh here is its shape alone: a
:class:`Mesh` maps axis names to sizes (``.shape``, ``.axis_names``), the
form ``repro_torch.sharding.specs`` reads to lay parameters, batches and
caches out over the production mesh (``launch/input_specs.py``).

:func:`make_worker_mesh` and :func:`make_hier_worker_mesh` give the GCN
trainer's axes in the same form. Nothing on the card consumes them: the
port runs the workers stacked on one device (``exec.mode=vmap``) or as
processes (``multiproc``), and refuses ``shard_map`` (ROADMAP A2).
"""

from __future__ import annotations

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
