"""Sharding rules for the production meshes (counterpart of
``repro.sharding``).

``specs`` holds the rules over a mesh's shape (``launch.mesh.Mesh``) and
meta-device tensors. The JAX package's ``compat`` module has no
counterpart: it shims drift in JAX's ``axis_size``, ``AbstractMesh`` and
mesh-context API, none of which the port uses, so ``abstract_mesh``,
``axis_size`` and ``mesh_context`` are not exported here.
``quantized_collectives`` holds the quantized all-to-all and all-reduce
over a stacked worker axis.
"""

from repro_torch.sharding.quantized_collectives import (
    quantized_all_to_all,
    quantized_psum,
    quantized_psum_tree,
)
from repro_torch.sharding.specs import (
    batch_spec,
    cache_specs,
    data_axes,
    param_specs,
    spec_for_array,
)

__all__ = [
    "quantized_all_to_all",
    "quantized_psum",
    "quantized_psum_tree",
    "param_specs",
    "batch_spec",
    "cache_specs",
    "data_axes",
    "spec_for_array",
]
