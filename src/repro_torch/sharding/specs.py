"""Sharding rules for the production meshes (counterpart of
``repro.sharding.specs``; the rules are the JAX package's, unchanged).

Policy: 2-D **TP × FSDP** per pod —

* every ≥2-D weight shards its *contraction-adjacent* large dim over
  ``model`` (tensor parallelism: attention heads / ffn intermediate /
  vocab / experts) and its other large dim over ``data`` (FSDP / ZeRO-3),
* activations shard batch over (``pod``, ``data``),
* decode KV caches shard the *sequence* dim over ``model`` (kv-head counts
  of the assigned archs are mostly < 16, so head-sharding is not
  available),
* scalars / small vectors replicate.

Name-based overrides first, then a dimension-divisibility fallback, so
every architecture gets a layout even where its dims don't divide the
mesh.

A mesh is anything with ``.shape`` (axis name -> size) and
``.axis_names`` (``launch.mesh.Mesh``). A spec is a tuple with one entry
per leading dimension it names, as ``jax.sharding.PartitionSpec`` holds
them: an axis name, a tuple of names, or ``None``; ``()`` replicates. The
entries are in PartitionSpec's normal form: a one-name tuple is its name,
an empty one ``None``. Trees are nested dicts, lists, tuples and
NamedTuples of tensors (meta-device ones allocate nothing); only shapes
are read. ``named`` has no counterpart: there is no device mesh to bind a
spec to.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

from repro_torch.utils.trees import tree_map

Spec = Tuple[Any, ...]


def _spec(*entries) -> Spec:
    """A spec in PartitionSpec's normal form."""
    def norm(e):
        if isinstance(e, (tuple, list)):
            e = tuple(e)
            return None if not e else (e[0] if len(e) == 1 else e)
        return e
    return tuple(norm(e) for e in entries)


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes used for data parallelism ('pod' folds into data)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def _divides(dim: int, mesh, axes) -> bool:
    n = _axis_size(mesh, axes)
    return dim % n == 0 and dim >= n


# Weight-name fragments whose *last* dim is TP-sharded (output-feature TP).
_COL_PARALLEL = ("w_q", "w_k", "w_v", "w_gate", "w_up", "w_in", "w_mlp_up",
                 "w_dkv", "w_kpe", "w_uk", "w_uv", "b_q", "b_k", "b_v",
                 "lm_head", "router", "w_gates", "b_in")
# Weight-name fragments whose *first non-stack* dim is TP-sharded (input TP,
# output needs reduce — the "pre-aggregation" side).
_ROW_PARALLEL = ("w_o", "w_down", "w_out", "w_mlp_down")
_EXPERT_STACKED = ("w_gate", "w_up", "w_down")  # under a "moe" subtree


def _leaf_spec(path: str, shape: Tuple[int, ...], mesh,
               stacked: bool, fsdp: bool = True) -> Spec:
    """Spec for one parameter leaf. ``stacked``: leading scan dim.

    ``fsdp=False`` (inference): weights are TP-sharded only — per-layer
    FSDP all-gathers don't amortize over one decoded token.
    """
    d_ax = data_axes(mesh) if fsdp else ()
    lead = (None,) if stacked else ()
    dims = shape[1:] if stacked else shape
    name = path.rsplit("/", 1)[-1]

    def dax_if(dim: int):
        return d_ax if (d_ax and _divides(dim, mesh, d_ax)) else None

    if len(dims) == 0:
        return _spec(*lead)
    # MoE expert stacks: [E, D, F] — experts over model (expert parallelism),
    # D over data (FSDP).
    if "moe" in path and name in _EXPERT_STACKED and len(dims) == 3:
        e, d, f = dims
        return _spec(*lead, "model" if _divides(e, mesh, "model") else None,
                     dax_if(d), None)
    if name == "embed" and len(dims) == 2:
        v, d = dims
        if not fsdp:
            # Inference: vocab replicated, d_model over model — the token
            # gather is collective-free.
            return _spec(*lead, None,
                         "model" if _divides(d, mesh, "model") else None)
        # Train: small tables replicate outright (local gather, no
        # replication waste); big ones keep vocab x data.
        if v * d * 4 <= 512 * 1024 * 1024:
            return _spec(*lead, None, None)
        return _spec(*lead, "model" if _divides(v, mesh, "model") else None,
                     dax_if(d))
    if len(dims) == 1:
        n = dims[0]
        if any(k in name for k in _COL_PARALLEL) and _divides(n, mesh, "model"):
            return _spec(*lead, "model")
        return _spec(*lead, None)
    if len(dims) == 2:
        a, b = dims
        if any(name == k or name.startswith(k) for k in _ROW_PARALLEL):
            return _spec(*lead, "model" if _divides(a, mesh, "model") else None,
                         dax_if(b))
        if any(name == k or name.startswith(k) for k in _COL_PARALLEL):
            return _spec(*lead, dax_if(a),
                         "model" if _divides(b, mesh, "model") else None)
        # Fallback: biggest dim -> model, other -> data.
        if a >= b:
            return _spec(*lead, "model" if _divides(a, mesh, "model") else None,
                         dax_if(b))
        return _spec(*lead, dax_if(a),
                     "model" if _divides(b, mesh, "model") else None)
    # rank >= 3 fallback: shard the largest divisible dim over model.
    sizes = list(dims)
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    spec: list = [None] * len(sizes)
    for i in order:
        if _divides(sizes[i], mesh, "model"):
            spec[i] = "model"
            break
    return _spec(*lead, *spec)


def param_specs(param_shapes, mesh, stacked_keys=("blocks", "enc_blocks"),
                fsdp: bool = True):
    """Tree of specs matching ``param_shapes`` (tensors or anything with a
    ``.shape``; ``models.init_params(..., device="meta")`` gives them)."""

    def rec(prefix, node, stacked):
        if isinstance(node, dict):
            return {k: rec(f"{prefix}/{k}" if prefix else k, v,
                           stacked or k in stacked_keys)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [rec(f"{prefix}/{i}", v, stacked) for i, v in enumerate(node)]
            return type(node)(t)
        return _leaf_spec(prefix, tuple(node.shape), mesh, stacked, fsdp=fsdp)

    return rec("", param_shapes, False)


def batch_spec(mesh, batch: int, extra_dims: int = 1) -> Spec:
    """Spec for [B, ...] activations: batch over (pod, data) when divisible."""
    d_ax = data_axes(mesh)
    b_axis = d_ax if batch % _axis_size(mesh, d_ax) == 0 else None
    return _spec(b_axis, *([None] * extra_dims))


def cache_specs(cache_shapes, mesh, batch: int):
    """Specs for a ServeCache tree: [L, B, S, ...] — B over data if it
    divides, cache sequence dim over model if it divides."""
    d_ax = data_axes(mesh)
    dsize = _axis_size(mesh, d_ax)
    msize = mesh.shape["model"]

    def leaf(x):
        shape = tuple(x.shape)
        spec: list = [None] * len(shape)
        if len(shape) >= 2 and shape[1] == batch and batch % dsize == 0:
            spec[1] = d_ax
        # Find a sequence-like dim (largest dim beyond batch) for model.
        if len(shape) >= 3:
            cand = sorted(range(2, len(shape)), key=lambda i: -shape[i])
            for i in cand:
                if shape[i] % msize == 0 and shape[i] >= 4 * msize:
                    spec[i] = "model"
                    break
        return _spec(*spec)

    return tree_map(leaf, cache_shapes)


def spec_for_array(x, mesh, batch: Optional[int] = None) -> Spec:
    shape = tuple(x.shape)
    if batch is not None and shape and shape[0] == batch:
        return batch_spec(mesh, batch, extra_dims=len(shape) - 1)
    return _spec(*([None] * len(shape)))


def shard_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The per-device block of a ``shape`` laid out by ``spec``: each dim
    divided by the sizes of the axes its entry names."""
    out = list(shape)
    for i, axes in enumerate(spec):
        if axes is None:
            continue
        n = _axis_size(mesh, axes)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide over "
                             f"{axes} ({n}) in spec {spec}")
        out[i] //= n
    return tuple(out)
