"""Meta-device stand-ins for every (arch × input-shape) combination
(counterpart of ``repro.launch.input_specs``).

The JAX package builds ``ShapeDtypeStruct``\\ s with a ``NamedSharding``
on the production mesh, so that its dry-run can lower the step functions
without allocating. Here each leaf is a :class:`Sharded`: a tensor on the
``meta`` device (a shape and a dtype, no storage), its spec
(``repro_torch.sharding.specs``) and its per-device shard shape on the
mesh (``launch.mesh.Mesh``). Parameters and caches come from the port's
own ``init_params`` and ``init_cache`` on ``device="meta"``, so nothing is
allocated. Modality frontends are stubbed as in the JAX package: audio
supplies frame embeddings, VLM patch embeddings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import InputShape, get_shape
from repro_torch.models.transformer import ArchConfig, init_cache, init_params
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import specs as SP
from repro_torch.utils.trees import tree_map

# Archs that need the sliding-window attention variant to run long_500k
# sub-quadratically (dense/vlm/moe families). SSM/hybrid run natively.
LONG_CONTEXT_WINDOW = 8192
# Token budget per device per microbatch (activation-memory bound).
MB_TOKENS_PER_DEVICE = 8192


@dataclass(frozen=True, eq=False)
class Sharded:
    """A meta-device tensor laid out on a mesh: the port's
    ``ShapeDtypeStruct(shape, dtype, sharding=NamedSharding(mesh, spec))``."""

    tensor: torch.Tensor              # on the meta device
    spec: SP.Spec
    shard_shape: Tuple[int, ...]      # the block one device holds

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype


def skip_reason(arch: ArchConfig, shape: InputShape) -> Optional[str]:
    if arch.family == "audio" and shape.name == "long_500k":
        return ("whisper-small: enc-dec audio model with 30s receptive field; "
                "524k-token decode is architecturally meaningless (DESIGN.md §5)")
    return None


def effective_window(arch: ArchConfig, shape: InputShape) -> Optional[int]:
    """Sliding window override for long_500k on attention-bearing archs."""
    if shape.name == "long_500k" and arch.family in ("dense", "moe", "vlm", "hybrid"):
        return min(arch.window, LONG_CONTEXT_WINDOW) if arch.window else LONG_CONTEXT_WINDOW
    return arch.window


def num_microbatches(arch: ArchConfig, shape: InputShape, mesh) -> int:
    dp = 1
    for a in SP.data_axes(mesh):
        dp *= mesh.shape[a]
    tokens_per_dev = shape.global_batch * shape.seq_len // max(dp, 1)
    nm = max(1, tokens_per_dev // MB_TOKENS_PER_DEVICE)
    while shape.global_batch % nm:
        nm -= 1
    return nm


def _sharded(t: torch.Tensor, mesh, spec: SP.Spec) -> Sharded:
    return Sharded(t, spec, SP.shard_shape(tuple(t.shape), spec, mesh))


def _meta(shape, dtype, mesh, spec: SP.Spec) -> Sharded:
    return _sharded(torch.empty(shape, dtype=dtype, device="meta"), mesh, spec)


def _spec_tree(tensors, specs, mesh):
    """Pair each tensor of ``tensors`` with the spec at the same place."""
    if isinstance(tensors, dict):
        return {k: _spec_tree(v, specs[k], mesh) for k, v in tensors.items()}
    if isinstance(tensors, tuple) and hasattr(tensors, "_fields"):
        return type(tensors)(*(_spec_tree(t, s, mesh) for t, s in zip(tensors, specs)))
    if isinstance(tensors, (list, tuple)):
        return type(tensors)(_spec_tree(t, s, mesh) for t, s in zip(tensors, specs))
    return None if tensors is None else _sharded(tensors, mesh, specs)


def param_input_specs(arch: ArchConfig, mesh, fsdp: bool = True):
    shapes = init_params(None, arch, device="meta")
    specs = SP.param_specs(shapes, mesh, fsdp=fsdp)
    return _spec_tree(shapes, specs, mesh), specs


def opt_input_specs(params, mesh) -> AdamWState:
    """AdamW's state laid out as the parameters it follows."""
    def like(s: Sharded) -> Sharded:
        return Sharded(torch.empty_like(s.tensor), s.spec, s.shard_shape)
    return AdamWState(step=_meta((), torch.int32, mesh, ()),
                      mu=tree_map(like, params), nu=tree_map(like, params))


def batch_input_specs(arch: ArchConfig, shape: InputShape, mesh) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _meta((b, s), torch.int32, mesh,
                             SP.batch_spec(mesh, b, extra_dims=1))}
    if arch.family == "audio":
        batch["frames"] = _meta((b, arch.enc_frames, arch.d_model), torch.float32,
                                mesh, SP.batch_spec(mesh, b, extra_dims=2))
    if arch.family == "vlm":
        batch["patches"] = _meta((b, arch.vision_patches, arch.d_model), torch.float32,
                                 mesh, SP.batch_spec(mesh, b, extra_dims=2))
    return batch


def decode_input_specs(arch: ArchConfig, shape: InputShape, mesh):
    b = shape.global_batch
    window = effective_window(arch, shape)
    cache_shapes = init_cache(arch, b, shape.seq_len, window=window, device="meta")
    cache = _spec_tree(cache_shapes, SP.cache_specs(cache_shapes, mesh, b), mesh)
    tokens = _meta((b, 1), torch.int32, mesh, SP.batch_spec(mesh, b, extra_dims=1))
    return cache, tokens


def input_specs(arch: ArchConfig, shape_name: str, mesh) -> Dict[str, Any]:
    """Everything needed to run the step function for this combination."""
    shape = get_shape(shape_name)
    reason = skip_reason(arch, shape)
    if reason:
        return {"skip": reason}
    window = effective_window(arch, shape)
    # Inference shapes drop the FSDP ('data') axis from weight specs:
    # per-layer weight all-gathers don't amortize over one decoded token.
    params, pspecs = param_input_specs(arch, mesh, fsdp=(shape.kind == "train"))
    out: Dict[str, Any] = {"params": params, "param_specs": pspecs,
                           "window": window, "shape": shape}
    if shape.kind == "train":
        out["opt_state"] = opt_input_specs(params, mesh)
        out["batch"] = batch_input_specs(arch, shape, mesh)
        out["num_microbatches"] = num_microbatches(arch, shape, mesh)
    elif shape.kind == "prefill":
        out["batch"] = batch_input_specs(arch, shape, mesh)
    else:  # decode
        cache, tokens = decode_input_specs(arch, shape, mesh)
        out["cache"] = cache
        out["tokens"] = tokens
    return out
