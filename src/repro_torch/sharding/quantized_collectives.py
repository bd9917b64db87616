"""The paper's quantized-communication scheme applied to dense-training
collectives (counterpart of ``repro.sharding.quantized_collectives``).

The GCN halo exchange quantizes boundary-node features before the
all-to-all (paper §6). The same mechanism transfers to transformer
training:

* :func:`quantized_psum` — a data-parallel gradient all-reduce as a
  quantized reduce-scatter (quantize -> all-to-all -> local fp32 sum)
  followed by a quantized all-gather;
* :func:`quantized_all_to_all` — an all-to-all of quantized payloads (the
  MoE token -> expert transfer is the exchange closest to the paper's).

Both use the per-4-row-group (zero, scale) format of ``quant.stochastic``
with stochastic rounding, so Lemma 1's unbiasedness argument carries over.
They are options, never part of the paper-faithful baseline.

One card holds no mesh, so the P workers are a leading axis of every
tensor and each collective is a tensor operation over it, as
``core.exchange``'s stacked wire runs them: worker ``i``'s buffer is
``x[i]``. Quantize-and-pack and unpack-and-dequantize go through
``kernels.ops.quantize_pack`` / ``dequantize_unpack``: on CUDA tensors
one launch of ``quant_pack`` (or ``dequant_unpack``) covers all P workers,
and the packed int32 words are what crosses the worker axis; on CPU
tensors the same wrappers run their plain versions (``quant.stochastic``
plus ``pack_bits``), which give the same words. The kernels take bits in
{2, 4, 8}.

Randomness is an argument (ROADMAP's RNG rule). Each call takes its
stochastic-rounding uniforms: worker ``i``'s are ``u[i]``, in the order
``jax.random.uniform`` draws them in the JAX package (``[R/4, 4, F]`` for
an ``[R, F]`` buffer; any shape of the same size in that order is taken).
``quantized_psum`` takes two sets, ``u1`` for the reduce-scatter half and
``u2`` for the all-gather half. Where a set is not given it is drawn with
``torch.rand`` from ``generator`` (the global generator when that is
``None``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.ops import dequantize_unpack, quantize_pack
from repro_torch.quant.stochastic import ROW_GROUP
from repro_torch.utils.trees import tree_leaves

LANES = 128   # the all-reduce's row width (the JAX package's lane count)


def _uniforms(u: Optional[torch.Tensor], shape: Tuple[int, ...], like: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    if u is None:
        return torch.rand(shape, generator=generator, device=like.device,
                          dtype=torch.float32)
    if u.numel() != like.numel():
        raise ValueError(f"uniforms of {u.numel()} elements for a buffer of "
                         f"{like.numel()}")
    return u.to(device=like.device, dtype=torch.float32).reshape(shape).contiguous()


def _quantize(x: torch.Tensor, u: torch.Tensor, bits: int):
    """(packed, zero, scale) of every worker's [R, F] buffer of ``x``
    [P, R, F] in one call: R is a multiple of 4, so no row group straddles
    two workers."""
    p, rows, feat = x.shape
    packed, zero, scale = quantize_pack(x.reshape(p * rows, feat),
                                        u.reshape(p * rows, feat), bits=bits)
    return (packed.reshape(p, rows, -1), zero.reshape(p, rows // ROW_GROUP),
            scale.reshape(p, rows // ROW_GROUP))


def _dequantize(packed: torch.Tensor, zero: torch.Tensor, scale: torch.Tensor,
                bits: int, feat: int) -> torch.Tensor:
    """The inverse of :func:`_quantize` over any leading axes."""
    lead = packed.shape[:-2]
    rows = packed.shape[-2]
    out = dequantize_unpack(packed.reshape(-1, packed.shape[-1]).contiguous(),
                            zero.reshape(-1).contiguous(), scale.reshape(-1).contiguous(),
                            bits=bits, feat=feat)
    return out.reshape(*lead, rows, feat)


def _all_to_all(v: torch.Tensor, p: int) -> torch.Tensor:
    """Tiled all-to-all of ``v`` [P, P*n, ...]: worker j receives chunk j of
    every worker, in source order -> [P(dst), P(src), n, ...]."""
    return v.reshape(p, p, -1, *v.shape[2:]).transpose(0, 1)


def quantized_all_to_all(x: torch.Tensor, *, bits: int = 8,
                         u: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Tiled all-to-all of every worker's [P*R, F] buffer, ``x`` [P, P*R, F]
    fp32, with a quantized payload: worker j's result holds chunk j of each
    worker's buffer, in source order. ``u``: [P, P*R/4, 4, F] uniforms."""
    p, rows, feat = x.shape
    if rows % p or (rows // p) % ROW_GROUP:
        raise ValueError("rows per destination must be a multiple of 4")
    x = x.to(torch.float32).contiguous()
    packed, zero, scale = _quantize(x, _uniforms(u, tuple(x.shape), x, generator), bits)
    recv = _all_to_all(packed, p)                                # [P, P, R, W]
    out = _dequantize(recv, _all_to_all(zero, p), _all_to_all(scale, p), bits, feat)
    return out.reshape(p, rows, feat)


def _shard_sum(deq: torch.Tensor) -> torch.Tensor:
    """Sum over the source axis of [P(dst), P(src), n, F] in source order,
    one addition at a time: XLA's order for ``deq.sum(axis=0)`` on the CPU,
    so the shard sums (and the levels their quantization picks) are the JAX
    package's bit for bit."""
    acc = deq[:, 0]
    for i in range(1, deq.shape[1]):
        acc = acc + deq[:, i]
    return acc


def quantized_psum(g: torch.Tensor, *, bits: int = 8,
                   u1: Optional[torch.Tensor] = None, u2: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """All-reduce of every worker's ``g[i]`` (``g`` [P, ...] fp32) built as a
    quantized reduce-scatter plus a quantized all-gather: [P, ...], each
    worker's (approximate) sum.

    In the paper's vocabulary the reduce-scatter half is pre-aggregation
    (partials reduced before the transfer) and the all-gather half
    post-aggregation. Each worker's gradient is flattened and padded to a
    multiple of P * 4 * 128 values, so its [rows, 128] buffer's row groups
    align with the shards. ``u1``: [P, rows/4, 4, 128] uniforms of the
    reduce-scatter's quantization; ``u2``: [P, rows/(4P), 4, 128] of the
    all-gather's (rows = padded size / 128)."""
    p = g.shape[0]
    shape = g.shape[1:]
    flat = g.to(torch.float32).reshape(p, -1)
    n = flat.shape[1]
    pad = (-n) % (p * ROW_GROUP * LANES)
    flat = torch.nn.functional.pad(flat, (0, pad))
    rows = flat.shape[1] // LANES
    x = flat.reshape(p, rows, LANES)

    # Quantized reduce-scatter: quantize, all-to-all, dequantize, local sum.
    packed, zero, scale = _quantize(x, _uniforms(u1, tuple(x.shape), x, generator), bits)
    deq = _dequantize(_all_to_all(packed, p), _all_to_all(zero, p),
                      _all_to_all(scale, p), bits, LANES)      # [P, P, rows/P, 128]
    shard = _shard_sum(deq)                                    # [P, rows/P, 128]

    # Quantized all-gather of the reduced shards: every worker receives all
    # P shards' words and dequantizes them to the same values, so they are
    # dequantized once and the result given to each worker.
    packed2, zero2, scale2 = _quantize(
        shard, _uniforms(u2, tuple(shard.shape), shard, generator), bits)
    full = _dequantize(packed2, zero2, scale2, bits, LANES).reshape(-1)[:n]
    return full.reshape(shape).unsqueeze(0).expand(p, *shape).clone()


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in
    ``tree_leaves`` order (dict keys sorted, as JAX flattens them)."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(t, it) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    return None if tree is None else next(it)


def quantized_psum_tree(grads: Any, *, bits: int = 8,
                        us: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,
                        generator: Optional[torch.Generator] = None):
    """:func:`quantized_psum` over a tree of stacked gradients, leaf by leaf
    in ``utils.trees`` order (the JAX package folds its key once per leaf in
    that order). ``us``: one ``(u1, u2)`` per leaf, in that order."""
    leaves = tree_leaves(grads)
    if us is not None and len(us) != len(leaves):
        raise ValueError(f"{len(us)} uniform pairs for {len(leaves)} leaves")
    out = [quantized_psum(leaf, bits=bits, generator=generator,
                          **({} if us is None else {"u1": us[i][0], "u2": us[i][1]}))
           for i, leaf in enumerate(leaves)]
    return _rebuild(grads, iter(out))
