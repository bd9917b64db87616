"""Stochastic integer quantization (paper §2.4, §6, §7.3) in PyTorch.

Counterpart of ``repro/quant/stochastic.py``, with one difference: the
stochastic-rounding uniforms are an argument, ``u`` (shape ``[R/4, 4, F]``,
the shape ``jax.random.uniform`` draws there, or anything of ``R*F``
elements in that order), because torch cannot replay JAX's threefry. Given
the same uniforms, :func:`quantize` computes what the JAX package computes,
op for op:

``h_quant = clip(floor((h - Z) * (1 / S) + u), 0, 2^b - 1)``,
``h_dequant = h_quant * S + Z`` with ``Z = min(h)``,
``S = (max(h) - min(h)) / (2^b - 1)`` per 4-row group.

``S`` is a true division, as in the JAX package's training path (ROADMAP
C-ref2). Every division here is tensor by tensor: on CUDA, PyTorch divides
by a host scalar as a multiply by its reciprocal, which can differ in the
last bit.

:func:`pack_bits` also takes a feature width that is not a multiple of
``32 // bits``: the last word of a row carries zero upper fields.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

ROW_GROUP = 4  # rows sharing one (zero, scale) pair; matches the fused kernel


class QuantParams(NamedTuple):
    zero: torch.Tensor   # [G] fp32 per row group
    scale: torch.Tensor  # [G] fp32 per row group


def _group_minmax(x: torch.Tensor, row_group: int) -> Tuple[torch.Tensor, torch.Tensor]:
    rows, feat = x.shape
    xg = x.reshape(rows // row_group, row_group * feat)
    return xg.amin(dim=1), xg.amax(dim=1)


def group_scale(lo: torch.Tensor, hi: torch.Tensor, bits: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale as shipped, reciprocal used to quantize) for one bit width:
    ``scale = (hi - lo) / levels`` (0 for an empty range) and ``1 / scale``
    (1 for an empty range, as ``quantize``'s ``safe`` gives)."""
    levels = torch.full_like(lo, float((1 << bits) - 1))
    scale = (hi - lo) / levels
    pos = scale > 0
    safe = torch.where(pos, scale, torch.ones_like(scale))
    rcp = torch.ones_like(safe) / safe
    return torch.where(pos, scale, torch.zeros_like(scale)), rcp


def quantize(
    x: torch.Tensor,
    bits: int,
    u: torch.Tensor,
    row_group: int = ROW_GROUP,
) -> Tuple[torch.Tensor, QuantParams]:
    """Stochastic-round ``x`` [R, F] to unsigned ``bits``-wide ints (int32
    holder) with the uniforms ``u`` in [0, 1). R must be divisible by
    ``row_group``."""
    rows, feat = x.shape
    if rows % row_group:
        raise ValueError(f"rows {rows} not divisible by row_group {row_group}")
    levels = (1 << bits) - 1
    lo, hi = _group_minmax(x, row_group)
    scale, rcp = group_scale(lo, hi, bits)
    g = rows // row_group
    xs = (x.reshape(g, row_group, feat) - lo[:, None, None]) * rcp[:, None, None]
    q = torch.floor(xs + u.reshape(g, row_group, feat))  # unbiased: E[q] = xs
    q = torch.clamp(q, 0, levels).to(torch.int32).reshape(rows, feat)
    return q, QuantParams(zero=lo, scale=scale)


def dequantize(
    q: torch.Tensor, params: QuantParams, row_group: int = ROW_GROUP
) -> torch.Tensor:
    rows, feat = q.shape
    g = rows // row_group
    xq = q.to(torch.float32).reshape(g, row_group, feat)
    x = xq * params.scale[:, None, None] + params.zero[:, None, None]
    return x.reshape(rows, feat)


def words_per_row(feat: int, bits: int) -> int:
    """int32 words a packed row of ``feat`` b-bit fields takes."""
    return -(-feat // (32 // bits))


def pack_bits(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack ``q`` in [0, 2^bits) along the last axis into int32 words,
    ``32 // bits`` fields per word, field j at bits ``[j*bits, (j+1)*bits)``.
    A ragged last word holds zeros in its unused fields."""
    per_word = 32 // bits
    rows, feat = q.shape
    words = words_per_row(feat, bits)
    qp = torch.zeros((rows, words * per_word), dtype=torch.int64, device=q.device)
    qp[:, :feat] = q
    shifts = torch.arange(per_word, dtype=torch.int64, device=q.device) * bits
    packed = (qp.reshape(rows, words, per_word) << shifts).sum(-1)
    # The words are unsigned 32-bit patterns; reinterpret them as int32.
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def unpack_bits(packed: torch.Tensor, bits: int, feat: int) -> torch.Tensor:
    per_word = 32 // bits
    rows = packed.shape[0]
    pw = (packed.to(torch.int64) & 0xFFFFFFFF)[:, :, None]
    shifts = torch.arange(per_word, dtype=torch.int64, device=packed.device) * bits
    q = (pw >> shifts) & ((1 << bits) - 1)
    return q.reshape(rows, -1)[:, :feat].to(torch.int32)


def quantize_packed(
    x: torch.Tensor, bits: int, u: torch.Tensor, row_group: int = ROW_GROUP
) -> Tuple[torch.Tensor, QuantParams]:
    q, params = quantize(x, bits, u, row_group)
    return pack_bits(q, bits), params


def dequantize_packed(
    packed: torch.Tensor, params: QuantParams, bits: int, feat: int,
    row_group: int = ROW_GROUP,
) -> torch.Tensor:
    return dequantize(unpack_bits(packed, bits, feat), params, row_group)


def wire_bytes(rows: int, feat: int, bits: int, row_group: int = ROW_GROUP) -> int:
    """Bytes on the wire: packed payload + fp32 (zero, scale) per row group."""
    payload = rows * feat * bits // 8
    params = (rows // row_group) * 2 * 4
    return payload + params
