"""Plain PyTorch versions of the kernels (counterpart of ``repro.kernels.ref``).

They define what the hand-written kernels compute. The wrappers use them
for tensors on the CPU; the tests and ``chip_smoke.py`` hold the kernels to
them on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.quant.stochastic import (QuantParams, dequantize_packed, pack_bits,
                                          quantize)


def seg_aggregate_ref(
    x: torch.Tensor,      # [N, F] source features
    ell_idx: torch.Tensor,  # [R, K] integer source ids per dst-row slot
    ell_w: torch.Tensor,    # [R, K] f32 edge weights (0 = padding)
) -> torch.Tensor:
    """out[r] = sum_k ell_w[r, k] * x[ell_idx[r, k]] — the paper's index_add/SpMM."""
    return (ell_w.to(x.dtype)[..., None] * x[ell_idx.long()]).sum(1)


def quant_pack_ref(
    x: torch.Tensor,        # [R, F] fp32, R % row_group == 0
    noise: torch.Tensor,    # [R, F] uniform [0,1) stochastic-rounding noise
    bits: int,
    row_group: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused per-row-group minmax + stochastic quantize + bit-pack.

    Returns (packed int32 [R, ceil(F*bits/32)], zero [R/row_group], scale
    [R/row_group]): ``quantize`` then ``pack_bits``, so the scale is divided
    (C-ref2) and F may be ragged (a row's last word carries zeros in the
    fields past F). The JAX oracle multiplies by 0 for an empty range where
    ``quantize`` multiplies by 1; both give 0, since x - lo is 0 there.
    """
    q, params = quantize(x, bits, noise, row_group)
    return pack_bits(q, bits), params.zero, params.scale


def dequant_unpack_ref(
    packed: torch.Tensor,   # [R, ceil(F*bits/32)] int32
    zero: torch.Tensor,     # [R/row_group]
    scale: torch.Tensor,    # [R/row_group]
    bits: int,
    feat: int,
    row_group: int = 4,
) -> torch.Tensor:
    return dequantize_packed(packed, QuantParams(zero, scale), bits, feat, row_group)
