"""Public wrappers around the hand-written kernels (counterpart of
``repro/kernels/ops.py``), and the fixed-shape device layouts of the
serving path (``padded_device_bucketed``).

The JAX package's wrappers switch to their jnp oracles on shapes its
Pallas kernels cannot take (F not a multiple of 128, rows not a multiple
of 8). The port's kernels take ragged shapes, so these wrappers never
switch: a CUDA tensor goes to the kernel (or the wrapper raises), a CPU
tensor to the plain version, as every wrapper of the port does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.quant_pack import dequant_unpack, quant_pack
from repro_torch.kernels.seg_aggregate import (DeviceBucketedEll, DeviceEllBucket,
                                               seg_aggregate)


def aggregate(x: torch.Tensor, ell_idx: torch.Tensor, ell_w: torch.Tensor
              ) -> torch.Tensor:
    """``out[r] = sum_k ell_w[r, k] * x[ell_idx[r, k]]`` over a dense
    max-degree ELL (``graph.structure.ell_from_csr``): one launch of the
    ``seg_aggregate`` kernel on CUDA tensors, the plain version on CPU
    tensors. Forward only, as the Pallas call it replaces: an ``x`` that
    needs a gradient is refused on every device (the kernel's output has
    no ``grad_fn``, so the gradient would be lost on the card alone)."""
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("aggregate: x requires grad; the dense-ELL aggregation "
                         "is forward only (use kernels.bucketed_aggregate with "
                         "the reverse layout to differentiate)")
    return seg_aggregate(x.contiguous(), ell_idx.to(torch.int32).contiguous(),
                         ell_w.to(torch.float32).contiguous())


def quantize_pack(x: torch.Tensor, noise: torch.Tensor, *, bits: int = 2
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(packed, zero, scale) of ``x`` [R, F] (``kernels.quant_pack``). R
    must be a multiple of 4, as the JAX package's oracle needs for its
    row-group reshape; any F is taken."""
    return quant_pack(x, noise, bits)


def dequantize_unpack(packed: torch.Tensor, zero: torch.Tensor, scale: torch.Tensor,
                      *, bits: int = 2, feat: int) -> torch.Tensor:
    """The inverse of :func:`quantize_pack` (``kernels.dequant_unpack``)."""
    return dequant_unpack(packed, zero, scale, bits, feat)


def padded_device_bucketed(ell, bucket_caps: Sequence[Tuple[int, int]],
                           device="cuda") -> DeviceBucketedEll:
    """Materialize a host ``BucketedEll`` at *fixed* per-bucket shapes.

    ``bucket_caps`` is ``[(k, row_capacity), ...]`` — the full degree
    ladder, every entry present even when the layout has no rows at that
    K, each padded (with rows=0, idx=0, w=0) to its capacity, exactly as
    the JAX package pads a shape class. Each bucket records its real row
    count ``n``; the kernel runs over those rows only and skips empty
    buckets, so the padding costs no work on the card. The padding is
    zero-filled on the device and only the real rows are copied from the
    host.
    """
    by_k = {b.k: b for b in ell.buckets}
    unknown = sorted(set(by_k) - {k for k, _ in bucket_caps})
    if unknown:
        raise ValueError(
            f"padded_device_bucketed: layout has bucket K={unknown} absent "
            f"from bucket_caps {sorted(k for k, _ in bucket_caps)} — edges "
            "would be dropped")
    buckets = []
    for k, cap in bucket_caps:
        rows = torch.zeros(cap, dtype=torch.int32, device=device)
        idx = torch.zeros((cap, k), dtype=torch.int32, device=device)
        w = torch.zeros((cap, k), dtype=torch.float32, device=device)
        b = by_k.get(k)
        n = 0
        if b is not None:
            n = b.rows.shape[0]
            if n > cap:
                raise ValueError(
                    f"padded_device_bucketed: bucket K={k} holds {n} rows "
                    f"> capacity {cap} — pick a larger shape class")
            rows[:n] = torch.from_numpy(b.rows.astype(np.int32))
            idx[:n] = torch.from_numpy(b.idx.astype(np.int32))
            w[:n] = torch.from_numpy(b.w.astype(np.float32))
        buckets.append(DeviceEllBucket(rows=rows, idx=idx, w=w, n=n))
    return DeviceBucketedEll(tuple(buckets))
