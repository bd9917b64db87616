"""Fixed-shape device layouts for the serving path (counterpart of
``repro/kernels/ops.py``; the quantization wrappers arrive with the
training slice)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.seg_aggregate import DeviceBucketedEll, DeviceEllBucket


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
