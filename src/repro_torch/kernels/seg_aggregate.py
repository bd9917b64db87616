"""Blocked-ELL neighbour aggregation: the hand-written CUDA kernel and its layout.

Counterpart of ``repro/kernels/seg_aggregate.py``. There the TPU runs a
Pallas kernel per degree bucket and XLA scatters each bucket's rows into
the output (``out.at[b.rows].add``). Here ``csrc/seg_aggregate.cu`` does
both in one launch per bucket: it sums ``w[r, k] * x[idx[r, k]]`` over k
in a fixed order in fp32 and stores the row straight into ``out[rows[r]]``
(see the source's header for the design and what bounds it).

Because the kernel *stores* rather than adds, each bucket carries its
count of real rows (:class:`DeviceEllBucket` ``n``): the layouts pad
buckets with rows that point at row 0 with zero weights, and a store of
such a row would overwrite row 0. The grid covers the real rows only.

Dispatch is by device: a CUDA tensor goes to the kernel (or the wrapper
raises), a CPU tensor to the plain version (``ref.seg_aggregate_ref`` and
``index_add_``, the counterpart of ``.at[].add``). Nothing falls back.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel. The backward (an aggregation over the reverse
layout ``ell_t``) arrives with the training slice.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref

launches = 0   # kernel launches since the last reset (set to 0 to reset)


class DeviceEllBucket(NamedTuple):
    """One degree bucket on the device."""

    rows: torch.Tensor  # [Rb] int32 destination rows (0 on padding)
    idx: torch.Tensor   # [Rb, K] int32 source rows (0 on padding)
    w: torch.Tensor     # [Rb, K] f32 edge weights (0 on padding)
    n: int              # real rows: rows[n:] are padding


class DeviceBucketedEll(NamedTuple):
    """Device form of ``graph.structure.BucketedEll``."""

    buckets: Tuple[DeviceEllBucket, ...]


def _real_rows(rows: np.ndarray, w: np.ndarray) -> int:
    """Rows before the trailing padding (rows == 0 and all weights 0).

    The layouts append their padding after the real rows. A real row that
    also looks like padding can only be the first row (rows are ascending),
    and storing it would store the zero that ``out`` already holds.
    """
    live = (rows != 0) | np.any(w != 0, axis=-1)
    nz = np.flatnonzero(live)
    return int(nz[-1]) + 1 if nz.size else 0


def device_bucketed(stacked: Sequence, device="cuda") -> DeviceBucketedEll:
    """Lift one graph's ``graph.structure.stack_bucketed_ells`` output to
    ``device``, casting the int64 ids to int32 once here.

    The port's counterpart of ``device_bucketed(stacked, squeeze=True)``;
    the stacked worker axis arrives with the training slice.
    """
    buckets = []
    for _, rows, idx, w in stacked:
        if rows.shape[0] != 1:
            raise ValueError(f"device_bucketed: expected one graph, got a "
                             f"stack of {rows.shape[0]}")
        rows, idx, w = rows[0], idx[0], w[0]
        buckets.append(DeviceEllBucket(
            rows=torch.as_tensor(rows.astype(np.int32), device=device),
            idx=torch.as_tensor(idx.astype(np.int32), device=device),
            w=torch.as_tensor(np.asarray(w, np.float32), device=device),
            n=_real_rows(rows, w)))
    return DeviceBucketedEll(tuple(buckets))


def _check(x, idx, w, rows=None):
    tensors = {"x": (x, torch.float32), "idx": (idx, torch.int32),
               "w": (w, torch.float32)}
    if rows is not None:
        tensors["rows"] = (rows, torch.int32)
    for name, (t, dtype) in tensors.items():
        if t.device != x.device:
            raise ValueError(f"seg_aggregate: {name} on {t.device}, x on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"seg_aggregate: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"seg_aggregate: {name} must be contiguous")
    if x.dim() != 2 or idx.dim() != 2 or idx.shape != w.shape:
        raise ValueError(f"seg_aggregate: shapes x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}, w {tuple(w.shape)}")
    if rows is not None and rows.shape != idx.shape[:1]:
        raise ValueError(f"seg_aggregate: rows {tuple(rows.shape)} for "
                         f"idx {tuple(idx.shape)}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/seg_aggregate.cu``, built on first use."""
    from repro_torch.kernels.build import load

    fn = load("seg_aggregate").seg_aggregate_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, idx, w, rows, out, n_rows: int) -> None:
    """One kernel launch over ``n_rows`` rows on the current stream."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"seg_aggregate kernel needs CUDA tensors, got {x.device}")
    fn = _kernel()
    k, f = idx.shape[1], x.shape[1]
    if max(x.numel(), idx.numel(), out.numel()) >= 2**31 or n_rows > idx.shape[0]:
        raise ValueError("seg_aggregate: sizes beyond the kernel's int32 range")
    err = fn(x.data_ptr(), idx.data_ptr(), w.data_ptr(),
             rows.data_ptr() if rows is not None else None, out.data_ptr(),
             n_rows, k, f, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"seg_aggregate kernel launch failed: CUDA error {err}")
    launches += 1


def seg_aggregate(x: torch.Tensor, ell_idx: torch.Tensor,
                  ell_w: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_k ell_w[r,k] * x[ell_idx[r,k]]: the kernel on CUDA
    tensors, ``ref.seg_aggregate_ref`` on CPU tensors."""
    _check(x, ell_idx, ell_w)
    if x.device.type == "cpu":
        return ref.seg_aggregate_ref(x, ell_idx, ell_w)
    out = torch.empty((ell_idx.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    if ell_idx.shape[0] and ell_idx.shape[1] and x.shape[1]:
        _launch(x, ell_idx, ell_w, None, out, ell_idx.shape[0])
    else:
        out.zero_()
    return out


def bucketed_forward_ref(x: torch.Tensor, ell: DeviceBucketedEll,
                         out_rows: int) -> torch.Tensor:
    """The plain bucketed forward: ``index_add_`` of each bucket's real
    rows, as ``out.at[b.rows].add`` in the JAX package."""
    out = torch.zeros((out_rows, x.shape[-1]), dtype=x.dtype, device=x.device)
    for b in ell.buckets:
        if b.n:
            out.index_add_(0, b.rows[:b.n].long(),
                           ref.seg_aggregate_ref(x, b.idx[:b.n], b.w[:b.n]))
    return out


def bucketed_aggregate(x: torch.Tensor, ell: DeviceBucketedEll,
                       out_rows: Optional[int] = None) -> torch.Tensor:
    """Degree-bucketed blocked-ELL aggregation, forward only.

    CUDA tensors: one kernel launch per bucket with real rows, each storing
    its rows into ``out`` (zero-degree rows keep the zeros ``out`` starts
    with). CPU tensors: :func:`bucketed_forward_ref`.
    """
    rows = int(x.shape[0] if out_rows is None else out_rows)
    if x.device.type == "cpu":
        return bucketed_forward_ref(x, ell, rows)
    out = torch.zeros((rows, x.shape[-1]), dtype=x.dtype, device=x.device)
    for b in ell.buckets:
        _check(x, b.idx, b.w, b.rows)
        if b.n and x.shape[1]:
            _launch(x, b.idx, b.w, b.rows, out, b.n)
    return out
