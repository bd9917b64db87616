"""Blocked-ELL neighbour aggregation: the hand-written CUDA kernel and its layout.

Counterpart of ``repro/kernels/seg_aggregate.py``. There the TPU runs a
Pallas kernel per degree bucket and XLA scatters each bucket's rows into
the output (``out.at[b.rows].add``). Here ``csrc/seg_aggregate.cu`` does
both in one launch per bucket: it sums ``w[r, k] * x[idx[r, k]]`` over k
in a fixed order in fp32 and stores the row straight into ``out[rows[r]]``
(see the source's header for the design and what bounds it).

A layout is one graph (``[Rb]`` rows, ``[Rb, K]`` slots) or a stack of P
workers' graphs (``[P, Rb]``, ``[P, Rb, K]``, the form
``stack_bucketed_ells`` pads to common shapes); the kernel covers all P
workers of a bucket in one launch (``blockIdx.z``).

Because the kernel *stores* rather than adds, each bucket carries its count
of real rows: the layouts pad buckets with rows that point at row 0 with
zero weights, and a store of such a row would overwrite row 0.
:class:`DeviceEllBucket` ``n`` is the most real rows of any worker (the
grid's extent) and, for a stack, ``counts`` each worker's own (the kernel
skips ``r >= counts[p]``).

:func:`bucketed_aggregate` is differentiable when given the reverse-graph
layout ``ell_t``: aggregation is linear, ``out = A @ x``, so its gradient
``A^T @ g`` is the same kernel over ``ell_t`` (``_bucketed_aggregate_bwd``
in the JAX package).

Dispatch is by device: a CUDA tensor goes to the kernel (or the wrapper
raises), a CPU tensor to the plain version (``ref.seg_aggregate_ref`` and
``index_add_``, the counterpart of ``.at[].add``). Nothing falls back.
``launches`` and ``backward_launches`` count kernel launches in the forward
and in the backward, so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref

launches = 0            # forward kernel launches since the last reset
backward_launches = 0   # backward (reverse-layout) launches since the last reset


class DeviceEllBucket(NamedTuple):
    """One degree bucket on the device, of one graph or a stack of P."""

    rows: torch.Tensor  # [Rb] or [P, Rb] int32 destination rows (0 on padding)
    idx: torch.Tensor   # [Rb, K] or [P, Rb, K] int32 source rows (0 on padding)
    w: torch.Tensor     # [Rb, K] or [P, Rb, K] f32 edge weights (0 on padding)
    n: int              # real rows (most over the workers): rows[..., n:] are padding
    counts: Optional[torch.Tensor] = None  # [P] int32 real rows per worker (stacks)


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


def device_bucketed(stacked: Sequence, device="cuda",
                    squeeze: bool = True) -> DeviceBucketedEll:
    """Lift ``graph.structure.stack_bucketed_ells`` output to ``device``,
    casting the int64 ids to int32 once here.

    ``squeeze=True`` expects one graph and drops the worker axis (the JAX
    package's ``squeeze=True``); ``squeeze=False`` keeps the ``[P, ...]``
    stack and records each worker's real rows.
    """
    buckets = []
    for _, rows, idx, w in stacked:
        if squeeze and rows.shape[0] != 1:
            raise ValueError(f"device_bucketed: expected one graph, got a "
                             f"stack of {rows.shape[0]} (pass squeeze=False)")
        counts = [_real_rows(rows[p], w[p]) for p in range(rows.shape[0])]
        lift = dict(
            rows=torch.as_tensor(rows.astype(np.int32), device=device),
            idx=torch.as_tensor(idx.astype(np.int32), device=device),
            w=torch.as_tensor(np.asarray(w, np.float32), device=device),
            n=max(counts, default=0))
        if squeeze:
            buckets.append(DeviceEllBucket(**{k: v[0] if torch.is_tensor(v) else v
                                              for k, v in lift.items()}))
        else:
            buckets.append(DeviceEllBucket(
                **lift, counts=torch.tensor(counts, dtype=torch.int32, device=device)))
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
    lead = x.dim() - 2
    if lead not in (0, 1) or idx.dim() != 2 + lead or idx.shape != w.shape \
            or idx.shape[:lead] != x.shape[:lead]:
        raise ValueError(f"seg_aggregate: shapes x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}, w {tuple(w.shape)}")
    if rows is not None and rows.shape != idx.shape[:-1]:
        raise ValueError(f"seg_aggregate: rows {tuple(rows.shape)} for "
                         f"idx {tuple(idx.shape)}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of ``csrc/seg_aggregate.cu``, built on first use."""
    from repro_torch.kernels.build import load

    fn = load("seg_aggregate").seg_aggregate_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(x, idx, w, rows, counts, out, n_rows: int) -> None:
    """One kernel launch over ``n_rows`` rows of every worker, on the
    current stream. ``x`` [P, N, F] / ``out`` [P, M, F] for a stack of P
    (``counts`` [P] real rows each), else [N, F] / [M, F]."""
    if x.device.type != "cuda":
        raise ValueError(f"seg_aggregate kernel needs CUDA tensors, got {x.device}")
    fn = _kernel()
    workers = x.shape[0] if x.dim() == 3 else 1
    bucket_rows, k = idx.shape[-2], idx.shape[-1]
    f = x.shape[-1]
    if (max(x.numel(), idx.numel(), out.numel()) >= 2**31 or n_rows > bucket_rows
            or workers > 65535):
        raise ValueError("seg_aggregate: sizes beyond the kernel's int32 range")
    err = fn(x.data_ptr(), idx.data_ptr(), w.data_ptr(),
             rows.data_ptr() if rows is not None else None,
             counts.data_ptr() if counts is not None else None, out.data_ptr(),
             workers, n_rows, bucket_rows, k, f,
             x.numel() // workers, out.numel() // workers,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"seg_aggregate kernel launch failed: CUDA error {err}")


def seg_aggregate(x: torch.Tensor, ell_idx: torch.Tensor,
                  ell_w: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_k ell_w[r,k] * x[ell_idx[r,k]]: the kernel on CUDA
    tensors, ``ref.seg_aggregate_ref`` on CPU tensors."""
    global launches
    _check(x, ell_idx, ell_w)
    if x.dim() != 2:
        raise ValueError("seg_aggregate: one graph (x [N, F]) only")
    if x.device.type == "cpu":
        return ref.seg_aggregate_ref(x, ell_idx, ell_w)
    out = torch.empty((ell_idx.shape[0], x.shape[1]), dtype=x.dtype,
                      device=x.device)
    if ell_idx.shape[0] and ell_idx.shape[1] and x.shape[1]:
        _launch(x, ell_idx, ell_w, None, None, out, ell_idx.shape[0])
        launches += 1
    else:
        out.zero_()
    return out


def flat_rows(t: torch.Tensor, per_worker: int) -> torch.Tensor:
    """Row ids of a stack ``[P, ...]`` as ids into the ``[P * per_worker]``
    rows of the flattened stack."""
    off = torch.arange(t.shape[0], device=t.device) * per_worker
    return t.long() + off.view(-1, *([1] * (t.dim() - 1)))


def bucketed_forward_ref(x: torch.Tensor, ell: DeviceBucketedEll,
                         out_rows: int) -> torch.Tensor:
    """The plain bucketed forward: ``index_add_`` of each bucket's rows up
    to ``n``, as ``out.at[b.rows].add`` in the JAX package (a stack's
    padding rows within ``n`` add exact zeros into row 0, as there)."""
    f = x.shape[-1]
    if x.dim() == 2:
        out = torch.zeros((out_rows, f), dtype=x.dtype, device=x.device)
        for b in ell.buckets:
            if b.n:
                out.index_add_(0, b.rows[:b.n].long(),
                               ref.seg_aggregate_ref(x, b.idx[:b.n], b.w[:b.n]))
        return out
    p, n_src = x.shape[0], x.shape[1]
    out = torch.zeros((p * out_rows, f), dtype=x.dtype, device=x.device)
    xf = x.reshape(p * n_src, f)
    for b in ell.buckets:
        if b.n:
            k = b.idx.shape[-1]
            vals = ref.seg_aggregate_ref(
                xf, flat_rows(b.idx[:, :b.n], n_src).reshape(-1, k),
                b.w[:, :b.n].reshape(-1, k))
            out.index_add_(0, flat_rows(b.rows[:, :b.n], out_rows).reshape(-1),
                           vals.reshape(-1, f))
    return out.reshape(p, out_rows, f)


def _bucketed_forward(x: torch.Tensor, ell: DeviceBucketedEll, out_rows: int,
                      backward: bool = False) -> torch.Tensor:
    """CUDA tensors: one kernel launch per bucket with real rows (all
    workers of a stack at once), each storing its rows into ``out``
    (zero-degree rows keep the zeros ``out`` starts with). CPU tensors:
    :func:`bucketed_forward_ref`."""
    global launches, backward_launches
    if x.device.type == "cpu":
        return bucketed_forward_ref(x, ell, out_rows)
    x = x.contiguous()
    out = torch.zeros((*x.shape[:-2], out_rows, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    for b in ell.buckets:
        _check(x, b.idx, b.w, b.rows)
        if x.dim() == 3 and b.counts is None:
            raise ValueError("seg_aggregate: a stacked x needs a stacked layout "
                             "(device_bucketed(..., squeeze=False))")
        if b.n and x.shape[-1]:
            _launch(x, b.idx, b.w, b.rows, b.counts, out, b.n)
            if backward:
                backward_launches += 1
            else:
                launches += 1
    return out


class _BucketedAggregate(torch.autograd.Function):
    """out = A @ x over the forward layout; its gradient A^T @ g is the
    same aggregation over the reverse-graph layout (the layouts are
    preprocessing constants and get no gradient)."""

    @staticmethod
    def forward(ctx, x, ell, ell_t, out_rows):
        ctx.ell_t = ell_t
        ctx.in_rows = x.shape[-2]
        return _bucketed_forward(x, ell, out_rows)

    @staticmethod
    def backward(ctx, g):
        return (_bucketed_forward(g, ctx.ell_t, ctx.in_rows, backward=True),
                None, None, None)


def bucketed_aggregate(x: torch.Tensor, ell: DeviceBucketedEll,
                       out_rows: Optional[int] = None, *,
                       ell_t: Optional[DeviceBucketedEll] = None) -> torch.Tensor:
    """Degree-bucketed blocked-ELL aggregation of ``x`` ([N, F], or [P, N, F]
    over a stacked layout) into ``out_rows`` rows (default N).

    With ``ell_t``, the reverse-graph layout, the result is differentiable
    in ``x`` and the backward runs the same kernel over ``ell_t``; without
    it, the aggregation is forward only, and an ``x`` that needs a gradient
    is refused on every device (the kernel's output has no ``grad_fn``, so
    the gradient would be lost on the card alone).
    """
    rows = int(x.shape[-2] if out_rows is None else out_rows)
    if ell_t is None:
        if x.requires_grad and torch.is_grad_enabled():
            raise ValueError("bucketed_aggregate: x requires grad; pass the "
                             "reverse layout ell_t to differentiate")
        return _bucketed_forward(x, ell, rows)
    return _BucketedAggregate.apply(x, ell, ell_t, rows)
