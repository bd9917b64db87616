"""Blocked-ELL neighbour aggregation: the hand-written CUDA kernel and its layout.

Counterpart of ``repro/kernels/seg_aggregate.py``. There the TPU runs a
Pallas kernel per degree bucket and XLA scatters each bucket's rows into
the output (``out.at[b.rows].add``). Here ``csrc/seg_aggregate.cu`` does
all buckets of a layout in one launch: it sums ``w[r, k] * x[idx[r, k]]``
over k in a fixed order in fp32 and stores each row straight into
``out[rows[r]]`` (see the source's header for the design and what bounds
it).

A layout is one graph (``[Rb]`` rows, ``[Rb, K]`` slots) or a stack of P
workers' graphs (``[P, Rb]``, ``[P, Rb, K]``, the form
``stack_bucketed_ells`` pads to common shapes).

Because the kernel *stores* rather than adds, each bucket carries its count
of real rows: the layouts pad buckets with rows that point at row 0 with
zero weights, and a store of such a row would overwrite row 0.
:class:`DeviceEllBucket` ``n`` is the most real rows of any worker and, for
a stack, ``counts`` each worker's own (the kernel skips ``r >= counts[p]``).

The bucket table of a layout, and the launch table of each width it
meets, are built on first use and cached on the
:class:`DeviceBucketedEll` (:func:`launch_table`).

:func:`bucketed_aggregate` is differentiable when given the reverse-graph
layout ``ell_t``: aggregation is linear, ``out = A @ x``, so its gradient
``A^T @ g`` is the same kernel over ``ell_t`` (``_bucketed_aggregate_bwd``
in the JAX package).

Dispatch is by device: a CUDA tensor goes to the kernel (or the wrapper
raises), a CPU tensor to the plain version (``ref.seg_aggregate_ref`` and
``index_add_``, the counterpart of ``.at[].add``). Nothing falls back.
``launches`` and ``backward_launches`` count kernel launches in the forward
and in the backward (one per aggregation call with real rows), so a run
can show that its main path went through the kernel. Both wrappers are
``traffic.kernel_io``: a byte count sees each call as one op on either
device.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.traffic import kernel_io

launches = 0            # forward kernel launches since the last reset
backward_launches = 0   # backward (reverse-layout) launches since the last reset

MAX_BUCKETS = 16        # buckets one launch takes (csrc kMaxBuckets)
GATHER_THREADS = 256    # threads per block (csrc kGatherThreads)


class DeviceEllBucket(NamedTuple):
    """One degree bucket on the device, of one graph or a stack of P."""

    rows: torch.Tensor  # [Rb] or [P, Rb] int32 destination rows (0 on padding)
    idx: torch.Tensor   # [Rb, K] or [P, Rb, K] int32 source rows (0 on padding)
    w: torch.Tensor     # [Rb, K] or [P, Rb, K] f32 edge weights (0 on padding)
    n: int              # real rows (most over the workers): rows[..., n:] are padding
    counts: Optional[torch.Tensor] = None  # [P] int32 real rows per worker (stacks)


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceBucketedEll:
    """Device form of ``graph.structure.BucketedEll``. The kernel's tables
    are cached in ``_tables`` (the layout's tensors are constants)."""

    buckets: Tuple[DeviceEllBucket, ...]
    _tables: dict = dataclasses.field(default_factory=dict, init=False,
                                      repr=False, compare=False)


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


def _check_tensor(name: str, t: torch.Tensor, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"seg_aggregate: {name} on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"seg_aggregate: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"seg_aggregate: {name} must be contiguous")


def _check(x, idx, w):
    for name, t, dtype in (("x", x, torch.float32), ("idx", idx, torch.int32),
                           ("w", w, torch.float32)):
        _check_tensor(name, t, dtype, x.device)
    lead = x.dim() - 2
    if lead not in (0, 1) or idx.dim() != 2 + lead or idx.shape != w.shape \
            or idx.shape[:lead] != x.shape[:lead]:
        raise ValueError(f"seg_aggregate: shapes x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}, w {tuple(w.shape)}")


# -- the kernel's tables ---------------------------------------------------------


class BucketTable(NamedTuple):
    """The buckets with real rows, as one launch takes them (validated)."""

    device: torch.device
    workers: int                    # P; 1 for one graph
    stacked: bool
    buckets: Tuple[DeviceEllBucket, ...]
    ptrs: ctypes.Array              # 4 addresses per bucket: idx, w, rows, counts


class LaunchTable(NamedTuple):
    """One launch's shape for a layout and a width."""

    lanes: int                      # threads per row, 4 features each
    rows_per_tile: int              # rows per block
    tile_start: Tuple[int, ...]     # each bucket's first tile
    tiles: int                      # blocks along x
    dims: ctypes.Array              # 4 ints per bucket: k, bucket_rows, n, tile_start


def gather_tiles(ns: Sequence[int], workers: int, f: int):
    """The kernel's tiling: ``(lanes, rows_per_tile, tile_start, tiles)``.

    A thread covers 4 features, ``lanes`` threads a row (``ceil(F / 4)``,
    at most a block), a block ``rows_per_tile`` rows of one bucket of one
    worker; bucket i's tiles start at ``tile_start[i]``, worker-major, with
    ``ceil(n_i / rows_per_tile)`` tiles per worker (the kernel drops the
    rows of a tile at or past ``counts[p]``).
    """
    lanes = min(-(-f // 4), GATHER_THREADS)
    rows_per_tile = GATHER_THREADS // lanes
    start, tiles = [], 0
    for n in ns:
        start.append(tiles)
        tiles += -(-n // rows_per_tile) * workers
    return lanes, rows_per_tile, tuple(start), tiles


def _bucket_table(ell: DeviceBucketedEll) -> BucketTable:
    """The layout's buckets with real rows, validated once and cached."""
    table = ell._tables.get("buckets")
    if table is not None:
        return table
    live = tuple(b for b in ell.buckets if b.n)
    if len(live) > MAX_BUCKETS:
        raise ValueError(f"seg_aggregate: {len(live)} buckets with real rows; "
                         f"one launch takes at most {MAX_BUCKETS}")
    stacked = any(b.counts is not None for b in ell.buckets)
    device = ell.buckets[0].idx.device if ell.buckets else None
    workers = ell.buckets[0].idx.shape[0] if stacked else 1
    for b in ell.buckets:
        if (b.counts is not None) != stacked:
            raise ValueError("seg_aggregate: a layout mixes stacked and one-graph buckets")
        lead = 1 if stacked else 0
        for name, t, dtype in (("idx", b.idx, torch.int32), ("w", b.w, torch.float32),
                               ("rows", b.rows, torch.int32)):
            _check_tensor(name, t, dtype, device)
        if b.idx.dim() != 2 + lead or b.w.shape != b.idx.shape \
                or b.rows.shape != b.idx.shape[:-1] \
                or (stacked and b.idx.shape[0] != workers) \
                or not 0 <= b.n <= b.idx.shape[-2] or b.idx.shape[-1] < 1:
            raise ValueError(f"seg_aggregate: bucket shapes idx {tuple(b.idx.shape)}, "
                             f"w {tuple(b.w.shape)}, rows {tuple(b.rows.shape)}, n {b.n}")
        if stacked:
            _check_tensor("counts", b.counts, torch.int32, device)
            if b.counts.shape != (workers,):
                raise ValueError(f"seg_aggregate: counts {tuple(b.counts.shape)} "
                                 f"for {workers} workers")
    ptrs = (ctypes.c_longlong * (4 * len(live)))(*[
        t.data_ptr() if t is not None else 0
        for b in live for t in (b.idx, b.w, b.rows, b.counts)])
    table = BucketTable(device, workers, stacked, live, ptrs)
    ell._tables["buckets"] = table
    return table


def _dims(buckets: Sequence[DeviceEllBucket], tile_start: Sequence[int]) -> ctypes.Array:
    return (ctypes.c_int * (4 * len(buckets)))(*[
        v for b, t in zip(buckets, tile_start)
        for v in (b.idx.shape[-1], b.idx.shape[-2], b.n, t)])


def _launch_table(buckets: BucketTable, f: int) -> LaunchTable:
    lanes, rows_per_tile, start, tiles = gather_tiles(
        [b.n for b in buckets.buckets], buckets.workers, f)
    if tiles >= 2**31:
        raise ValueError("seg_aggregate: more tiles than a grid holds")
    return LaunchTable(lanes, rows_per_tile, start, tiles, _dims(buckets.buckets, start))


def launch_table(ell: DeviceBucketedEll, f: int) -> LaunchTable:
    """The launch of ``ell`` over rows ``f`` features wide; built once per
    width and cached on ``ell``."""
    table = ell._tables.get(f)
    if table is None:
        table = _launch_table(_bucket_table(ell), f)
        ell._tables[f] = table
    return table


# -- the launch --------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library():
    """``csrc/seg_aggregate.cu``'s library with its C signatures, built on
    first use."""
    from repro_torch.kernels.build import load

    lib = load("seg_aggregate")
    lib.seg_aggregate_f32.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 2
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.seg_aggregate_f32.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, out: torch.Tensor, buckets: BucketTable,
            table: LaunchTable) -> None:
    """One launch over every bucket of the table, on the current stream."""
    f = x.shape[-1]
    vec = f % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    err = _library().seg_aggregate_f32(
        x.data_ptr(), out.data_ptr(), ctypes.addressof(buckets.ptrs),
        ctypes.addressof(table.dims), len(buckets.buckets), buckets.workers, f,
        x.numel() // buckets.workers, out.numel() // buckets.workers, table.lanes,
        table.rows_per_tile, table.tiles, int(vec),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"seg_aggregate kernel launch failed: CUDA error {err}")


@kernel_io
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
    r, k = ell_idx.shape
    out = torch.empty((r, x.shape[1]), dtype=x.dtype, device=x.device)
    if not (r and k and x.shape[1] and x.shape[0]):
        return out.zero_()
    bucket = DeviceEllBucket(rows=None, idx=ell_idx, w=ell_w, n=r)
    ptrs = (ctypes.c_longlong * 4)(ell_idx.data_ptr(), ell_w.data_ptr(), 0, 0)
    lanes, rows_per_tile, start, tiles = gather_tiles([r], 1, x.shape[1])
    table = LaunchTable(lanes, rows_per_tile, start, tiles, _dims([bucket], start))
    _launch(x, out, BucketTable(x.device, 1, False, (bucket,), ptrs), table)
    launches += 1
    return out


def flat_rows(t: torch.Tensor, per_worker: int) -> torch.Tensor:
    """Row ids of a stack ``[P, ...]`` as ids into the ``[P * per_worker]``
    rows of the flattened stack."""
    off = torch.arange(t.shape[0], device=t.device) * per_worker
    return t.long() + off.view(-1, *([1] * (t.dim() - 1)))


def add_rows(base: torch.Tensor, rows: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``base`` with ``vals`` added into its rows ``rows`` (out of place).

    The sum of each row is taken in a fixed order on every device, so a
    run repeats bit for bit: ``index_add`` adds in index order on the CPU,
    but with atomics on the card, where ``index_put`` with
    ``accumulate=True`` sorts the indices (stably) and then adds each
    row's values in that order."""
    if base.device.type == "cpu":
        return base.index_add(0, rows, vals)
    return base.index_put((rows,), vals, accumulate=True)


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


@kernel_io
def _bucketed_forward(x: torch.Tensor, ell: DeviceBucketedEll, out_rows: int,
                      backward: bool = False) -> torch.Tensor:
    """CUDA tensors: one kernel launch over every bucket with real rows (all
    workers of a stack), storing each real row into ``out`` (zero-degree
    rows keep the zeros ``out`` starts with). CPU tensors:
    :func:`bucketed_forward_ref`."""
    global launches, backward_launches
    if x.device.type == "cpu":
        return bucketed_forward_ref(x, ell, out_rows)
    x = x.contiguous()
    out = torch.zeros((*x.shape[:-2], out_rows, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    if not ell.buckets:
        return out
    buckets = _bucket_table(ell)
    _check_tensor("x", x, torch.float32, buckets.device)
    if x.dim() != 2 + buckets.stacked or (buckets.stacked and x.shape[0] != buckets.workers):
        raise ValueError(f"seg_aggregate: x {tuple(x.shape)} for a "
                         + (f"stack of {buckets.workers} graphs (device_bucketed(..., "
                            f"squeeze=False))" if buckets.stacked else "one graph"))
    if buckets.buckets and x.shape[-1] and x.shape[-2]:
        _launch(x, out, buckets, launch_table(ell, x.shape[-1]))
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
