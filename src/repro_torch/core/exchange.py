"""Composable halo-exchange schedules on a stacked worker axis, in PyTorch.

Counterpart of ``repro/core/exchange.py`` for the way its
``exec.mode="vmap"`` runs: all P workers sit on a leading axis of every
tensor (``[P, rows, F]``, worker ``p = g * W + w`` for the hierarchical
G x W layout), and each collective is a tensor operation over that axis:

  * all_to_all   — a swap of the source-worker and chunk axes
                   (:func:`_wire_a2a`);
  * psum_scatter — a sum over the W workers of a group, then one shard
                   per worker (:func:`_pre_wire`);
  * all_gather   — every worker of a group receives all W shards
                   (:func:`_post_wire`).

The schedule is the JAX package's: an :class:`ExchangeSchedule` of
:class:`StageSpec` stages (``flat``, or ``intra`` + ``inter``), each with
its wire format (``bits``), caching policy (``cd``) and scheduling
(``overlap``), executed per layer as a two-phase :class:`LayerProgram`
(``issue`` -> local aggregation -> ``finalize``). Here the phases run in
that order on one stream; overlap changes op order only, never values.

The quantized wire is :class:`_QuantizedExchange`, the counterpart of the
JAX package's single custom VJP ``quantized_exchange``: pre-wire ->
``quant_pack`` -> all_to_all of the packed words and the fp32 (zero,
scale) per 4-row group -> ``dequant_unpack``. Its backward re-quantizes
the cotangent with its own uniforms (the JAX package folds ``0x5BD1``
into the key) and fans it out through the post-wire.

Randomness: the stochastic-rounding uniforms are arguments. A layer's
program takes ``noise(stage, backward, shape) -> [P, rows, F]`` uniforms
in [0, 1), drawn by the caller (``core.trainer`` passes its step
randomness).

Delayed stages (``cd > 1``) keep a stale receive buffer per layer. On a
refresh epoch (``epoch % cd == 0``) the wire runs; on a stale one it is
skipped and the detached stale buffer is served. The JAX package's traced
program runs the wire every epoch and selects with ``where``, whose branch
not taken contributes only zeros, so the values are the same. ``epoch`` is
a Python int and the draws are keyed by (epoch, layer, stage), so a
skipped wire shifts no other draw.

The wire itself is a per-stage transport: :class:`StackedWire` here, the
mailbox rounds of ``launch.multiproc`` for one OS process per worker.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.graph import structure as gstruct
from repro_torch.kernels import seg_aggregate as segagg
from repro_torch.kernels.quant_pack import dequant_unpack, quant_pack
from repro_torch.quant.stochastic import ROW_GROUP

WIRE_BITS = (0, 2, 4, 8)  # 0 = fp32
STAGE_LEVELS = ("flat", "intra", "inter")

# noise(stage_index, backward, shape) -> uniforms in [0, 1) of ``shape``
Noise = Callable[[int, bool, Tuple[int, ...]], torch.Tensor]


# --------------------------------------------------------------------------
# Stacked gathers and scatter-adds
# --------------------------------------------------------------------------


def _take(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``h[p][idx[p]]`` for every worker: [P, N, F] x [P, K] -> [P, K, F]."""
    p, n, f = h.shape
    return h.reshape(p * n, f)[segagg.flat_rows(idx, n).reshape(-1)].reshape(p, -1, f)


def _index_add(base: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor
               ) -> torch.Tensor:
    """``base[p].at[idx[p]].add(vals[p])`` for every worker (out of place).

    The sum of each row is taken in a fixed order on every device, so a
    run repeats bit for bit: ``index_add`` adds in index order on the CPU,
    but with atomics on the card, where ``index_put`` with
    ``accumulate=True`` sorts the indices (stably) and then adds each
    row's values in that order."""
    p, n, f = base.shape
    flat, rows = base.reshape(p * n, f), segagg.flat_rows(idx, n).reshape(-1)
    vals = vals.reshape(-1, f)
    if base.device.type == "cpu":
        out = flat.index_add(0, rows, vals)
    else:
        out = flat.index_put((rows,), vals, accumulate=True)
    return out.reshape(p, n, f)


# --------------------------------------------------------------------------
# Device-ready halo plans (stacked over the worker axis)
# --------------------------------------------------------------------------


class DeviceHaloPlan(NamedTuple):
    """graph.remote.HaloPlan on the device; every array has leading dim P."""

    send_gather_idx: torch.Tensor   # [P, C*R] int64 (C chunks of R wire rows)
    send_gather_mask: torch.Tensor  # [P, C*R] bool
    pre_src: torch.Tensor           # [P, pre_nnz] int64
    pre_slot: torch.Tensor          # [P, pre_nnz] int64
    pre_weight: torch.Tensor        # [P, pre_nnz] f32
    recv_row: torch.Tensor          # [P, recv_nnz] int64
    recv_dst: torch.Tensor          # [P, recv_nnz] int64
    recv_weight: torch.Tensor       # [P, recv_nnz] f32
    # Degree-bucketed layouts of the receive-side scatter (built when the
    # owned-row count is known): forward maps the wire receive buffer into
    # local rows through the aggregation kernel; the transpose drives its
    # backward.
    recv_ell: Optional[segagg.DeviceBucketedEll] = None
    recv_ell_t: Optional[segagg.DeviceBucketedEll] = None
    # The same for the send side's pre-aggregation (owned rows -> wire
    # slots): the ``ell`` backend sums each slot's partials with the kernel.
    pre_ell: Optional[segagg.DeviceBucketedEll] = None
    pre_ell_t: Optional[segagg.DeviceBucketedEll] = None


def _host_bucketed(src, dst, weight, num_dst: int, num_src: int):
    """Bucketed-ELL (fwd + reverse) of each worker's weighted COO map
    ``src -> dst`` ([P, nnz] numpy), as host *stacked* bucket tuples
    (``stack_bucketed_ells`` format). Padding entries carry weight 0 and
    are dropped, so they don't inflate row 0's degree class."""
    fwd, rev = [], []
    for p in range(src.shape[0]):
        keep = weight[p] != 0
        csr = gstruct.coo_to_csr(src[p][keep], dst[p][keep], weight[p][keep],
                                 num_dst, num_src)
        fwd.append(gstruct.bucketed_ell_from_csr(csr))
        rev.append(gstruct.bucketed_ell_from_csr(gstruct.transpose_csr(csr)))
    return (gstruct.stack_bucketed_ells(fwd),
            gstruct.stack_bucketed_ells(rev))


def host_pre_bucketed(hp, num_rows: int):
    """:func:`_host_bucketed` of each worker's send-side pre-aggregation
    (owned rows ``pre_src`` -> wire slots ``pre_slot``)."""
    return _host_bucketed(hp.pre_src, hp.pre_slot, hp.pre_weight,
                          hp.send_gather_idx.shape[-1], num_rows)


def host_recv_bucketed(hp, num_rows: int):
    """Bucketed-ELL (fwd + reverse) of each worker's recv scatter, as host
    *stacked* bucket tuples ([P, ...] numpy, ``stack_bucketed_ells``
    format). The host plan's padding entries carry weight 0 — they are
    dropped here so they don't inflate row 0's degree class."""
    return _host_bucketed(hp.recv_row, hp.recv_dst, hp.recv_weight, num_rows,
                          hp.send_gather_idx.shape[-1])


def stack_halo_plan(hp, num_rows: Optional[int] = None,
                    device="cuda") -> DeviceHaloPlan:
    """graph.remote.HaloPlan (host numpy, [P, ...]) -> stacked device plan.

    ``num_rows`` (each worker's padded owned-row count) additionally builds
    the bucketed pre-aggregation and recv-scatter layouts consumed by the
    ``ell`` aggregation backend; without it the plan only supports the COO
    paths.
    """
    layouts = {}
    if num_rows is not None:
        for name, host in (("pre", host_pre_bucketed), ("recv", host_recv_bucketed)):
            fwd, rev = host(hp, num_rows)
            layouts[f"{name}_ell"] = segagg.device_bucketed(fwd, device=device,
                                                           squeeze=False)
            layouts[f"{name}_ell_t"] = segagg.device_bucketed(rev, device=device,
                                                             squeeze=False)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return DeviceHaloPlan(
        send_gather_idx=t(hp.send_gather_idx, torch.int64),
        send_gather_mask=t(hp.send_gather_mask, torch.bool),
        pre_src=t(hp.pre_src, torch.int64),
        pre_slot=t(hp.pre_slot, torch.int64),
        pre_weight=t(hp.pre_weight, torch.float32),
        recv_row=t(hp.recv_row, torch.int64),
        recv_dst=t(hp.recv_dst, torch.int64),
        recv_weight=t(hp.recv_weight, torch.float32),
        **layouts,
    )


class DeviceHierPlan(NamedTuple):
    """Two DeviceHaloPlan's: intra (rank chunks) + inter (group chunks)."""

    intra: DeviceHaloPlan
    inter: DeviceHaloPlan


def stack_hier_plan(hp, num_rows: Optional[int] = None,
                    device="cuda") -> DeviceHierPlan:
    """graph.remote.HierHaloPlan (host numpy) -> stacked device plan."""
    return DeviceHierPlan(
        intra=stack_halo_plan(hp.intra, num_rows=num_rows, device=device),
        inter=stack_halo_plan(hp.inter, num_rows=num_rows, device=device),
    )


def assemble_send(h: torch.Tensor, plan: DeviceHaloPlan,
                  agg_backend: str = "coo") -> torch.Tensor:
    """Build the [P, C*R, F] wire buffers: post raws + pre partials (Fig 2
    step 4).

    ``agg_backend="ell"`` (with a plan that carries the bucketed layouts)
    sums each slot's partials with the aggregation kernel, forward and
    backward, in a fixed order; ``"coo"`` adds them in edge order
    (:func:`_index_add`).
    """
    raw = torch.where(plan.send_gather_mask[..., None],
                      _take(h, plan.send_gather_idx), 0.0)
    if agg_backend == "ell" and plan.pre_ell is not None:
        return raw + segagg.bucketed_aggregate(h, plan.pre_ell, raw.shape[-2],
                                               ell_t=plan.pre_ell_t)
    return _index_add(raw, plan.pre_slot,
                      plan.pre_weight[..., None] * _take(h, plan.pre_src))


def scatter_recv(acc: torch.Tensor, recv: torch.Tensor, plan: DeviceHaloPlan,
                 agg_backend: str = "coo") -> torch.Tensor:
    """Post-aggregate received rows into the local accumulator (Fig 2 step 6).

    ``agg_backend="ell"`` (with a plan that carries the bucketed layouts)
    routes the scatter through the aggregation kernel, forward and
    backward; ``"coo"`` is the edge-order scatter-add.
    """
    if agg_backend == "ell" and plan.recv_ell is not None:
        return acc + segagg.bucketed_aggregate(
            recv, plan.recv_ell, acc.shape[-2], ell_t=plan.recv_ell_t)
    return _index_add(acc, plan.recv_dst,
                      plan.recv_weight[..., None] * _take(recv, plan.recv_row))


# --------------------------------------------------------------------------
# Stage topology + the two wire primitives (fp32, quantized)
# --------------------------------------------------------------------------


class StageTopo(NamedTuple):
    """One stage's collective pipeline over the stacked workers, viewed as
    ``lead = (G, W)`` (``(1, P)`` for the flat exchange).

    ``kind="a2a"``: all_to_all across the ``wire_dim`` axis of ``lead``
    with ``wire_chunks`` per-destination chunks (the flat exchange over all
    P workers, and the intra level over the W workers of a group).

    ``kind="grouped"``: psum_scatter over the W workers of a group (merging
    their additive contributions and sharding the group buffer 1/W per
    worker) -> all_to_all across the G groups -> all_gather over the W
    workers (the inter level). The axis names mirror the JAX package's.
    """

    kind: str            # "a2a" | "grouped"
    wire_axis: str
    wire_chunks: int
    shard_axis: str = ""
    shard_size: int = 1
    lead: Tuple[int, int] = (1, 1)
    wire_dim: int = 1    # axis of ``lead`` the all_to_all crosses


def _wire_a2a(v: torch.Tensor, topo: StageTopo) -> torch.Tensor:
    """all_to_all of [P, rows, F] buffers in ``wire_chunks`` chunks: worker
    i's chunk j lands in worker j's chunk i (across ``wire_dim``)."""
    g, w = topo.lead
    y = v.reshape(g, w, topo.wire_chunks, -1, v.shape[-1])
    return y.transpose(topo.wire_dim, 2).reshape(v.shape)


def _pre_wire(x: torch.Tensor, topo: StageTopo) -> torch.Tensor:
    """Transform the assembled send buffers into what goes on the wire."""
    if topo.kind == "a2a":
        return x
    g, w = topo.lead
    feat = x.shape[-1]
    s = x.shape[1] // (topo.wire_chunks * topo.shard_size)
    y = x.reshape(g, w, topo.wire_chunks, topo.shard_size, s, feat)
    # Per-group aggregation: partials destined for the same remote row merge
    # here (summed over the group's workers in rank order), and the group
    # buffer lands sharded 1/W per worker.
    acc = y[:, 0]
    for r in range(1, w):
        acc = acc + y[:, r]                              # [G, C, W, s, F]
    return acc.transpose(1, 2).reshape(g * w, topo.wire_chunks * s, feat)


def _post_wire(y: torch.Tensor, topo: StageTopo) -> torch.Tensor:
    """Transform the wire recv buffers back into the full recv buffers."""
    if topo.kind == "a2a":
        return y
    g, w = topo.lead
    feat = y.shape[-1]
    s = y.shape[1] // topo.wire_chunks
    recv = y.reshape(g, w, topo.wire_chunks, s, feat).transpose(1, 2)  # [G, C, W, s, F]
    full = recv.unsqueeze(1).expand(g, w, topo.wire_chunks, w, s, feat)
    return full.reshape(g * w, topo.wire_chunks * w * s, feat)


def _quantized_wire(v: torch.Tensor, u: torch.Tensor, topo: StageTopo,
                    bits: int) -> torch.Tensor:
    """Quantize wire-level buffers [P, rows, F], all_to_all the packed
    words with the fp32 (zero, scale) per 4-row group, dequantize.

    All P workers' buffers quantize in one ``quant_pack`` launch: each
    worker's rows are a multiple of 4, so no row group straddles two
    workers."""
    p, rows, feat = v.shape
    if rows % ROW_GROUP:
        raise ValueError(f"wire buffer of {rows} rows per worker is not a "
                         f"multiple of the quant row group ({ROW_GROUP})")
    packed, zero, scale = quant_pack(v.reshape(p * rows, feat),
                                     u.reshape(p * rows, feat), bits)
    qr = _wire_a2a(packed.reshape(p, rows, -1), topo)
    # fp32 (zero, scale) ride along — the paper's "params" wire term (Eqn 5).
    zr = _wire_a2a(zero.reshape(p, rows // ROW_GROUP, 1), topo)
    sr = _wire_a2a(scale.reshape(p, rows // ROW_GROUP, 1), topo)
    out = dequant_unpack(qr.reshape(p * rows, -1), zr.reshape(-1),
                         sr.reshape(-1), bits, feat)
    return out.reshape(p, rows, feat)


class _QuantizedExchange(torch.autograd.Function):
    """THE quantized wire segment: pre-wire (the psum_scatter for
    ``grouped`` topologies), quantization, the all_to_all of the packed
    payload plus (zero, scale), dequantization. The post-wire all_gather
    stays outside, so its transpose (a sum over the group) is autograd's.

    Backward: the pipeline is self-transpose, so the reverse exchange is
    the same exchange — the wire-level cotangent is re-quantized with its
    own uniforms, all_to_all'd, dequantized and fanned out through the
    post-wire (unbiased per Lemma 1)."""

    @staticmethod
    def forward(ctx, send, topo, bits, noise):
        ctx.topo, ctx.bits, ctx.noise = topo, bits, noise
        wire = _pre_wire(send, topo)
        return _quantized_wire(wire, noise(False, tuple(wire.shape)), topo, bits)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        u = ctx.noise(True, tuple(g.shape))
        return (_post_wire(_quantized_wire(g, u, ctx.topo, ctx.bits), ctx.topo),
                None, None, None)


def quantized_exchange(send: torch.Tensor, topo: StageTopo, bits: int,
                       noise: Callable[[bool, Tuple[int, ...]], torch.Tensor]
                       ) -> torch.Tensor:
    """The quantized wire segment of one stage; ``noise(backward, shape)``
    gives the forward and backward stochastic-rounding uniforms."""
    return _QuantizedExchange.apply(send, topo, bits, noise)


def _check_quant_alignment(topo: StageTopo, rows: int) -> None:
    """Quant row groups (4 rows share zero/scale) must not straddle the
    per-destination wire chunks."""
    per_chunk = rows // topo.wire_chunks
    if topo.kind == "grouped":
        per_chunk = rows // (topo.wire_chunks * topo.shard_size)
    if per_chunk % ROW_GROUP:
        raise ValueError(
            f"{topo.kind} stage wire chunk of {per_chunk} rows is not a "
            f"multiple of the quant row group ({ROW_GROUP})")


def stage_exchange(send: torch.Tensor, topo: StageTopo, bits: int,
                   noise: Optional[Callable[[bool, Tuple[int, ...]], torch.Tensor]] = None
                   ) -> torch.Tensor:
    """One stage's full exchange of assembled send buffers: pre-wire +
    (quantized) all_to_all + dequantize, then the post-wire fan-out
    (all_gather for ``grouped``, identity for ``a2a``)."""
    if bits == 0:
        wire = _wire_a2a(_pre_wire(send, topo), topo)
    else:
        if noise is None:
            raise ValueError("quantized exchange needs stochastic-rounding noise")
        _check_quant_alignment(topo, send.shape[1])
        wire = quantized_exchange(send, topo, bits, noise)
    return _post_wire(wire, topo)


# --------------------------------------------------------------------------
# Schedule: per-stage (level, bits, caching policy)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class StageSpec:
    """One exchange stage: a level with its wire format, caching policy and
    scheduling (see ``repro.core.exchange.StageSpec``)."""

    level: str   # "flat" | "intra" | "inter"
    bits: int = 0
    cd: int = 1
    overlap: bool = False

    def __post_init__(self):
        if self.level not in STAGE_LEVELS:
            raise ValueError(f"unknown stage level {self.level!r}")
        if self.bits not in WIRE_BITS:
            raise ValueError(f"bits must be one of {WIRE_BITS}, got {self.bits}")
        if self.cd < 1:
            raise ValueError(f"cd must be >= 1, got {self.cd}")

    @property
    def delayed(self) -> bool:
        return self.cd > 1

    def as_dict(self) -> dict:
        return {"level": self.level, "bits": self.bits,
                "policy": f"delayed({self.cd})" if self.delayed else "sync",
                "overlap": self.overlap}


@dataclass(frozen=True)
class ExchangeSchedule:
    """A sequence of exchange stages plus the worker layout they run on:
    one ``flat`` stage over P workers, or (``intra``, ``inter``) over
    ``num_groups * group_size == nparts`` workers."""

    stages: Tuple[StageSpec, ...]
    nparts: int
    axis_name: str = "workers"
    node_axis: str = "node"
    group_axis: str = "group"
    num_groups: int = 0
    group_size: int = 0

    def __post_init__(self):
        levels = tuple(s.level for s in self.stages)
        if levels == ("flat",):
            if self.num_groups or self.group_size:
                raise ValueError("flat schedule must not set num_groups/group_size")
        elif levels == ("intra", "inter"):
            if self.num_groups < 1 or self.group_size < 1:
                raise ValueError(
                    "hierarchical schedule needs num_groups >= 1 and "
                    f"group_size >= 1, got {self.num_groups}x{self.group_size}")
            if self.num_groups * self.group_size != self.nparts:
                raise ValueError(
                    f"num_groups * group_size ({self.num_groups}x"
                    f"{self.group_size}) must equal nparts ({self.nparts})")
        else:
            raise ValueError(
                f"schedule stages must be ('flat',) or ('intra', 'inter'), "
                f"got {levels}")

    # -- constructors ------------------------------------------------------

    @staticmethod
    def flat(nparts: int, bits: int = 0, cd: int = 1,
             axis_name: str = "workers",
             overlap: Optional[bool] = None) -> "ExchangeSchedule":
        """``overlap=None`` keeps the flat exchange sequential."""
        return ExchangeSchedule(
            stages=(StageSpec("flat", bits=bits, cd=cd,
                              overlap=bool(overlap)),),
            nparts=nparts, axis_name=axis_name)

    @staticmethod
    def hierarchical(num_groups: int, group_size: int, *,
                     intra_bits: int = 0, inter_bits: int = 0,
                     intra_cd: int = 1, inter_cd: int = 1,
                     node_axis: str = "node",
                     group_axis: str = "group",
                     overlap: Optional[bool] = None) -> "ExchangeSchedule":
        """``overlap=None`` defaults to True, as in the JAX package."""
        overlap = True if overlap is None else overlap
        return ExchangeSchedule(
            stages=(StageSpec("intra", bits=intra_bits, cd=intra_cd,
                              overlap=overlap),
                    StageSpec("inter", bits=inter_bits, cd=inter_cd,
                              overlap=overlap)),
            nparts=num_groups * group_size,
            node_axis=node_axis, group_axis=group_axis,
            num_groups=num_groups, group_size=group_size)

    # -- structure ---------------------------------------------------------

    @property
    def is_hierarchical(self) -> bool:
        return self.stages[0].level != "flat"

    @property
    def uses_cache(self) -> bool:
        return any(s.delayed for s in self.stages)

    @property
    def delayed_indices(self) -> Tuple[int, ...]:
        return tuple(i for i, s in enumerate(self.stages) if s.delayed)

    def as_sync(self) -> "ExchangeSchedule":
        """The same schedule with every stage forced to sync (cd=1)."""
        return dataclasses.replace(
            self, stages=tuple(dataclasses.replace(s, cd=1)
                               for s in self.stages))

    def topo(self, stage: StageSpec) -> StageTopo:
        if stage.level == "flat":
            return StageTopo("a2a", self.axis_name, self.nparts,
                             lead=(1, self.nparts), wire_dim=1)
        lead = (self.num_groups, self.group_size)
        if stage.level == "intra":
            return StageTopo("a2a", self.node_axis, self.group_size,
                             lead=lead, wire_dim=1)
        return StageTopo("grouped", self.group_axis, self.num_groups,
                         self.node_axis, self.group_size, lead=lead, wire_dim=0)

    def plan_for(self, stage: StageSpec, wd) -> DeviceHaloPlan:
        """Pick the stage's device plan off a WorkerData-like carrier (any
        object with ``plan`` / ``hier_plan`` attributes)."""
        if stage.level == "flat":
            if wd.plan is None:
                raise ValueError("flat schedule needs WorkerData.plan")
            return wd.plan
        if wd.hier_plan is None:
            raise ValueError("hierarchical schedule needs WorkerData.hier_plan")
        return wd.hier_plan.intra if stage.level == "intra" else wd.hier_plan.inter

    # -- execution ---------------------------------------------------------

    def layer_program(self, wd, agg_backend: str = "coo") -> "LayerProgram":
        """Compile this schedule against the workers' plans into the
        two-phase :class:`LayerProgram` (``issue -> local aggregation ->
        finalize``)."""
        return LayerProgram(self, wd, agg_backend=agg_backend)

    # -- cache layout ------------------------------------------------------

    def cache_rows(self, wd) -> Tuple[int, ...]:
        """Recv-buffer row count for each delayed stage (cache shapes)."""
        return tuple(
            self.plan_for(self.stages[i], wd).send_gather_idx.shape[-1]
            for i in self.delayed_indices)

    def init_cache(self, wd, feature_dims: Sequence[int]
                   ) -> List[Tuple[torch.Tensor, ...]]:
        """Zero halo cache: one [P, rows, F] buffer per (layer, delayed stage)."""
        rows = self.cache_rows(wd)
        return [tuple(torch.zeros((self.nparts, r, f), device=wd.x.device)
                      for r in rows) for f in feature_dims]

    # -- accounting --------------------------------------------------------

    def describe(self) -> dict:
        d = {"stages": [s.as_dict() for s in self.stages],
             "nparts": self.nparts}
        if self.is_hierarchical:
            d.update(num_groups=self.num_groups, group_size=self.group_size)
        return d

    def wire_volume_bytes(self, stats, feat_dim: int) -> Dict[str, float]:
        """Per-stage predicted wire bytes per epoch (amortized over cd),
        from a ``graph.remote.CommStats``."""
        return {
            s.level: stats.volume_bytes(
                feat_dim, bits=s.bits or 32,
                stage=None if s.level == "flat" else s.level, cd=s.cd)
            for s in self.stages
        }


# --------------------------------------------------------------------------
# Two-phase LayerProgram: issue the wire, aggregate locally, finalize
# --------------------------------------------------------------------------


class StackedWire(NamedTuple):
    """One stage's transport on the stacked worker axis: ``post`` runs the
    whole exchange (:func:`stage_exchange`) and ``collect`` hands back its
    receive buffer."""

    topo: StageTopo
    bits: int

    def post(self, send: torch.Tensor, noise) -> torch.Tensor:
        return stage_exchange(send, self.topo, self.bits, noise)

    def collect(self, recv: torch.Tensor) -> torch.Tensor:
        return recv


class LayerInFlight(NamedTuple):
    """Per-layer state between the ``issue`` and ``finalize`` phases
    (see ``repro.core.exchange.LayerInFlight``): per stage, the transport's
    handle of a posted wire or the stale buffer a skipped one serves."""

    h: torch.Tensor
    noise: Optional[Noise]
    epoch: Optional[int]
    cache_entry: Optional[Sequence[torch.Tensor]]
    posted: Tuple[Optional[object], ...]
    stale: Tuple[Optional[torch.Tensor], ...]


class LayerProgram:
    """One layer's exchange schedule compiled into (issue, finalize) phases.

    ``issue`` posts every ``overlap`` stage's wire — inter first.
    ``finalize`` collects them and scatters all receives into the
    accumulator, posting and collecting any sequential (``overlap=False``)
    stage's wire on the spot. A delayed stage on a stale epoch posts
    nothing and serves its cached buffer detached.

    ``transports`` gives each stage's ``post(send, noise) -> handle`` and
    ``collect(handle) -> recv`` (default: :class:`StackedWire`).
    """

    def __init__(self, schedule: ExchangeSchedule, wd,
                 agg_backend: str = "coo", transports: Optional[Sequence] = None):
        self.agg_backend = agg_backend
        if transports is None:
            transports = [StackedWire(schedule.topo(s), s.bits)
                          for s in schedule.stages]
        self._stages = tuple(
            (spec, schedule.plan_for(spec, wd), wire)
            for spec, wire in zip(schedule.stages, transports))
        self._cache_slot = {si: ci for ci, si
                            in enumerate(schedule.delayed_indices)}
        self._issue_order = tuple(
            si for si in reversed(range(len(self._stages)))
            if self._stages[si][0].overlap)

    def _stale(self, si: int, epoch, cache_entry) -> Optional[torch.Tensor]:
        """The detached cached buffer a delayed stage serves on a stale
        epoch, else None (the wire runs)."""
        spec = self._stages[si][0]
        if not spec.delayed:
            return None
        if cache_entry is None or epoch is None:
            raise ValueError(
                f"stage {spec.level!r} is delayed(cd={spec.cd}) "
                "and needs a halo cache + epoch")
        if int(epoch) % spec.cd == 0:
            return None
        return cache_entry[self._cache_slot[si]].detach()

    def _post(self, si: int, h: torch.Tensor, noise: Optional[Noise]):
        _, plan, wire = self._stages[si]
        stage_noise = None
        if noise is not None:
            stage_noise = lambda backward, shape: noise(si, backward, shape)
        return wire.post(assemble_send(h, plan, self.agg_backend), stage_noise)

    def issue(self, h: torch.Tensor, noise: Optional[Noise],
              cache_entry: Optional[Sequence[torch.Tensor]] = None,
              epoch: Optional[int] = None) -> LayerInFlight:
        """Post every overlapped stage's wire (inter first)."""
        n = len(self._stages)
        posted: List[Optional[object]] = [None] * n
        stale: List[Optional[torch.Tensor]] = [None] * n
        for si in self._issue_order:
            stale[si] = self._stale(si, epoch, cache_entry)
            if stale[si] is None:
                posted[si] = self._post(si, h, noise)
        return LayerInFlight(h=h, noise=noise, epoch=epoch,
                             cache_entry=cache_entry,
                             posted=tuple(posted), stale=tuple(stale))

    def finalize(self, local_agg: torch.Tensor, inflight: LayerInFlight
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Scatter all receives into the accumulator (running sequential
        stages' wires now). Returns (aggregated output, new cache entry —
        one buffer per delayed stage in stage order)."""
        acc = local_agg
        new_entry: List[torch.Tensor] = []
        for si, (spec, plan, wire) in enumerate(self._stages):
            r, handle = inflight.stale[si], inflight.posted[si]
            if r is None and handle is None:
                # A sequential (overlap=False) stage: post and collect back
                # to back, in order.
                r = self._stale(si, inflight.epoch, inflight.cache_entry)
                if r is None:
                    handle = self._post(si, inflight.h, inflight.noise)
            if r is None:
                r = wire.collect(handle)
            if spec.delayed:
                new_entry.append(r.detach())
            acc = scatter_recv(acc, r, plan, agg_backend=self.agg_backend)
        return acc, tuple(new_entry)
