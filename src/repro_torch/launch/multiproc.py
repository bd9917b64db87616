"""Multi-process training over the shared-memory graph store, in PyTorch.

Counterpart of ``repro/launch/multiproc.py``. ``ExecSpec.mode="multiproc"``
runs P real OS processes (spawned with the ``spawn`` start method, the
thread env partitioned across ranks), one per partition, in place of the
P workers stacked on one device. The parent builds the partition once
(``prepare_distributed_host``) and publishes every partition-time array
(features, labels, masks, COO triples, bucketed-ELL layouts, halo plans)
in one :class:`~repro_torch.launch.shm_store.ShmArena` segment; each rank
maps that one copy and moves only its own slice to its device. On one
card all ranks share it, each with its own CUDA context.

A rank is the stacked code at P = 1: its arrays keep a leading worker axis
of 1, so ``assemble_send``, ``scatter_recv``, ``bucketed_aggregate`` and
``core.model`` run unchanged. The halo exchange runs the schedule's
stages over shared-memory mailboxes in host rounds:

  a2a stages      quantize(full wire buffer) -> all_to_all of (packed
                  words + fp32 zero/scale per 4-row group) -> dequantize
  grouped stages  psum_scatter over the node axis -> quantized all_to_all
                  over the group axis -> all_gather over the node axis

A quantized round quantizes with ``quant_pack`` and dequantizes with
``dequant_unpack`` on the rank's device (the kernels on the card, their
plain versions on the CPU); only the packed payload, ``zero`` and
``scale`` cross to the mailbox. Two ``torch.autograd.Function``
transports (:class:`_MpPost`, :class:`_MpCollect`) carry the rounds
through autograd, and each stage's :class:`_StageExec` is the transport
``core.exchange.LayerProgram`` drives (the stacked mode's is
``StackedWire``): the backward of a collect is the stage's transpose wire
(re-quantized with the backward uniforms) in one combined round.

Randomness: every rank holds the stacked trainer's randomness object and
draws the stacked shape (``[P, ...]``), then takes its own row, so a rank
sees the numbers the stacked run gives its worker. For a grouped stage
the quantized rows are the psum-scattered ``[G*s, F]`` shard, the row the
stacked exchange quantizes for that worker.

Gradients: a rank backpropagates its loss sum over the global loss count,
and the ranks sum their gradients on the host in rank order, which gives
the gradient of the global mean loss and bitwise the same parameters on
every rank (no broadcast). The stacked trainer backpropagates ``P * loss``
(ROADMAP C-ref6), so the two agree to AdamW's ``eps``, not bitwise.

What becomes measured here:

* overlap: an ``overlap=True`` stage posts its chunks in the layer's
  ``issue`` phase and waits on its peers in ``finalize``, after the local
  aggregation; with ``overlap=False`` a rank posts and waits back to back.
* delayed communication: on a stale epoch (``epoch % cd != 0``) a delayed
  stage skips its transport entirely and serves the cached buffer; the
  mailbox byte counters show it.

The wire's payload differs from the JAX package's at one point: where
``F % (32/bits) != 0`` (layer 0's F = 100 at Int2) the JAX package sends
one byte per value, while the port sends the words ``quant_pack`` stores,
``ceil(F / (32/bits))`` per row; the values are the same.

Determinism: every rank runs the same sequence of mailbox ops per epoch,
each op's posts precede its reads, and the per-epoch gradient sum is a
full barrier, so the wire cannot deadlock and slots are reused safely.
Every op a rank runs repeats bitwise (the kernels, the sort-based
backward of gathers, the ``coo`` scatter-adds, the rank-ordered sum), so
a recovered run equals the uninterrupted one.

The control plane (spawning, the store, the command pipes: :class:`_Fleet`)
and the rank's training step (:class:`_RankBase`) are shared with
``exec.mode=shard_map`` (``launch.spmd``), whose wire is
``torch.distributed`` collectives instead of mailboxes.

Fault tolerance (the :class:`MultiprocRuntime` docstring has the
protocol): per-rank heartbeat words tell dead, hung and failing ranks
apart; on a failure the parent quiesces the survivors, respawns the lost
ranks against the existing segments, restores every rank from the newest
checkpoint step all ranks hold, and retries; after ``exec.max_restarts``
recoveries it aborts cleanly. ``repro_torch.launch.chaos`` drives it.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import signal
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    latest_common_step,
    restore_train_state,
)
from repro_torch.core import exchange as X
from repro_torch.core import model as M
from repro_torch.core.exchange import (
    _timed_wire,
    DeviceHaloPlan,
    DeviceHierPlan,
    ExchangeSchedule,
    LayerProgram,
    StageSpec,
    StageTopo,
    host_pre_bucketed,
    host_recv_bucketed,
    host_send_bucketed,
)
from repro_torch.core.randomness import GeneratorRandomness
from repro_torch.core.trainer import (WorkerData, _grads, _local_aggregate, refuse_gat,
                                      resolve_device)
from repro_torch.kernels import launch_counts
from repro_torch.kernels import quant_pack as qp
from repro_torch.kernels import seg_aggregate as sa
from repro_torch.launch.shm_store import (
    Mailboxes,
    ShmArena,
    TransportAborted,
    TransportRecover,
    TransportTimeout,
    plan_mailbox,
    publish_store,
    rss_bytes,
    run_token,
)
from repro_torch.optim.adamw import adamw_init, adamw_update, tree_leaves, tree_map
from repro_torch.quant.stochastic import ROW_GROUP, words_per_row

_THREAD_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
_WORKER_WAIT_S = 600.0  # mailbox spin deadline
_PARENT_WAIT_S = 900.0  # parent deadline per command round
_RECOVER_DRAIN_S = 120.0  # per-round deadline quiescing survivors
_COLD_GRACE_S = 300.0  # hang deadline for a rank's first command: a fresh
# rank builds its kernel tables and CUDA context during its first epoch,
# before the mailbox ops that bump its heartbeat
_CHAOS_STALL_S = 3600.0  # a chaos "stall" sleeps this long (heartbeat-free)

# Deterministic fault injection (launch.chaos): a rank whose number matches
# REPRO_CHAOS_RANK fires REPRO_CHAOS_FAULT (kill | stall) at the start of
# the train_epoch that follows REPRO_CHAOS_EPOCH completed epochs, on spawn
# generation 0 only, so a respawned rank never fires again.
_CHAOS_ENV = ("REPRO_CHAOS_FAULT", "REPRO_CHAOS_RANK", "REPRO_CHAOS_EPOCH")


def _chaos_from_env(rank: int, generation: int) -> Optional[dict]:
    fault = os.environ.get("REPRO_CHAOS_FAULT")
    if not fault or generation != 0:
        return None
    if int(os.environ.get("REPRO_CHAOS_RANK", "0")) != rank:
        return None
    return {"fault": fault,
            "epoch": int(os.environ.get("REPRO_CHAOS_EPOCH", "1"))}


def _transport_kind(e: BaseException) -> Optional[str]:
    """Classify an exception escaping a rank's command: "recover",
    "abort" or "timeout" for the mailbox conditions, else None (a real
    error). Autograd may re-raise an error of a backward wrapped, so the
    cause/context chain and the rendered message are searched."""
    seen, stack = set(), [e]
    while stack:
        x = stack.pop()
        if x is None or id(x) in seen:
            continue
        seen.add(id(x))
        if isinstance(x, TransportRecover):
            return "recover"
        if isinstance(x, TransportAborted):
            return "abort"
        if isinstance(x, TransportTimeout):
            return "timeout"
        stack += [x.__cause__, x.__context__]
    s = repr(e)
    for name, kind in (("TransportRecover", "recover"),
                       ("TransportAborted", "abort"),
                       ("TransportTimeout", "timeout")):
        if name in s:
            return kind
    return None


# --------------------------------------------------------------------------
# Wire payload accounting and host packing
# --------------------------------------------------------------------------


def quant_payload_bytes(rows: int, feat: int, bits: int) -> int:
    """Mailbox bytes of a quantized [rows, feat] chunk's payload: the int32
    words ``quant_pack`` stores, ``ceil(feat / (32/bits))`` per row, at
    every width (the JAX package sends one byte per value where ``feat``
    does not fill whole words)."""
    return rows * words_per_row(feat, bits) * 4


def chunk_bytes(rows: int, feat: int, bits: int) -> int:
    """Mailbox slot bytes of one wire chunk (payload + fp32 zero/scale per
    4-row quant group when the stage quantizes)."""
    if not bits:
        return rows * feat * 4
    return quant_payload_bytes(rows, feat, bits) + (rows // ROW_GROUP) * 2 * 4


def _np_pack(q: np.ndarray, bits: int) -> np.ndarray:
    """Pack ints in [0, 2^bits) into uint32 words, little-end-first within
    the word: ``quant.stochastic.pack_bits``'s layout, which the kernel
    stores. A row that does not fill its last word leaves it zero-padded."""
    per = 32 // bits
    rows, feat = q.shape
    words = words_per_row(feat, bits)
    qw = np.zeros((rows, words * per), np.uint32)
    qw[:, :feat] = q
    shifts = (np.arange(per, dtype=np.uint32) * np.uint32(bits))
    return (qw.reshape(rows, words, per) << shifts[None, None, :]).sum(
        axis=-1, dtype=np.uint32)


def _np_unpack(words: np.ndarray, bits: int, feat: int) -> np.ndarray:
    per = 32 // bits
    rows = words.shape[0]
    shifts = (np.arange(per, dtype=np.uint32) * np.uint32(bits))
    mask = np.uint32((1 << bits) - 1)
    q = (words[:, :, None] >> shifts[None, None, :]) & mask
    return q.reshape(rows, -1)[:, :feat].astype(np.int32)


def _pack_chunk(words: np.ndarray, zero: np.ndarray, scale: np.ndarray
                ) -> np.ndarray:
    """[payload words][zero f32][scale f32] as one contiguous uint8 buffer."""
    return np.concatenate([
        np.ascontiguousarray(words).view(np.uint8).reshape(-1),
        np.ascontiguousarray(zero, dtype=np.float32).view(np.uint8),
        np.ascontiguousarray(scale, dtype=np.float32).view(np.uint8),
    ])


def _unpack_chunk(buf: np.ndarray, rows: int, feat: int, bits: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(words int32 [rows, ceil(feat/(32/bits))], zero, scale) of a chunk."""
    groups = rows // ROW_GROUP
    pe = buf.nbytes - 2 * groups * 4
    zero = buf[pe:pe + groups * 4].copy().view(np.float32)
    scale = buf[pe + groups * 4:].copy().view(np.float32)
    words = buf[:pe].copy().view(np.int32).reshape(rows, words_per_row(feat, bits))
    return words, zero, scale


def _as_f32(buf: np.ndarray, rows: int, feat: int) -> np.ndarray:
    return buf.copy().view(np.float32).reshape(rows, feat)


# --------------------------------------------------------------------------
# Op table: every (op id, src->dst pair, slot bytes) of one run
# --------------------------------------------------------------------------


def _ordered_pairs(ranks: Sequence[int]) -> List[List[int]]:
    return [[s, d] for s in ranks for d in ranks]


def _a2a_pairs(nprocs: int, chunks: int) -> List[List[int]]:
    """Pair set of a tiled all_to_all: all ordered pairs inside each
    contiguous block of ``chunks`` ranks (the whole world when chunks ==
    nprocs: the flat exchange; per-group blocks for the intra level)."""
    if chunks == nprocs:
        return _ordered_pairs(range(nprocs))
    pairs: List[List[int]] = []
    for g in range(nprocs // chunks):
        pairs.extend(_ordered_pairs(range(g * chunks, (g + 1) * chunks)))
    return pairs


def _grouped_pairs(nprocs: int, num_groups: int, group_size: int
                   ) -> Tuple[List[List[int]], List[List[int]]]:
    """(node-axis mate pairs, group-axis peer pairs) of the grouped stage.
    Rank r sits at (g, w) = (r // W, r % W), the stacked worker order."""
    mates: List[List[int]] = []
    for g in range(num_groups):
        mates.extend(_ordered_pairs(
            [g * group_size + v for v in range(group_size)]))
    gpeers: List[List[int]] = []
    for w in range(group_size):
        gpeers.extend(_ordered_pairs(
            [b * group_size + w for b in range(num_groups)]))
    return mates, gpeers


def _op(op_id: str, pairs: List[List[int]], nbytes: int) -> dict:
    return {"id": op_id, "pairs": [[s, d, nbytes] for s, d in pairs]}


def build_op_table(schedule: ExchangeSchedule,
                   eval_schedule: ExchangeSchedule,
                   nprocs: int, num_layers: int,
                   feat_dims: Sequence[int],
                   wire_rows: Dict[str, int],
                   nparams: int) -> List[dict]:
    """The full mailbox op table of one run: per (tag, layer, stage) the
    stage's collective sub-ops, plus the global reductions. Parent and
    ranks derive op ids from the same (schedule, layer) naming, so the
    table is the one source of the slot layout."""
    ops: List[dict] = []
    for tag, sched in (("t", schedule), ("e", eval_schedule)):
        for l in range(num_layers):
            f = feat_dims[l]
            for stage in sched.stages:
                topo = sched.topo(stage)
                rows = wire_rows[stage.level]
                base = f"{tag}.L{l}.{stage.level}"
                if topo.kind == "a2a":
                    nb = chunk_bytes(rows // topo.wire_chunks, f, stage.bits)
                    pairs = _a2a_pairs(nprocs, topo.wire_chunks)
                    ops.append(_op(f"{base}.x", pairs, nb))
                    if tag == "t":
                        ops.append(_op(f"{base}.xb", pairs, nb))
                else:
                    G, W = topo.wire_chunks, topo.shard_size
                    s = rows // (G * W)
                    mates, gpeers = _grouped_pairs(nprocs, G, W)
                    shard_nb = G * s * f * 4
                    a2a_nb = chunk_bytes(s, f, stage.bits)
                    names = [("psc", mates, shard_nb),
                             ("a2a", gpeers, a2a_nb),
                             ("ag", mates, shard_nb)]
                    if tag == "t":
                        names += [("pscb", mates, shard_nb),
                                  ("a2ab", gpeers, a2a_nb),
                                  ("agb", mates, shard_nb)]
                    for name, pairs, nb in names:
                        ops.append(_op(f"{base}.{name}", pairs, nb))
    world = _ordered_pairs(range(nprocs))
    ops.append(_op("t.cnt", world, 4))
    ops.append(_op("t.grads", world, (nparams + 3) * 4))
    ops.append(_op("e.metrics", world, 8))
    return ops


# --------------------------------------------------------------------------
# The two transports, as autograd Functions
# --------------------------------------------------------------------------


class _MpPost(torch.autograd.Function):
    """Post ``send``'s wire chunks to the peers (no waiting) and pass
    ``send`` through as the in-flight carrier :class:`_MpCollect` takes."""

    @staticmethod
    def forward(ctx, send, ex):
        ex.h_post(send)
        return send.view_as(send)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MpCollect(torch.autograd.Function):
    """Wait for the peers' chunks and assemble this stage's receive
    buffer. The backward runs the stage's transpose wire (re-quantized
    with the backward uniforms) as one combined round."""

    @staticmethod
    def forward(ctx, carrier, ex):
        ctx.ex = ex
        return ex.h_collect()

    @staticmethod
    def backward(ctx, g):
        return ctx.ex.h_bwd(g.contiguous()), None


# --------------------------------------------------------------------------
# Per-(tag, layer, stage) executor: the host rounds of one stage
# --------------------------------------------------------------------------


class _StageExec:
    """One stage's mailbox geometry and host rounds for one rank.

    A forward a2a stage splits across ``h_post`` (quantize + post the
    chunks; in the layer's issue phase for an overlapped stage) and
    ``h_collect`` (wait + assemble + dequantize). A grouped stage posts its
    psum_scatter contributions in ``h_post`` and runs the other rounds
    (scatter-sum, quantized group all_to_all, node all_gather) in
    ``h_collect``. ``h_bwd`` is the stage's transpose pipeline in one
    combined round. Buffers are ``[1, rows, F]`` tensors on the rank's
    device; quantization runs there, and the mailbox moves host bytes.
    Each round adds its host seconds to ``clock["wire_s"]``; they include
    the device work a round waits for (its copies to the host synchronize).
    """

    def __init__(self, mb: Mailboxes, op_base: str, spec: StageSpec,
                 topo: StageTopo, rank: int, nprocs: int, rows: int, feat: int,
                 device: torch.device, clock: Dict[str, float]):
        self.mb = mb
        self.clock = clock
        self.bits = spec.bits
        self.topo = topo
        self.rank, self.nprocs = rank, nprocs
        self.rows, self.feat = rows, feat
        self.device = device
        if topo.kind == "a2a":
            C = topo.wire_chunks
            g = rank // C if C < nprocs else 0
            self.peers = [g * C + j for j in range(C)]
            self.chunk_rows = rows // C
            self.op_x, self.op_xb = f"{op_base}.x", f"{op_base}.xb"
        else:
            G, W = topo.wire_chunks, topo.shard_size
            g, w = rank // W, rank % W
            self.G, self.W = G, W
            self.s = rows // (G * W)
            self.mates = [g * W + v for v in range(W)]
            self.gpeers = [b * W + w for b in range(G)]
            for name in ("psc", "a2a", "ag", "pscb", "a2ab", "agb"):
                setattr(self, f"op_{name}", f"{op_base}.{name}")
        # Rows each quantized round covers: the full wire buffer for an
        # a2a stage, the psum-scattered [G*s, F] shard for a grouped one.
        self._qrows = rows if topo.kind == "a2a" else self.G * self.s
        self._noise: Optional[Callable[[bool, Tuple[int, ...]], torch.Tensor]] = None

    # -- the transport a LayerProgram drives ---------------------------------

    def post(self, send: torch.Tensor, noise) -> torch.Tensor:
        """Post ``send`` with this execution's uniforms: ``noise(backward,
        shape)`` draws the stacked ``[P, rows, F]`` uniforms, of which this
        rank takes its own row (None for an unquantized or evaluation
        wire). Returns the carrier :meth:`collect` takes."""
        self._noise = noise
        return _MpPost.apply(send, self)

    def collect(self, carrier: torch.Tensor) -> torch.Tensor:
        return _MpCollect.apply(carrier, self)

    def _uniform(self, backward: bool) -> torch.Tensor:
        if self._noise is None:
            raise ValueError("a quantized stage needs stochastic-rounding noise")
        u = self._noise(backward, (self.nprocs, self._qrows, self.feat))
        return u[self.rank].to(self.device)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(t.detach().reshape(-1, self.feat).cpu().numpy(),
                                    dtype=np.float32)

    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- a2a rounds --------------------------------------------------------

    def _a2a_post(self, op: str, w: torch.Tensor, peers: Sequence[int],
                  rows: int, backward: bool) -> None:
        """Quantize (on the device) and post ``w`` ([len(peers)*rows, F]),
        chunk j to peer j."""
        if self.bits:
            packed, zero, scale = qp.quant_pack(
                w.detach().reshape(-1, self.feat).contiguous(),
                self._uniform(backward), self.bits)
            words, zero, scale = (t.cpu().numpy() for t in (packed, zero, scale))
            gpc = rows // ROW_GROUP
            for j, peer in enumerate(peers):
                self.mb.post(op, peer, _pack_chunk(
                    words[j * rows:(j + 1) * rows], zero[j * gpc:(j + 1) * gpc],
                    scale[j * gpc:(j + 1) * gpc]))
        else:
            host = self._host(w)
            for j, peer in enumerate(peers):
                self.mb.post(op, peer, host[j * rows:(j + 1) * rows])

    def _a2a_read(self, op: str, peers: Sequence[int], rows: int) -> torch.Tensor:
        """Collect the peers' chunks and dequantize them (on the device):
        [len(peers)*rows, F]."""
        parts = [self.mb.collect(op, peer) for peer in peers]
        self.mb.complete(op)
        if self.bits:
            ws, zs, ss = zip(*(_unpack_chunk(p, rows, self.feat, self.bits)
                               for p in parts))
            return qp.dequant_unpack(*(self._device(np.concatenate(a))
                                       for a in (ws, zs, ss)), self.bits, self.feat)
        return self._device(np.concatenate([_as_f32(p, rows, self.feat)
                                            for p in parts]))

    # -- grouped sub-rounds ------------------------------------------------

    def _psc_post(self, op: str, x: torch.Tensor) -> None:
        """Post psum_scatter contributions: the mate at node index w gets
        this rank's [G, s, F] slice y[:, w]."""
        y = self._host(x).reshape(self.G, self.W, self.s, self.feat)
        for w_i, mate in enumerate(self.mates):
            self.mb.post(op, mate, np.ascontiguousarray(y[:, w_i]))

    def _psc_read(self, op: str) -> torch.Tensor:
        """Sum the W mates' contributions in node-index order -> [G*s, F]."""
        acc = None
        for mate in self.mates:
            part = self.mb.collect(op, mate).view(np.float32)  # a private copy
            acc = part if acc is None else acc + part
        self.mb.complete(op)
        return self._device(acc.reshape(self.G * self.s, self.feat))

    def _ag_round(self, op: str, shard: torch.Tensor) -> torch.Tensor:
        """all_gather over the node axis: [G*s, F] -> [1, G*W*s, F]."""
        buf = self._host(shard)
        for mate in self.mates:
            self.mb.post(op, mate, buf)
        parts = [self.mb.collect(op, mate).view(np.float32).reshape(
            self.G, self.s, self.feat) for mate in self.mates]
        self.mb.complete(op)
        full = np.stack(parts, axis=1).reshape(1, self.rows, self.feat)
        return self._device(full)

    def _grouped_pipeline(self, ops: Tuple[str, str, str], x: torch.Tensor,
                          backward: bool) -> torch.Tensor:
        """psum_scatter of ``x`` -> quantized group all_to_all -> all_gather
        (the forward's rounds after its post, or the whole backward)."""
        psc, a2a, ag = ops
        if backward:
            self._psc_post(psc, x)
        shard = self._psc_read(psc)
        self._a2a_post(a2a, shard, self.gpeers, self.s, backward)
        return self._ag_round(ag, self._a2a_read(a2a, self.gpeers, self.s))

    # -- the transports' entry points ---------------------------------------

    @_timed_wire
    def h_post(self, send: torch.Tensor) -> None:
        if self.topo.kind == "a2a":
            self._a2a_post(self.op_x, send, self.peers, self.chunk_rows, False)
        else:
            self._psc_post(self.op_psc, send)

    @_timed_wire
    def h_collect(self) -> torch.Tensor:
        if self.topo.kind == "a2a":
            return self._a2a_read(self.op_x, self.peers, self.chunk_rows)[None]
        return self._grouped_pipeline((self.op_psc, self.op_a2a, self.op_ag),
                                      None, False)

    @_timed_wire
    def h_bwd(self, g: torch.Tensor) -> torch.Tensor:
        if self.topo.kind == "a2a":
            self._a2a_post(self.op_xb, g, self.peers, self.chunk_rows, True)
            return self._a2a_read(self.op_xb, self.peers, self.chunk_rows)[None]
        # The transpose of the all_gather is a psum_scatter of the
        # cotangent; then the re-quantized group all_to_all; then the
        # transpose of the forward psum_scatter, an all_gather.
        return self._grouped_pipeline((self.op_pscb, self.op_a2ab, self.op_agb),
                                      g, True)


# --------------------------------------------------------------------------
# Rank process
# --------------------------------------------------------------------------


_PLAN_FIELDS = ("send_gather_idx", "send_gather_mask", "pre_src", "pre_slot",
                "pre_weight", "recv_row", "recv_dst", "recv_weight")
_PLAN_DTYPES = {"send_gather_mask": torch.bool, "pre_weight": torch.float32,
                "recv_weight": torch.float32}
# (arena key, DeviceHaloPlan field) of each plan's bucketed layouts
_PLAN_LAYOUTS = (("sell", "send_ell"), ("sellt", "send_ell_t"),
                 ("pell", "pre_ell"), ("pellt", "pre_ell_t"),
                 ("rell", "recv_ell"), ("rellt", "recv_ell_t"))


def _pin(rank: int, nprocs: int) -> None:
    """Pin this rank to its share of the CPU set (all ranks share the set
    when it has fewer cores than ranks)."""
    try:
        cpus = sorted(os.sched_getaffinity(0))
        if len(cpus) >= nprocs:
            per = len(cpus) // nprocs
            os.sched_setaffinity(0, set(cpus[rank * per:(rank + 1) * per]))
    except (AttributeError, OSError):
        pass


def _rank_ell(views: Dict[str, np.ndarray], prefix: str, ks: Sequence[int],
              rank: int, device) -> sa.DeviceBucketedEll:
    """This rank's ``[1, ...]`` slice of a stacked bucketed layout in the
    arena, on ``device``."""
    stacked = [(k, views[f"{prefix}.{i}.rows"][rank:rank + 1],
                views[f"{prefix}.{i}.idx"][rank:rank + 1],
                views[f"{prefix}.{i}.w"][rank:rank + 1])
               for i, k in enumerate(ks)]
    return sa.device_bucketed(stacked, device=device, squeeze=False)


def _slice(views: Dict[str, np.ndarray], key: str, rank: int, dtype, device
           ) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(views[key][rank:rank + 1]),
                           dtype=dtype, device=device)


def _rank_plan(views: Dict[str, np.ndarray], prefix: str, plan_meta: dict,
               rank: int, device) -> DeviceHaloPlan:
    kw = {f: _slice(views, f"plan.{prefix}.{f}", rank,
                    _PLAN_DTYPES.get(f, torch.int64), device) for f in _PLAN_FIELDS}
    for key, field in _PLAN_LAYOUTS:
        kw[field] = _rank_ell(views, f"plan.{prefix}.{key}",
                              plan_meta[f"{key}_ks"], rank, device)
    return DeviceHaloPlan(**kw)


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _flat(tree) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


def _unflat(vec: torch.Tensor, like):
    out, off = [], 0
    for t in tree_leaves(like):
        out.append(vec[off:off + t.numel()].view_as(t))
        off += t.numel()
    it = iter(out)
    return tree_map(lambda _: next(it), like)


class _RankBase:
    """One rank's training state, built from the manifest and the shared
    store: the rank's slices of the partition arrays on its device, the
    parameters, AdamW state and halo cache, and one ``LayerProgram`` per
    (train / eval, layer). The rank is the stacked code at P = 1.

    The wire is the subclass's: :meth:`_connect` joins the other ranks
    once the store is mapped, :meth:`_transport` gives each (tag, layer,
    stage) its ``LayerProgram`` transport, :meth:`_allreduce` sums a
    vector over the ranks in rank order and :meth:`_counters` reads the
    wire's seconds and bytes. :class:`_RankWorker` is multiproc's
    (mailboxes), ``launch.spmd._SpmdRank`` shard_map's (collectives).
    """

    COMMANDS = ("epoch", "eval", "summary", "state")

    def __init__(self, rank: int, nprocs: int, manifest: dict,
                 views: Optional[Dict[str, np.ndarray]] = None):
        from repro_torch.run.spec import RunSpec

        self.rank, self.nprocs = rank, nprocs
        spec = RunSpec.from_dict(manifest["spec"])
        self.spec = spec
        self.device = resolve_device(self._device_name(manifest))
        self.randomness = manifest["randomness"]
        self.dc = spec.schedule.to_dist_config(spec.partition, lr=spec.exec.lr)
        self.cfg = spec.model.to_gcn_config(spec.graph, spec.schedule)
        self.schedule = self.dc.schedule()
        self.eval_schedule = self.dc.sync_fp32().schedule()
        meta = manifest["meta"]
        dev = self.device
        self.clock = {"wire_s": 0.0}  # host seconds in the wire

        # ``views``: the partition arrays themselves, for a rank built in
        # the process that holds them (launch.spmd's lowering); else the
        # shared store's.
        self.rss_before_attach = rss_bytes()
        self.arena = None
        if views is None:
            self.arena = ShmArena.attach(manifest["store"]["name"],
                                         manifest["store"]["table"])
        self._connect(manifest)
        if views is None:
            views = self.arena.views()
        self.rss_after_attach = rss_bytes()

        # Move only this rank's slices of the shared store to the device.
        plan = hier_plan = None
        if "flat" in meta["plans"]:
            plan = _rank_plan(views, "flat", meta["plans"]["flat"], rank, dev)
        else:
            hier_plan = DeviceHierPlan(
                intra=_rank_plan(views, "intra", meta["plans"]["intra"], rank, dev),
                inter=_rank_plan(views, "inter", meta["plans"]["inter"], rank, dev))
        self.wd = WorkerData(
            x=_slice(views, "x", rank, torch.float32, dev),
            labels=_slice(views, "labels", rank, torch.int64, dev),
            train_mask=_slice(views, "train_mask", rank, torch.bool, dev),
            eval_mask=_slice(views, "eval_mask", rank, torch.bool, dev),
            owned_mask=_slice(views, "owned_mask", rank, torch.bool, dev),
            coo_src=_slice(views, "coo_src", rank, torch.int64, dev),
            coo_dst=_slice(views, "coo_dst", rank, torch.int64, dev),
            coo_w=_slice(views, "coo_w", rank, torch.float32, dev),
            plan=plan, hier_plan=hier_plan,
            ell=_rank_ell(views, "ell", meta["ell_ks"], rank, dev),
            ell_t=_rank_ell(views, "ellt", meta["ellt_ks"], rank, dev))
        self.rss_after_slices = rss_bytes()

        self._init_params = manifest["params"]
        self._reinit()
        wire_rows = meta["wire_rows"]
        dims = self.cfg.dims()[: self.cfg.num_layers]
        self._progs: Dict[str, List[LayerProgram]] = {}
        for tag, sched in (("t", self.schedule), ("e", self.eval_schedule)):
            progs = []
            for l in range(self.cfg.num_layers):
                wires = [self._transport(f"{tag}.L{l}.{stage.level}", stage,
                                         sched.topo(stage), wire_rows[stage.level],
                                         dims[l])
                         for stage in sched.stages]
                progs.append(LayerProgram(sched, self.wd, self.dc.agg_backend,
                                          transports=wires))
            self._progs[tag] = progs

    # -- the wire, the subclass's ---------------------------------------------

    def _device_name(self, manifest: dict) -> str:
        return manifest["device"]

    def _connect(self, manifest: dict) -> None:
        raise NotImplementedError

    def _transport(self, op_base: str, spec: StageSpec, topo: StageTopo,
                   rows: int, feat: int):
        raise NotImplementedError

    def _allreduce(self, op: str, vec: torch.Tensor) -> torch.Tensor:
        """``vec`` (fp32, 1-D) summed over all ranks in rank order, from
        zeros, on this rank's device: every rank gets bitwise the same
        result (no broadcast needed)."""
        raise NotImplementedError

    def _counters(self) -> Dict[str, float]:
        """The wire's running ``wait_s``, ``wire_s`` and ``wire_bytes``."""
        raise NotImplementedError

    def _before_epoch(self) -> None:
        pass

    def _after_epoch(self) -> None:
        pass

    # -- state ---------------------------------------------------------------

    def _reinit(self) -> None:
        """Parameters (the manifest's, else drawn from ``exec.seed`` as the
        stacked trainer draws them), fresh AdamW state, a zero halo cache
        and epoch 0."""
        if self._init_params is not None:
            params = tree_map(torch.from_numpy, self._init_params)
        else:
            params = M.init_params(self.cfg,
                                   torch.Generator().manual_seed(self.spec.exec.seed))
        self.params = M.to_device(params, self.device)
        self.opt_state = adamw_init(self.params)
        self.cache = None
        if self.schedule.uses_cache:
            dims = self.cfg.dims()[: self.cfg.num_layers]
            self.cache = [tuple(torch.zeros((1, r, f), device=self.device)
                                for r in self.schedule.cache_rows(self.wd))
                          for f in dims]
        self.epoch = 0

    # -- forward / step ------------------------------------------------------

    def _stacked(self, draw, shape) -> torch.Tensor:
        """This rank's row of a draw of the stacked ``[P, ...]`` shape."""
        return draw((self.nprocs, *shape[1:]))[self.rank:self.rank + 1]

    def _forward(self, params, prop_mask, train: bool, tag: str, cache,
                 epoch: Optional[int]):
        progs = self._progs[tag]
        rnd, dev = self.randomness, self.device
        new_cache: List[Tuple[torch.Tensor, ...]] = []

        def agg_fn(l: int, h: torch.Tensor) -> torch.Tensor:
            if X.RECORDER is not None:
                X.RECORDER.layer = l
            noise = None
            if train:
                noise = lambda si, backward, shape: rnd.quant_uniform(
                    epoch, l, si, backward, shape, dev)
            entry = cache[l] if cache is not None else None
            inflight = progs[l].issue(h, noise, cache_entry=entry, epoch=epoch)
            local = _local_aggregate(h, self.wd, self.dc.agg_backend)
            agg, ne = progs[l].finalize(local, inflight)
            new_cache.append(ne)
            return agg

        keep = None
        if train:
            p_keep = 1.0 - self.cfg.dropout
            keep = lambda l, shape: self._stacked(
                lambda s: rnd.dropout_keep(epoch, l, s, p_keep, dev), shape)
        logits = M.forward(params, self.cfg, self.wd.x, self.wd.labels, prop_mask,
                           agg_fn, dropout_keep=keep)
        return logits, new_cache

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def command(self, msg: dict) -> dict:
        """Run one of :attr:`COMMANDS`; returns the reply's fields."""
        cmd = msg["cmd"]
        if cmd == "epoch":
            return self.train_epoch()
        if cmd == "eval":
            return self.evaluate()
        if cmd == "state":
            return self.state()
        return self.summary()

    def _grad_step(self) -> Tuple[torch.Tensor, List]:
        """The epoch's forward, backward and gradient sum: (the summed flat
        gradient with the loss sum, correct count and loss count behind
        it, the new halo cache). No state changes."""
        cfg, wd, rnd, dev, epoch = self.cfg, self.wd, self.randomness, self.device, self.epoch
        if cfg.label_prop:
            sel = self._stacked(lambda s: rnd.lp_select(epoch, s, cfg.lp_rate, dev),
                                tuple(wd.train_mask.shape))
            prop_mask, loss_mask = M.lp_masks(sel, wd.train_mask)
        else:
            prop_mask, loss_mask = torch.zeros_like(wd.train_mask), wd.train_mask

        # The global loss count before the backward, so each rank's
        # gradient is its share of the global mean loss's.
        cnt_local = loss_mask.to(torch.float32).sum().reshape(1)
        denom = torch.clamp(self._allreduce("t.cnt", cnt_local)[0], min=1.0)
        params = tree_map(lambda p: p.detach().requires_grad_(True), self.params)
        logits, cache = self._forward(params, prop_mask, True, "t", self.cache, epoch)
        ls, correct, cnt = M.loss_and_metrics(logits, wd.labels, loss_mask)
        grads = _grads(ls.sum() / denom, params)

        vec = torch.cat([_flat(grads).detach(),
                         torch.stack([ls.sum(), correct.sum(), cnt.sum()]).detach()
                         .to(torch.float32)])
        return self._allreduce("t.grads", vec), cache

    def train_epoch(self) -> dict:
        self._before_epoch()
        t0 = time.perf_counter()
        launched0, gathers0 = launch_counts(), X.gather_counts()
        c0 = self._counters()
        gsum, cache = self._grad_step()
        host = gsum.cpu().numpy()
        grad_norm = float(np.sqrt(np.square(host[:-3], dtype=np.float64).sum()))
        grads = _unflat(gsum[:-3], self.params)
        gls, gcorrect, gcnt2 = (float(host[-3]), float(host[-2]), float(host[-1]))
        self.params, self.opt_state = adamw_update(grads, self.opt_state, self.params,
                                                   self.dc.lr)
        if self.schedule.uses_cache:
            self.cache = [tuple(c.detach() for c in layer) for layer in cache]
        self.epoch += 1
        self._sync()
        self._after_epoch()
        c1, now = self._counters(), launch_counts()
        return {"loss": gls / max(gcnt2, 1.0),
                "train_acc": gcorrect / max(gcnt2, 1.0),
                "epoch": self.epoch,
                "epoch_s": time.perf_counter() - t0,
                **{k: c1[k] - c0[k] for k in ("wait_s", "wire_s", "wire_bytes")},
                "grad_norm": grad_norm,
                "launches": {k: now[k] - launched0[k] for k in now},
                "send_gathers": {k: v - gathers0[k]
                                 for k, v in X.gather_counts().items()}}

    def evaluate(self) -> dict:
        launched0 = launch_counts()
        wd = self.wd
        prop = wd.train_mask if self.cfg.label_prop else torch.zeros_like(wd.train_mask)
        with torch.no_grad():
            logits, _ = self._forward(self.params, prop, False, "e", None, None)
            _, correct, cnt = M.loss_and_metrics(logits, wd.labels, wd.eval_mask)
            g = self._allreduce("e.metrics", torch.stack(
                [correct.sum(), cnt.sum()]).to(torch.float32)).cpu()
        now = launch_counts()
        return {"eval_acc": float(g[0]) / max(float(g[1]), 1.0),
                "launches": {k: now[k] - launched0[k] for k in now}}

    def state(self) -> dict:
        """This rank's parameters, AdamW state (step, mu, nu) and halo cache
        (``[rows, F]`` per delayed stage) as numpy, and its epoch."""
        out = {"params": _np(self.params),
               "opt_state": (self.opt_state.step, _np(self.opt_state.mu),
                             _np(self.opt_state.nu)),
               "epoch": self.epoch}
        if self.schedule.uses_cache:
            out["cache"] = [[c[0].cpu().numpy() for c in layer] for layer in self.cache]
        return out

    def summary(self) -> dict:
        out = {"rank": self.rank,
               "rss_before_attach": self.rss_before_attach,
               "rss_after_attach": self.rss_after_attach,
               "rss_after_slices": self.rss_after_slices,
               "rss_now": rss_bytes(),
               **self._counters()}
        if self.device.type == "cuda":
            out["device_bytes"] = torch.cuda.memory_allocated(self.device)
            out["device_peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
            out["device_reserved_bytes"] = torch.cuda.memory_reserved(self.device)
        return out

    def close(self) -> None:
        if self.arena is not None:
            self.arena.close()


class _RankWorker(_RankBase):
    """A multiproc rank: the wire is the shared-memory mailboxes.

    ``generation`` counts respawns of this rank (0 = the first spawn); a
    respawned rank attaches the existing segments, so a recovery costs one
    rank's start-up, not a rebuild. With a ``ckpt`` section in the
    manifest the rank snapshots its resumable state every ``every`` epochs
    into its own :class:`CheckpointManager` directory, and the parent's
    ``restore`` command winds it back to a step every rank holds.
    """

    COMMANDS = _RankBase.COMMANDS + ("restore",)

    def __init__(self, rank: int, nprocs: int, manifest: dict,
                 generation: int = 0):
        self.generation = generation
        self._chaos = _chaos_from_env(rank, generation)
        super().__init__(rank, nprocs, manifest)
        ck = manifest["meta"].get("ckpt")
        self.ckpt_every = int(ck["every"]) if ck else 0
        self.ckpt_mgr = (CheckpointManager(
            Path(ck["dir"]) / f"rank{rank}", keep=int(ck.get("keep", 3)))
            if ck else None)

    def _connect(self, manifest: dict) -> None:
        self.mb = Mailboxes.attach(manifest["mailbox"]["name"],
                                   manifest["mailbox"], self.rank,
                                   wait_timeout_s=_WORKER_WAIT_S)

    def _transport(self, op_base, spec, topo, rows, feat):
        return _StageExec(self.mb, op_base, spec, topo, self.rank, self.nprocs,
                          rows, feat, self.device, self.clock)

    def _counters(self) -> Dict[str, float]:
        return {"wait_s": self.mb.wait_s, "wire_s": self.clock["wire_s"],
                "wire_bytes": self.mb.bytes_written}

    # -- collectives outside autodiff --------------------------------------

    @_timed_wire
    def _allreduce(self, op: str, vec: torch.Tensor) -> torch.Tensor:
        v = np.ascontiguousarray(vec.detach().cpu().numpy(), dtype=np.float32)
        for d in range(self.nprocs):
            self.mb.post(op, d, v)
        out = np.zeros_like(v)
        for s in range(self.nprocs):
            out += self.mb.collect(op, s).view(np.float32)
        self.mb.complete(op)
        return torch.from_numpy(out).to(self.device)

    def _maybe_chaos(self) -> None:
        """Fire a pending fault injected through the environment."""
        if self._chaos is None or self.epoch != self._chaos["epoch"]:
            return
        if self._chaos["fault"] == "kill":
            os._exit(137)  # a simulated crash: no cleanup, no reply
        if self._chaos["fault"] == "stall":
            # A simulated hang: sleep without touching the mailbox, so this
            # rank's heartbeat freezes while the process stays alive.
            time.sleep(_CHAOS_STALL_S)

    def _before_epoch(self) -> None:
        self._maybe_chaos()

    def _after_epoch(self) -> None:
        self.mb.heartbeat()  # the optimizer's tail has no mailbox ops
        if (self.ckpt_mgr is not None and self.ckpt_every
                and self.epoch % self.ckpt_every == 0):
            self.ckpt_mgr.save(self._ckpt_state(), step=self.epoch,
                               meta={"epoch": self.epoch, "rank": self.rank})
            self.mb.heartbeat()

    def command(self, msg: dict) -> dict:
        if msg["cmd"] == "restore":
            return self.restore(msg.get("step"))
        return super().command(msg)

    # -- checkpoint / restore --------------------------------------------------

    def _ckpt_state(self) -> dict:
        """The resumable state: parameters, AdamW state and (delayed
        schedules) the per-stage halo cache, as ``[rows, F]`` per stage
        like the JAX package's rank checkpoints. Every per-epoch draw
        derives from the epoch number and the gradient sum runs in rank
        order on every rank, so restoring this at epoch E reproduces the
        uninterrupted trajectory bit for bit from E on."""
        state = {"params": self.params, "opt_state": self.opt_state}
        if self.schedule.uses_cache:
            state["cache"] = [tuple(c[0] for c in layer) for layer in self.cache]
        return state

    def restore(self, step: Optional[int]) -> dict:
        """Wind back to checkpoint ``step`` (or start afresh when None or
        no directory is configured) and forget the per-op mailbox counts:
        the rank's half of the parent's recovery, whose ``reset_counts``
        zeroed the shared words while the fleet was quiet."""
        self.mb.reset_local()
        if self.ckpt_mgr is not None and step is not None:
            state, manifest = restore_train_state(self.ckpt_mgr.path_for(step),
                                                  self._ckpt_state())
            self.params = state["params"]
            self.opt_state = state["opt_state"]
            if self.schedule.uses_cache:
                self.cache = [tuple(c[None] for c in layer) for layer in state["cache"]]
            self.epoch = int(manifest.get("meta", {}).get("epoch", step))
        else:
            self._reinit()
        return {"epoch": self.epoch}

    def close(self) -> None:
        self.mb.close()
        super().close()


def _safe_send(conn, msg: dict) -> bool:
    try:
        conn.send(msg)
        return True
    except (OSError, ValueError, BrokenPipeError):
        return False  # the parent is gone; the caller unwinds


def _worker_entry(rank: int, nprocs: int, manifest: dict, conn,
                  generation: int = 0, worker_cls=None) -> None:
    """A spawned rank: pin, attach the shared store, serve commands.
    ``worker_cls`` builds the rank (:class:`_RankWorker` by default, with
    its ``generation``; a class of another mode takes no generation).

    A command's exception is classified (``_transport_kind``) instead of
    ending the rank: a RECOVER flag means the parent runs a recovery, so
    the rank replies ``{"status": "recover"}`` and waits for the restore
    command; a real error or a mailbox timeout is reported and the rank
    stays alive for the supervisor to decide (respawn by kill, or abort by
    closing the pipe). Only an abort flag or a lost parent ends the loop.
    """
    worker = None
    try:
        _pin(rank, nprocs)
        worker = (_RankWorker(rank, nprocs, manifest, generation=generation)
                  if worker_cls is None else worker_cls(rank, nprocs, manifest))
        conn.send({"status": "ok", **worker.summary()})
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                break
            cmd = msg.get("cmd")
            try:
                if cmd == "stop":
                    break
                if cmd not in worker.COMMANDS:
                    _safe_send(conn, {"status": "error",
                                      "error": f"unknown command {cmd!r}"})
                    break
                rep = {"status": "ok", **worker.command(msg)}
                if not _safe_send(conn, rep):
                    break
            except Exception as e:  # noqa: BLE001 — classify, don't die
                kind = _transport_kind(e)
                if kind == "recover":
                    if not _safe_send(conn, {"status": "recover"}):
                        break
                    continue
                detail = (f"{type(e).__name__}: {e}" if kind else
                          f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
                if not _safe_send(conn, {"status": "error", "error": detail}):
                    break
                if kind == "abort":
                    break
    except Exception as e:  # noqa: BLE001 — report, don't hang the parent
        _safe_send(conn, {"status": "error",
                          "error": f"{type(e).__name__}: {e}\n{traceback.format_exc()}"})
    finally:
        if worker is not None:
            worker.close()
        try:
            conn.close()
        except OSError:
            pass


# --------------------------------------------------------------------------
# Parent runtime
# --------------------------------------------------------------------------


def _add_ell(arrays: Dict[str, np.ndarray], prefix: str, stacked) -> List[int]:
    ks = []
    for i, (k, rows, idx, w) in enumerate(stacked):
        arrays[f"{prefix}.{i}.rows"] = rows
        arrays[f"{prefix}.{i}.idx"] = idx
        arrays[f"{prefix}.{i}.w"] = w
        ks.append(int(k))
    return ks


def _add_plan(arrays: Dict[str, np.ndarray], prefix: str, hp,
              max_owned: int) -> dict:
    for f in _PLAN_FIELDS:
        arrays[f"plan.{prefix}.{f}"] = getattr(hp, f)
    layouts = dict(zip(("sell", "sellt"), host_send_bucketed(hp, max_owned)))
    layouts.update(zip(("pell", "pellt"), host_pre_bucketed(hp, max_owned)))
    layouts.update(zip(("rell", "rellt"), host_recv_bucketed(hp, max_owned)))
    return {f"{key}_ks": _add_ell(arrays, f"plan.{prefix}.{key}", stacked)
            for key, stacked in layouts.items()}


def _arena_arrays(hwd) -> Tuple[Dict[str, np.ndarray], dict]:
    """(shared-store array dict, manifest meta) of a HostWorkerData."""
    arrays: Dict[str, np.ndarray] = {
        "x": hwd.x, "labels": hwd.labels, "train_mask": hwd.train_mask,
        "eval_mask": hwd.eval_mask, "owned_mask": hwd.owned_mask,
        "coo_src": hwd.coo_src, "coo_dst": hwd.coo_dst, "coo_w": hwd.coo_w,
    }
    meta: dict = {
        "ell_ks": _add_ell(arrays, "ell", hwd.ell_stacked),
        "ellt_ks": _add_ell(arrays, "ellt", hwd.ell_t_stacked),
        "plans": {}, "max_owned": int(hwd.max_owned),
    }
    if hwd.hier_plan is not None:
        for level in ("intra", "inter"):
            hp = getattr(hwd.hier_plan, level)
            meta["plans"][level] = _add_plan(arrays, level, hp, hwd.max_owned)
        meta["wire_rows"] = {
            level: int(getattr(hwd.hier_plan, level).send_gather_idx.shape[-1])
            for level in ("intra", "inter")}
    else:
        meta["plans"]["flat"] = _add_plan(arrays, "flat", hwd.plan, hwd.max_owned)
        meta["wire_rows"] = {"flat": int(hwd.plan.send_gather_idx.shape[-1])}
    return arrays, meta


class _WorkerFailure(Exception):
    """Detection signal: ranks failed (dead / hung / failing) while the
    parent waited on the ``pending`` ranks' replies."""

    def __init__(self, ranks: Sequence[int], kind: str,
                 pending: Sequence[int] = (), detect_s: float = 0.0,
                 errors: Optional[Dict[int, str]] = None):
        self.ranks = sorted(set(ranks))
        self.kind = kind
        self.pending = sorted(set(pending) - set(ranks))
        self.detect_s = detect_s
        self.errors = errors or {}
        super().__init__(f"ranks {self.ranks} {kind}")


class _Fleet:
    """The parent's control plane over one spawned process per rank, shared
    by :class:`MultiprocRuntime` and ``launch.spmd.ShardMapRuntime``:
    spawning (the ``spawn`` start method, the thread env partitioned across
    the ranks), the command pipes, gathering one reply per rank while
    telling dead, hung and failing ranks apart, and the teardown of the
    processes and the shared-memory segments. The subclass sets the state
    :meth:`_init_fleet` names, builds ``_manifest`` and says which rank
    class its processes run (``_worker_cls``; None is multiproc's)."""

    mode = "multiproc"
    _worker_cls = None

    def _init_fleet(self) -> None:
        self._started = False
        self._procs: List = []
        self._conns: List = []
        self._arena: Optional[ShmArena] = None
        self._mb: Optional[Mailboxes] = None
        self._generation = 0
        self._manifest: Optional[dict] = None
        self._ctx = None
        self._signals_installed = False
        # Ranks that completed a supervised command since their (re)spawn:
        # only they get the tight heartbeat_s hang deadline.
        self._warm_ranks: set = set()

    def _spawn_rank(self, r: int) -> None:
        """Spawn (or respawn) one rank against the published segments, with
        the thread env partitioned across the ranks."""
        threads = max(1, (os.cpu_count() or 1) // self.nprocs)
        saved = {k: os.environ.get(k) for k in _THREAD_ENV}
        for k in _THREAD_ENV:
            os.environ[k] = str(threads)
        try:
            parent_conn, child_conn = self._ctx.Pipe()
            p = self._ctx.Process(
                target=_worker_entry,
                args=(r, self.nprocs, self._manifest, child_conn, self._generation,
                      self._worker_cls),
                daemon=True)
            p.start()
            child_conn.close()
            self._procs[r] = p
            self._conns[r] = parent_conn
            self._warm_ranks.discard(r)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    def _install_signal_cleanup(self) -> None:
        """SIGINT and SIGTERM stop the fleet and unlink both segments
        before the default disposition runs (atexit alone never runs on
        SIGTERM); chained to any handler installed before."""
        if self._signals_installed:
            return
        for sig in (signal.SIGINT, signal.SIGTERM):
            prev = signal.getsignal(sig)

            def _handler(signum, frame, prev=prev):
                self.close(force=True)
                if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
                    prev(signum, frame)
                else:
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            try:
                signal.signal(sig, _handler)
            except ValueError:
                return  # not the main thread; atexit still covers the segments
        self._signals_installed = True

    def _abort(self, msg: str) -> None:
        if self._mb is not None:
            self._mb.abort()
        self.close(force=True)
        raise RuntimeError(f"{self.mode} run aborted: {msg}")

    def _gather(self, timeout: float, what: str,
                ranks: Optional[Sequence[int]] = None, hb_s: float = 0.0,
                ok_status: Tuple[str, ...] = ("ok",),
                fail_fast: bool = False) -> Dict[int, dict]:
        """Collect one reply per rank; raise :class:`_WorkerFailure` as soon
        as an awaited rank proves dead, hung (heartbeat frozen past
        ``hb_s``; 0 disables) or failing (a reply outside ``ok_status``:
        after every reply is in, or with ``fail_fast`` at once, when the
        other ranks may be blocked on the failed one for good)."""
        ranks = list(range(self.nprocs)) if ranks is None else list(ranks)
        t0 = time.monotonic()
        deadline = t0 + timeout
        replies: Dict[int, dict] = {}
        pending = set(ranks)
        hb_last: Dict[int, Tuple[int, float]] = {}
        if hb_s > 0 and self._mb is not None:
            hbs = self._mb.heartbeats()
            hb_last = {r: (hbs[r], t0) for r in pending if r < len(hbs)}

        def fail(rs, kind):
            raise _WorkerFailure(rs, kind, pending=pending,
                                 detect_s=time.monotonic() - t0)

        while pending:
            for r in sorted(pending):
                try:
                    if self._conns[r] is not None and self._conns[r].poll(0.05):
                        replies[r] = self._conns[r].recv()
                        pending.discard(r)
                        if fail_fast and replies[r].get("status") not in ok_status:
                            raise _WorkerFailure(
                                [r], "failing", pending=pending,
                                detect_s=time.monotonic() - t0,
                                errors={r: str(replies[r].get("error", "no detail"))})
                except (EOFError, OSError):
                    fail([r], "dead")
            dead = [r for r in pending
                    if self._procs[r] is None or not self._procs[r].is_alive()]
            if dead:
                fail(dead, "dead")
            if hb_last:
                now = time.monotonic()
                hbs = self._mb.heartbeats()
                hung = []
                for r in sorted(pending & set(hb_last)):
                    v, t = hb_last[r]
                    limit = hb_s if r in self._warm_ranks else max(hb_s, _COLD_GRACE_S)
                    if hbs[r] != v:
                        hb_last[r] = (hbs[r], now)
                    elif now - t > limit:
                        hung.append(r)
                if hung:
                    fail(hung, "hung")
            if time.monotonic() > deadline:
                fail(sorted(pending), "hung")
        bad = [r for r in ranks if replies[r].get("status") not in ok_status]
        if bad:
            raise _WorkerFailure(
                bad, "failing", detect_s=time.monotonic() - t0,
                errors={r: str(replies[r].get("error", "no detail")) for r in bad})
        return replies

    def _send(self, msg: dict, what: str, ranks: Sequence[int]) -> None:
        sent: List[int] = []
        for r in ranks:
            try:
                self._conns[r].send(msg)
            except (BrokenPipeError, OSError, AttributeError):
                raise _WorkerFailure([r], "dead", pending=sent)
            sent.append(r)

    def close(self, force: bool = False) -> None:
        if self._conns and not force:
            for c in self._conns:
                if c is None:
                    continue
                try:
                    c.send({"cmd": "stop"})
                except (BrokenPipeError, OSError, ValueError):
                    pass
        for p in self._procs:
            if p is not None:
                p.join(timeout=2.0 if force else 15.0)
        for p in self._procs:
            if p is not None and p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        for c in self._conns:
            if c is None:
                continue
            try:
                c.close()
            except OSError:
                pass
        self._procs, self._conns = [], []
        for seg in (self._mb, self._arena):
            if seg is not None:
                seg.close()
        self._mb = self._arena = None
        self._started = False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def fit(self, epochs: int, log_every: int = 0) -> List[Dict]:
        history = []
        # A recovery winds self.epoch back to the restored checkpoint, and
        # the epochs trained again must still end the run at ``epochs``.
        while self.epoch < epochs:
            m = self.train_epoch()
            if log_every and (self.epoch % log_every == 0 or self.epoch == epochs):
                m["eval_acc"] = self.evaluate()
                m["epoch"] = self.epoch
                history.append(m)
        return history


class MultiprocRuntime(_Fleet):
    """P processes over one shared graph store, with a fault-tolerant
    supervisor: the trainer-shaped runtime behind ``exec.mode="multiproc"``.

    ``device`` is where every rank computes ("cuda": all ranks share the
    card, each with its own context; "cpu" runs the kernels' plain
    versions). ``params`` (a tree of tensors) and ``randomness`` default to
    the stacked trainer's: parameters drawn from ``exec.seed`` and a
    :class:`GeneratorRandomness` seeded from it. ``randomness`` must pickle
    (it rides in each rank's spawn manifest).

    Lazy: the store is published and the ranks spawn on the first train or
    eval command, so :meth:`dry_plan` costs no process. On the card the
    parent builds the kernels before it spawns, so the ranks do not each
    start ``nvcc``.

    Supervision: while it waits on a command's replies, the parent tells a
    **dead** rank (exit code, hung-up pipe), a **hung** rank (its heartbeat
    word frozen past ``exec.heartbeat_s`` while the process lives) and a
    **failing** rank (an error reply) apart. On any of these it runs the
    recovery: it sets the mailbox control word to RECOVER so blocked
    survivors unwind to their command loop, drains their replies, kills
    and respawns the lost ranks against the existing segments, zeroes the
    wire counters, restores every rank from the newest checkpoint step all
    ranks hold (:meth:`configure_ckpt`) and retries the command. After
    ``exec.max_restarts`` recoveries it aborts cleanly: survivors released
    through the abort flag, the fleet terminated, both segments unlinked,
    the checkpoints left on disk, and ``RuntimeError`` raised. Each
    recovery is appended to ``recovery_events`` (kind, ranks, detection
    latency, restore step), which the chaos harness reports.
    """

    def __init__(self, spec, hwd, device="cuda", params=None, randomness=None):
        self.spec = spec
        refuse_gat(spec.model.model, mode="multiproc")
        self.nprocs = spec.exec.nprocs or spec.partition.nparts
        if self.nprocs != spec.partition.nparts:
            raise ValueError(
                f"multiproc runs one process per partition: nprocs "
                f"{self.nprocs} != partition.nparts {spec.partition.nparts}")
        self.device = str(device)
        self.dc = spec.schedule.to_dist_config(spec.partition, lr=spec.exec.lr)
        self.schedule = self.dc.schedule()
        self.cfg = spec.model.to_gcn_config(spec.graph, spec.schedule)
        self.epoch = 0
        self.epoch_stats: List[dict] = []
        self.token: Optional[str] = None
        self._arrays, self._meta = _arena_arrays(hwd)
        if params is None:
            params = M.init_params(self.cfg,
                                   torch.Generator().manual_seed(spec.exec.seed))
            self._params = None  # each rank draws the same from exec.seed
        else:
            self._params = tree_map(lambda t: t.detach().cpu().numpy(), params)
        nparams = sum(t.numel() for t in tree_leaves(params))
        self._randomness = (randomness if randomness is not None
                            else GeneratorRandomness(spec.exec.seed))
        feat_dims = self.cfg.dims()[: self.cfg.num_layers]
        self._eval_schedule = self.dc.sync_fp32().schedule()
        self._op_table = build_op_table(
            self.schedule, self._eval_schedule, self.nprocs,
            self.cfg.num_layers, feat_dims, self._meta["wire_rows"], nparams)
        self._meta.update(nparams=nparams, feat_dims=list(feat_dims))
        self._init_fleet()
        self.ready_stats: List[dict] = []
        self.eval_launches: List[dict] = []  # per rank, of the last evaluate
        # Supervision state
        self.restarts = 0
        self.recovery_events: List[dict] = []
        self._recovering = False
        self._ckpt: Optional[dict] = None

    # -- checkpoint configuration ------------------------------------------

    def configure_ckpt(self, directory, every: int = 1, keep: int = 3) -> None:
        """Point the fleet at a checkpoint directory (per-rank directories
        ``rank{r}/``), snapshotting every ``every`` epochs. Must run before
        the first command spawns the ranks: the directory rides in the
        spawn manifest."""
        if self._started:
            raise RuntimeError("configure_ckpt must be called before the fleet starts")
        self._ckpt = {"dir": str(directory), "every": int(every), "keep": int(keep)}

    def _rank_managers(self) -> Dict[int, CheckpointManager]:
        assert self._ckpt is not None
        return {r: CheckpointManager(Path(self._ckpt["dir"]) / f"rank{r}",
                                     keep=self._ckpt["keep"])
                for r in range(self.nprocs)}

    def _latest_common_step(self) -> Optional[int]:
        if self._ckpt is None:
            return None
        return latest_common_step(self._rank_managers())

    def restore_from_ckpt(self) -> int:
        """Resume: restore every rank from the newest step all ranks hold a
        valid checkpoint for. Aborts cleanly (fleet down, segments
        unlinked) when there is no such step."""
        if self._ckpt is None:
            raise RuntimeError("restore_from_ckpt needs configure_ckpt first "
                               "(no checkpoint directory)")
        self._ensure_started()
        step = self._latest_common_step()
        if step is None:
            self._abort("resume requested but no checkpoint step is valid "
                        f"on every rank under {self._ckpt['dir']}")
        try:
            self._send({"cmd": "restore", "step": step}, "restore",
                       range(self.nprocs))
            reps = self._gather(_PARENT_WAIT_S, "restore")
        except _WorkerFailure as f:
            self._abort(f"restore failed: {f}")
        self.epoch = int(reps[0]["epoch"])
        return step

    # -- lifecycle -----------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._started:
            return
        if torch.device(self.device).type == "cuda":
            from repro_torch.kernels.build import build_all
            build_all()
        self.token = run_token()
        self._arena, self._mb, frag = publish_store(
            self.token, self._arrays, self._op_table, nprocs=self.nprocs)
        meta = dict(self._meta)
        if self._ckpt is not None:
            meta["ckpt"] = self._ckpt
        self._manifest = {"spec": self.spec.to_dict(), "meta": meta,
                          "device": self.device, "randomness": self._randomness,
                          "params": self._params, **frag}
        self._ctx = mp.get_context("spawn")
        self._procs = [None] * self.nprocs
        self._conns = [None] * self.nprocs
        for r in range(self.nprocs):
            self._spawn_rank(r)
        self._started = True
        self._install_signal_cleanup()
        try:
            reps = self._gather(_PARENT_WAIT_S, "startup")
        except _WorkerFailure as f:
            self._abort(f"startup failed: {f}"
                        + "".join(f"\n  rank {r}: {e}" for r, e in f.errors.items()))
        self.ready_stats = [reps[r] for r in range(self.nprocs)]

    # -- detection and recovery ------------------------------------------------

    def _command(self, msg: dict, what: str, timeout: float = _PARENT_WAIT_S,
                 supervised: bool = False) -> List[dict]:
        """Send ``msg`` to every rank and gather the replies; with
        ``supervised``, a detected failure runs the recovery and the
        command is retried from the restored state."""
        self._ensure_started()
        hb_s = float(self.spec.exec.heartbeat_s) if supervised else 0.0
        while True:
            try:
                self._send(msg, what, range(self.nprocs))
                reps = self._gather(timeout, what, hb_s=hb_s)
                self._warm_ranks.update(range(self.nprocs))
                return [reps[r] for r in range(self.nprocs)]
            except _WorkerFailure as f:
                if not supervised:
                    self._abort(f"{f} during {what}"
                                + "".join(f"\n  rank {r}: {e}"
                                          for r, e in f.errors.items()))
                self._handle_failure(f, what)

    def _handle_failure(self, f: _WorkerFailure, what: str) -> None:
        """The recovery (see the class docstring). Raises through
        :meth:`_abort` once the restart budget is spent, or when the
        recovery itself meets another failure."""
        if self._recovering:
            self._abort(f"nested failure during recovery: {f}")
        if self._ckpt is None:
            # Nothing to resume from: a respawn would silently restart
            # training at epoch 0, so fail fast and unlink every segment.
            self._abort(
                f"ranks {f.ranks} {f.kind} during {what} and no checkpoint "
                f"directory is configured (pass ckpt_dir / --ckpt-dir to "
                f"enable recovery)"
                + "".join(f"\n  rank {r}: {e}" for r, e in f.errors.items()))
        self.restarts += 1
        event = {"epoch": self.epoch, "during": what, "ranks": f.ranks,
                 "kind": f.kind, "detect_s": round(f.detect_s, 3),
                 "restarts": self.restarts}
        if self.restarts > self.spec.exec.max_restarts:
            self.recovery_events.append({**event, "action": "abort"})
            self._abort(
                f"ranks {f.ranks} {f.kind} during {what}; restart budget "
                f"exhausted (max_restarts={self.spec.exec.max_restarts})"
                + "".join(f"\n  rank {r}: {e}" for r, e in f.errors.items()))
        self._recovering = True
        t_recover = time.monotonic()
        try:
            failed = set(f.ranks)
            # 1. Quiesce: survivors blocked on the wire unwind through the
            #    RECOVER control word and reply; drain until every pending
            #    survivor has replied (ok / recover / error) or failed too.
            self._mb.recover()
            drain = set(f.pending) - failed
            while drain:
                try:
                    self._gather(_RECOVER_DRAIN_S, "recovery drain",
                                 ranks=sorted(drain),
                                 ok_status=("ok", "recover", "error"))
                    drain = set()
                except _WorkerFailure as f2:
                    failed |= set(f2.ranks)
                    drain = set(f2.pending) - failed
            # 2. Reap the failed ranks (a kill of the dead is harmless).
            for r in sorted(failed):
                p = self._procs[r]
                if p is not None:
                    p.kill()
                    p.join(timeout=10.0)
                if self._conns[r] is not None:
                    try:
                        self._conns[r].close()
                    except OSError:
                        pass
            # 3. The wire is quiet: zero every seq, heartbeat and control word.
            self._mb.reset_counts()
            # 4. Respawn against the existing segments (nothing republished).
            self._generation += 1
            t_respawn = time.monotonic()
            for r in sorted(failed):
                self._spawn_rank(r)
            self._gather(_PARENT_WAIT_S, "respawn startup", ranks=sorted(failed))
            respawn_s = time.monotonic() - t_respawn
            # 5. Every rank restores the newest common valid checkpoint
            #    (None: from scratch at epoch 0).
            t_restore = time.monotonic()
            step = self._latest_common_step()
            self._send({"cmd": "restore", "step": step}, "restore", range(self.nprocs))
            reps = self._gather(_PARENT_WAIT_S, "restore")
            self.epoch = int(reps[0]["epoch"])
            self.recovery_events.append({
                **event, "action": "respawn", "respawned": sorted(failed),
                "restore_step": step, "resume_epoch": self.epoch,
                "respawn_s": round(respawn_s, 3),
                "restore_s": round(time.monotonic() - t_restore, 3),
                "recover_s": round(time.monotonic() - t_recover, 3)})
        except _WorkerFailure as f2:
            self._abort(f"recovery from ({f}) failed: {f2}")
        finally:
            self._recovering = False

    # -- trainer-shaped interface -------------------------------------------

    def train_epoch(self) -> Dict[str, float]:
        reps = self._command({"cmd": "epoch"}, "train epoch", supervised=True)
        # The ranks own the epoch counter (a recovery during the command
        # winds it back to the restored step); the parent mirrors it.
        self.epoch = int(reps[0]["epoch"])
        self.epoch_stats.append({
            "epoch": self.epoch,
            "epoch_s": max(r["epoch_s"] for r in reps),
            "wait_s": [r["wait_s"] for r in reps],
            "wire_s": [r["wire_s"] for r in reps],
            "wire_bytes": [r["wire_bytes"] for r in reps],
            "grad_norm": float(reps[0]["grad_norm"]),
            "launches": [r["launches"] for r in reps],
            "send_gathers": [r["send_gathers"] for r in reps]})
        return {"loss": float(reps[0]["loss"]),
                "train_acc": float(reps[0]["train_acc"]),
                "epoch_s": float(self.epoch_stats[-1]["epoch_s"])}

    def evaluate(self) -> float:
        reps = self._command({"cmd": "eval"}, "evaluate", supervised=True)
        self.eval_launches = [r["launches"] for r in reps]
        return float(reps[0]["eval_acc"])

    def summary(self) -> dict:
        out = {"mode": "multiproc", "nprocs": self.nprocs, "device": self.device,
               "token": self.token, "parent_rss": rss_bytes(),
               "epoch_stats": self.epoch_stats, **self.dry_plan()}
        if self._started:
            out["ranks"] = self._command({"cmd": "summary"}, "summary")
        return out

    def dry_plan(self) -> dict:
        """Store and mailbox accounting without publishing segments or
        spawning processes."""
        table, total = ShmArena.layout(self._arrays)
        layout = plan_mailbox(self._op_table, nprocs=self.nprocs)
        return {"store_bytes": int(total), "store_arrays": len(table),
                "mailbox_bytes": int(layout["bytes"]),
                "mailbox_ops": len(self._op_table)}

    def lower_step(self, *args, **kwargs):
        raise NotImplementedError(
            "mode='multiproc' runs eagerly across processes; there is no "
            "single lowered step")
