"""Full-batch GCN training (Fig 2): single-device and distributed.

Counterpart of ``repro/core/trainer.py``. Two paths:

* **Single device** (``train_gcn_single`` and its parts): the whole graph
  on one device, one training step per epoch. Every model aggregates over
  the degree-bucketed layout (``prepare_single(layouts=("bucketed",))``),
  so on the card the ``seg_aggregate`` kernel runs the forward over
  ``ell`` and the backward over the reverse graph's ``ell_t``. The JAX
  package trains gcn/sage/gin over the dense max-degree ELL instead; both
  layouts hold each row's neighbours in CSR order, so the values agree to
  fp32 rounding, and the bucketed one pads at most 2x nnz where the dense
  one pads rows x max degree on power-law graphs.
* **Distributed, stacked on one device** (``DistributedTrainer``), as the
  JAX package's ``mode="vmap"`` runs it: the P workers of the distributed
  step sit on a leading axis of every tensor, and every collective is a
  tensor operation over that axis (``core.exchange``). Per epoch:
  masked-LP feature assembly -> per layer [LayerNorm -> dropout -> halo
  exchange ``issue`` -> local bucketed aggregation -> ``finalize`` ->
  UPDATE] -> masked CE loss -> gradients -> AdamW.

The distributed gradient follows the JAX package's, including a factor.
Under ``vmap`` its ``psum(grads)`` (``trainer.py:534``) returns P times the
gradient of the global mean loss (ROADMAP C-ref6), so the port
backpropagates ``P * loss``. P is the worker count; for the paper's
P = 8 the scaling is exact in fp32.

A run's state (parameters, AdamW state and, for delayed-exchange
schedules, the halo cache) checkpoints into the JAX package's npz format
(``DistributedTrainer.train_state``); every random draw derives from the
epoch number, so a resumed run reproduces the uninterrupted one bit for
bit.

``exec.mode="multiproc"`` (one process per worker) is
``repro_torch.launch.multiproc``, which runs this module's pieces at
P = 1 in each rank. Refused (they raise): ``exec.mode="shard_map"`` (one
card holds no mesh), ``lower_step`` (not ported yet), and distributed
GAT, which the JAX package cannot train either (ROADMAP C-ref7).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import model as M
from repro_torch.core.exchange import (
    DeviceHaloPlan,
    DeviceHierPlan,
    ExchangeSchedule,
    _index_add,
    _take,
    stack_halo_plan,
    stack_hier_plan,
)
from repro_torch.core.layers import gat_aggregate, gat_aggregate_bucketed
from repro_torch.core.randomness import GeneratorRandomness
from repro_torch.graph.remote import (
    HierPartitionedGraph,
    build_halo_plan,
    build_hier_halo_plan,
)
from repro_torch.graph.structure import (
    Graph,
    bucketed_ell_from_csr,
    ell_from_csr,
    stack_bucketed_ells,
    transpose_csr,
)
from repro_torch.kernels.ops import aggregate
from repro_torch.kernels.seg_aggregate import (
    DeviceBucketedEll,
    bucketed_aggregate,
    device_bucketed,
)
from repro_torch.optim.adamw import adamw_init, adamw_update, tree_leaves, tree_map

# Hierarchical schedules default the slow inter-group wire to Int2 when the
# base ``bits`` is fp32, as in the JAX package.
HIER_INTER_BITS_DEFAULT = 2

NOT_PORTED = "is not ported to PyTorch yet (ROADMAP queue A); use the JAX package"

SHARD_MAP_REFUSED = (
    "exec.mode='shard_map' needs a mesh of devices, and one card holds none; "
    "the port's multi-worker modes are 'vmap' (all workers stacked on the "
    "card) and 'multiproc' (one process per worker, sharing the card through "
    "host mailboxes); ROADMAP A2 decided to keep refusing shard_map")

GAT_NOT_DISTRIBUTED = (
    "model 'gat' does not train distributed: the JAX package's distributed "
    "GAT raises a broadcasting error (ROADMAP C-ref7: its layer takes the "
    "halo aggregation for the attention output); train GAT on one device "
    "with train_gcn_single, or serve it")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device without a
    card, and keeps the dense products in full fp32 on the card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r}: no CUDA card is available (pass "
                "device='cpu' to run the plain PyTorch path)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


# --------------------------------------------------------------------------
# Single-device path
# --------------------------------------------------------------------------


class SingleGraphData(NamedTuple):
    """One graph's arrays on the device."""

    x: torch.Tensor           # [N, F]
    labels: torch.Tensor      # [N] int64
    train_mask: torch.Tensor  # [N] bool
    eval_mask: torch.Tensor   # [N] bool
    ell_idx: torch.Tensor     # [N, max degree] int32 dense ELL (or [N, 1] zeros)
    ell_w: torch.Tensor       # [N, max degree] f32
    ell_valid: torch.Tensor   # [N, max degree] bool
    # The shared degree-bucketed layout and the reverse graph's, which
    # drives the backward: every model's aggregation consumes it.
    ell: Optional[DeviceBucketedEll] = None
    ell_t: Optional[DeviceBucketedEll] = None


def prepare_single(g: Graph, x: np.ndarray, eval_mask: Optional[np.ndarray] = None,
                   norm: str = "mean",
                   layouts: Tuple[str, ...] = ("dense", "bucketed"),
                   device="cuda") -> SingleGraphData:
    """``layouts`` trims the prepared neighbour layouts: "dense" is the
    max-degree ELL (``make_single_agg_fn(use_kernel=True)``; its padding
    blows up as rows x max degree on power-law graphs), "bucketed" the
    degree-bucketed layout with its reverse (every model's training
    path). The default builds both, as the JAX package's does;
    ``train_gcn_single`` builds the bucketed one only."""
    dev = resolve_device(device)
    gn = g.gcn_normalized() if norm == "gcn" else g.mean_normalized()
    csr = gn.csr_by_dst()
    train = g.train_mask if g.train_mask is not None else np.ones(g.num_nodes, bool)
    if eval_mask is None:
        eval_mask = ~train
    if "dense" in layouts:
        idx, w, valid = ell_from_csr(csr)
    else:
        idx = np.zeros((g.num_nodes, 1), np.int32)
        w = np.zeros((g.num_nodes, 1), np.float32)
        valid = np.zeros((g.num_nodes, 1), bool)
    ell = ell_t = None
    if "bucketed" in layouts:
        ell = device_bucketed(stack_bucketed_ells([bucketed_ell_from_csr(csr)]),
                              device=dev)
        ell_t = device_bucketed(
            stack_bucketed_ells([bucketed_ell_from_csr(transpose_csr(csr))]),
            device=dev)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    return SingleGraphData(
        x=t(x, torch.float32), labels=t(g.labels, torch.int64),
        train_mask=t(train, torch.bool), eval_mask=t(eval_mask, torch.bool),
        ell_idx=t(idx, torch.int32), ell_w=t(w, torch.float32),
        ell_valid=t(valid, torch.bool), ell=ell, ell_t=ell_t)


def make_single_agg_fn(cfg: M.GCNConfig, data: SingleGraphData, params_getter,
                       use_kernel: bool = False):
    """``agg_fn(layer, h)`` over the whole graph.

    GAT: its attention layer, over the bucketed layout when prepared,
    else over the dense ELL. The linear models: the bucketed layout,
    differentiable (the kernel both ways on the card); with
    ``use_kernel``, or without a bucketed layout, the dense ELL through
    ``ops.aggregate`` (one kernel launch on the card, forward only), as
    the JAX package's ``use_kernel`` path.
    """
    def agg_fn(l: int, h: torch.Tensor) -> torch.Tensor:
        if cfg.model == "gat":
            p = params_getter()["layers"][l]
            if data.ell is not None:
                return gat_aggregate_bucketed(p, h, data.ell, h.shape[0],
                                              cfg.gat_heads)
            return gat_aggregate(p, h, data.ell_idx, data.ell_valid, cfg.gat_heads)
        if data.ell is not None and not use_kernel:
            return bucketed_aggregate(h, data.ell, ell_t=data.ell_t)
        return aggregate(h, data.ell_idx, data.ell_w)
    return agg_fn


def _grads(loss: torch.Tensor, params):
    """d loss / d params as a tree like ``params`` (zeros where unused)."""
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    return tree_map(lambda _: next(it), params)


def single_train_step(params, opt_state, cfg: M.GCNConfig, data: SingleGraphData,
                      randomness, epoch: int, lr: float = 0.01):
    """One full-graph step: (params, opt_state, {"loss", "train_acc"}).

    ``randomness`` draws epoch ``epoch``'s label-propagation selection
    (shape ``[N]``) and dropout masks (``[N, F]`` per layer) by name
    (``core.randomness``); the JAX package derives them from
    ``PRNGKey(seed * 100003 + epoch)``."""
    dev = data.x.device
    if cfg.label_prop:
        sel = randomness.lp_select(epoch, tuple(data.train_mask.shape), cfg.lp_rate, dev)
        prop_mask, loss_mask = M.lp_masks(sel, data.train_mask)
    else:
        prop_mask, loss_mask = torch.zeros_like(data.train_mask), data.train_mask
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    keep = lambda l, shape: randomness.dropout_keep(epoch, l, shape,
                                                    1.0 - cfg.dropout, dev)
    logits = M.forward(p, cfg, data.x, data.labels, prop_mask,
                       make_single_agg_fn(cfg, data, lambda: p), dropout_keep=keep)
    ls, correct, cnt = M.loss_and_metrics(logits, data.labels, loss_mask)
    cnt = torch.clamp(cnt, min=1.0)
    loss = ls / cnt
    params, opt_state = adamw_update(_grads(loss, p), opt_state, params, lr)
    return params, opt_state, {"loss": loss.detach(), "train_acc": correct / cnt}


def single_eval(params, cfg: M.GCNConfig, data: SingleGraphData) -> float:
    """Eval accuracy: every train label propagated, scored on eval nodes."""
    prop = data.train_mask if cfg.label_prop else torch.zeros_like(data.train_mask)
    with torch.no_grad():
        logits = M.forward(params, cfg, data.x, data.labels, prop,
                           make_single_agg_fn(cfg, data, lambda: params))
        _, correct, cnt = M.loss_and_metrics(logits, data.labels, data.eval_mask)
        return float(correct / torch.clamp(cnt, min=1.0))


def train_gcn_single(g: Graph, x: np.ndarray, cfg: M.GCNConfig, epochs: int,
                     lr: float = 0.01, seed: int = 0, log_every: int = 0,
                     device="cuda", params: Optional[Dict] = None,
                     randomness=None):
    """Train ``cfg`` on the whole graph ``g`` on ``device`` (the card
    unless the caller asks for the CPU; raises if the card is missing).
    ``params`` default to ``M.init_params`` drawn from ``seed``,
    ``randomness`` to :class:`GeneratorRandomness` seeded from ``seed``.
    Returns (params, history), history holding the loss and eval accuracy
    every ``log_every`` epochs and at the last."""
    dev = resolve_device(device)
    data = prepare_single(g, x, layouts=("bucketed",), device=dev)
    if params is None:
        params = M.init_params(cfg, torch.Generator().manual_seed(seed))
    params = M.to_device(params, dev)
    opt_state = adamw_init(params)
    randomness = randomness if randomness is not None else GeneratorRandomness(seed)
    history = []
    for e in range(epochs):
        params, opt_state, m = single_train_step(params, opt_state, cfg, data,
                                                 randomness, e, lr)
        if log_every and (e % log_every == 0 or e == epochs - 1):
            history.append({"epoch": e, "loss": float(m["loss"]),
                            "eval_acc": single_eval(params, cfg, data)})
    return params, history


# --------------------------------------------------------------------------
# Distributed path (stacked on one device)
# --------------------------------------------------------------------------


class WorkerData(NamedTuple):
    """Per-worker arrays stacked on the worker axis (leading dim P), on
    the device. Exactly one of ``plan`` (flat) / ``hier_plan`` is set."""

    x: torch.Tensor           # [P, M, F] padded owned features
    labels: torch.Tensor      # [P, M]
    train_mask: torch.Tensor  # [P, M] (False on padding)
    eval_mask: torch.Tensor   # [P, M]
    owned_mask: torch.Tensor  # [P, M]
    coo_src: torch.Tensor     # [P, nnz] local COO aggregation graph
    coo_dst: torch.Tensor     # [P, nnz]
    coo_w: torch.Tensor       # [P, nnz] (0 on padding)
    plan: Optional[DeviceHaloPlan] = None
    hier_plan: Optional[DeviceHierPlan] = None
    # Degree-bucketed layout of the local graph (fwd + the reverse-graph
    # layout driving the backward): the "ell" backend's hot path.
    ell: Optional[DeviceBucketedEll] = None
    ell_t: Optional[DeviceBucketedEll] = None


@dataclass(frozen=True)
class DistConfig:
    """``repro.core.trainer.DistConfig``: the worker layout and the
    exchange schedule's knobs."""

    nparts: int
    axis_name: str = "workers"
    bits: int = 0            # wire format: 0=fp32, 2=Int2 (paper), 4, 8
    cd: int = 1              # delayed-comm period (DistGNN baseline; 1 = sync)
    lr: float = 0.01
    agg_backend: str = "ell"
    num_groups: int = 0
    group_size: int = 0
    node_axis: str = "node"
    group_axis: str = "group"
    intra_bits: Optional[int] = None
    inter_bits: Optional[int] = None
    intra_cd: Optional[int] = None
    inter_cd: Optional[int] = None
    overlap: Optional[bool] = None

    def __post_init__(self):
        if self.agg_backend not in ("coo", "ell"):
            raise ValueError(
                f"agg_backend must be 'coo' or 'ell', got {self.agg_backend!r}")
        if self.num_groups or self.group_size:
            if self.num_groups < 1 or self.group_size < 1:
                raise ValueError(
                    "hierarchical DistConfig needs both num_groups >= 1 and "
                    f"group_size >= 1, got {self.num_groups}x{self.group_size}")
            if self.num_groups * self.group_size != self.nparts:
                raise ValueError(
                    f"num_groups * group_size ({self.num_groups}x"
                    f"{self.group_size}) must equal nparts ({self.nparts})")
        elif any(v is not None for v in (self.intra_bits, self.inter_bits,
                                         self.intra_cd, self.inter_cd)):
            raise ValueError(
                "intra_/inter_ stage overrides need a hierarchical "
                "DistConfig (num_groups/group_size)")
        self.schedule()  # validate bits/cd via StageSpec

    @property
    def hierarchical(self) -> bool:
        return self.num_groups >= 1 and self.group_size >= 1

    def schedule(self) -> ExchangeSchedule:
        """The composable exchange schedule this config describes."""
        if self.hierarchical:
            pick = lambda override, default: default if override is None else override
            inter_default = self.bits or HIER_INTER_BITS_DEFAULT
            return ExchangeSchedule.hierarchical(
                self.num_groups, self.group_size,
                intra_bits=pick(self.intra_bits, self.bits),
                inter_bits=pick(self.inter_bits, inter_default),
                intra_cd=pick(self.intra_cd, self.cd),
                inter_cd=pick(self.inter_cd, self.cd),
                node_axis=self.node_axis, group_axis=self.group_axis,
                overlap=self.overlap)
        return ExchangeSchedule.flat(self.nparts, bits=self.bits, cd=self.cd,
                                     axis_name=self.axis_name,
                                     overlap=self.overlap)

    def sync_fp32(self) -> "DistConfig":
        """This config with every stage forced to fresh fp32 (eval wire)."""
        return dataclasses.replace(
            self, bits=0, cd=1,
            intra_bits=None, inter_bits=0 if self.hierarchical else None,
            intra_cd=None, inter_cd=None)


class HostWorkerData(NamedTuple):
    """Partition-time worker arrays before device placement (numpy,
    stacked on the worker axis), as in the JAX package."""

    x: np.ndarray            # [P, M, F] f32
    labels: np.ndarray       # [P, M] i32
    train_mask: np.ndarray   # [P, M] bool
    eval_mask: np.ndarray    # [P, M] bool
    owned_mask: np.ndarray   # [P, M] bool
    coo_src: np.ndarray      # [P, nnz_max] i64
    coo_dst: np.ndarray      # [P, nnz_max] i64
    coo_w: np.ndarray        # [P, nnz_max] f32
    ell_stacked: list        # stack_bucketed_ells output (fwd)
    ell_t_stacked: list      # stack_bucketed_ells output (reverse graph)
    plan: Optional[object]   # graph.remote.HaloPlan (flat) or None
    hier_plan: Optional[object]  # graph.remote.HierHaloPlan or None
    max_owned: int


def prepare_distributed_host(
    g: Graph,
    x: np.ndarray,
    pg,
    eval_mask: Optional[np.ndarray] = None,
) -> HostWorkerData:
    """Pad per-partition arrays to common shapes and stack them on the
    worker axis (``repro.core.trainer.prepare_distributed_host``).

    ``g`` must already carry edge weights; ``pg`` is a flat
    ``PartitionedGraph`` or a ``HierPartitionedGraph``.
    """
    P = pg.nparts
    M_ = pg.max_owned
    F = x.shape[1]
    train = g.train_mask if g.train_mask is not None else np.ones(g.num_nodes, bool)
    if eval_mask is None:
        eval_mask = ~train
    labels = g.labels if g.labels is not None else np.zeros(g.num_nodes, np.int32)

    xs = np.zeros((P, M_, F), np.float32)
    ls = np.zeros((P, M_), np.int32)
    tm = np.zeros((P, M_), bool)
    em = np.zeros((P, M_), bool)
    om = np.zeros((P, M_), bool)
    nnz_max = max(max(c.nnz for c in pg.local_csr), 1)
    cs = np.zeros((P, nnz_max), np.int64)
    cd_ = np.zeros((P, nnz_max), np.int64)
    cw = np.zeros((P, nnz_max), np.float32)
    for p in range(P):
        o = pg.owned[p]
        n = len(o)
        xs[p, :n] = x[o]
        ls[p, :n] = labels[o]
        tm[p, :n] = train[o]
        em[p, :n] = eval_mask[o]
        om[p, :n] = True
        c = pg.local_csr[p]
        dst = np.repeat(np.arange(c.num_rows), np.diff(c.indptr))
        cs[p, :c.nnz] = c.indices
        cd_[p, :c.nnz] = dst
        cw[p, :c.nnz] = c.weights

    base = pg.base if isinstance(pg, HierPartitionedGraph) else pg
    local_ell = base.local_ell or [bucketed_ell_from_csr(c)
                                   for c in pg.local_csr]
    local_ell_t = base.local_ell_t or [
        bucketed_ell_from_csr(transpose_csr(c)) for c in pg.local_csr]

    common = dict(
        x=xs, labels=ls, train_mask=tm, eval_mask=em, owned_mask=om,
        coo_src=cs, coo_dst=cd_, coo_w=cw,
        ell_stacked=stack_bucketed_ells(local_ell),
        ell_t_stacked=stack_bucketed_ells(local_ell_t),
        max_owned=M_,
    )
    if isinstance(pg, HierPartitionedGraph):
        return HostWorkerData(**common, plan=None,
                              hier_plan=build_hier_halo_plan(pg))
    # Pad wire rows per pair to a multiple of the quant row group (4).
    R = pg.stats.padded_rows_per_pair
    R = max(4, (R + 3) // 4 * 4)
    return HostWorkerData(**common, plan=build_halo_plan(pg, rows_per_pair=R),
                          hier_plan=None)


def lift_worker_data(hwd: HostWorkerData, device="cuda") -> WorkerData:
    """Copy a HostWorkerData onto ``device``, stacked over the worker axis."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    common = dict(
        x=t(hwd.x, torch.float32), labels=t(hwd.labels, torch.int64),
        train_mask=t(hwd.train_mask, torch.bool),
        eval_mask=t(hwd.eval_mask, torch.bool),
        owned_mask=t(hwd.owned_mask, torch.bool),
        coo_src=t(hwd.coo_src, torch.int64),
        coo_dst=t(hwd.coo_dst, torch.int64),
        coo_w=t(hwd.coo_w, torch.float32),
        ell=device_bucketed(hwd.ell_stacked, device=device, squeeze=False),
        ell_t=device_bucketed(hwd.ell_t_stacked, device=device, squeeze=False),
    )
    if hwd.hier_plan is not None:
        return WorkerData(**common, hier_plan=stack_hier_plan(
            hwd.hier_plan, num_rows=hwd.max_owned, device=device))
    return WorkerData(**common, plan=stack_halo_plan(
        hwd.plan, num_rows=hwd.max_owned, device=device))


def _local_aggregate(h: torch.Tensor, wd: WorkerData,
                     agg_backend: str = "coo") -> torch.Tensor:
    """Local (intra-partition) aggregation of every worker.

    ``"ell"`` runs the degree-bucketed aggregation kernel, whose backward
    is the same kernel over the reverse-graph layout. ``"coo"`` is the
    edge-order scatter-add kept for parity checks.
    """
    if agg_backend == "ell" and wd.ell is not None:
        return bucketed_aggregate(h, wd.ell, ell_t=wd.ell_t)
    return _index_add(torch.zeros_like(h), wd.coo_dst,
                      wd.coo_w[..., None] * _take(h, wd.coo_src))


def _dist_forward(params, cfg: M.GCNConfig, dc: DistConfig, wd: WorkerData,
                  prop_mask, randomness=None, epoch: Optional[int] = None,
                  train: bool = False, halo_cache=None, schedule=None):
    """Every worker's forward, sequenced through the schedule's
    LayerProgram: per layer, ``issue`` -> local aggregation ->
    ``finalize``.

    ``randomness`` (with ``epoch``) supplies the dropout masks when
    ``train`` and the stochastic-rounding uniforms of quantized stages.
    ``halo_cache`` is the per-layer stale receive buffers of the delayed
    stages; without it the schedule runs fully sync (the eval semantics).
    Returns (logits [P, M, C], new_halo_cache).
    """
    sched = schedule if schedule is not None else dc.schedule()
    if halo_cache is None and sched.uses_cache:
        sched = sched.as_sync()
    prog = sched.layer_program(wd, agg_backend=dc.agg_backend)
    new_cache: List = []
    dev = wd.x.device

    def agg_fn(l: int, h: torch.Tensor) -> torch.Tensor:
        noise = None
        if randomness is not None:
            noise = lambda si, backward, shape: randomness.quant_uniform(
                epoch, l, si, backward, shape, dev)
        entry = halo_cache[l] if halo_cache is not None else None
        inflight = prog.issue(h, noise, cache_entry=entry, epoch=epoch)
        local = _local_aggregate(h, wd, dc.agg_backend)
        agg, ne = prog.finalize(local, inflight)
        new_cache.append(ne)
        return agg

    keep = None
    if train:
        keep = lambda l, shape: randomness.dropout_keep(
            epoch, l, shape, 1.0 - cfg.dropout, dev)
    logits = M.forward(params, cfg, wd.x, wd.labels, prop_mask, agg_fn,
                       dropout_keep=keep)
    return logits, new_cache


class DistributedTrainer:
    """Drives the stacked per-worker step (the JAX package's vmap mode).

    ``params`` defaults to ``M.init_params`` drawn from ``seed``;
    ``randomness`` to :class:`~repro_torch.core.randomness.GeneratorRandomness`
    seeded from ``seed``. Both live on ``wd``'s device.
    """

    def __init__(self, cfg: M.GCNConfig, dc: DistConfig, wd: WorkerData,
                 mode: str = "vmap", seed: int = 0, params: Optional[Dict] = None,
                 randomness=None):
        if mode == "shard_map":
            raise NotImplementedError(SHARD_MAP_REFUSED)
        if mode != "vmap":
            raise ValueError(
                f"DistributedTrainer runs the stacked mode 'vmap', not "
                f"{mode!r}; exec.mode='multiproc' runs through build_session "
                "(repro_torch.launch.multiproc.MultiprocRuntime)")
        if cfg.model == "gat":
            raise NotImplementedError(GAT_NOT_DISTRIBUTED)
        self.cfg, self.dc, self.wd, self.mode = cfg, dc, wd, mode
        self.device = wd.x.device
        self.schedule = dc.schedule()
        if params is None:
            params = M.init_params(cfg, torch.Generator().manual_seed(seed))
        self.params = M.to_device(params, self.device)
        self.opt_state = adamw_init(self.params)
        self.randomness = randomness if randomness is not None else \
            GeneratorRandomness(seed)
        self.epoch = 0
        self.use_cache = self.schedule.uses_cache
        self._cache = None
        if dc.hierarchical and wd.hier_plan is None:
            raise ValueError(
                "hierarchical DistConfig needs WorkerData built from a "
                "HierPartitionedGraph (wd.hier_plan is None)")
        if not dc.hierarchical and wd.plan is None:
            raise ValueError(
                "WorkerData carries a hierarchical plan; set num_groups/"
                "group_size on DistConfig (wd.plan is None)")
        if dc.agg_backend == "ell" and wd.ell is None:
            raise ValueError("agg_backend='ell' needs the bucketed layout in "
                             "WorkerData (wd.ell is None)")
        if wd.x.shape[0] != dc.nparts:
            raise ValueError(f"WorkerData stacks {wd.x.shape[0]} workers, "
                             f"DistConfig has nparts={dc.nparts}")

    def _ensure_cache(self) -> None:
        """Lazily zero-fill the schedule-owned halo cache (epoch 0 always
        refreshes, so zeros are never read as data)."""
        if self.use_cache and self._cache is None:
            dims = self.cfg.dims()[: self.cfg.num_layers]
            self._cache = self.schedule.init_cache(self.wd, dims)

    def train_step(self):
        """One step of every worker: (grads, metrics, new halo cache).

        The grads are those of ``P * loss`` (module docstring, C-ref6)."""
        cfg, wd, e = self.cfg, self.wd, self.epoch
        self._ensure_cache()
        if cfg.label_prop:
            sel = self.randomness.lp_select(e, tuple(wd.train_mask.shape),
                                            cfg.lp_rate, self.device)
            prop_mask, loss_mask = M.lp_masks(sel, wd.train_mask)
        else:
            prop_mask, loss_mask = torch.zeros_like(wd.train_mask), wd.train_mask
        params = tree_map(lambda p: p.detach().requires_grad_(True), self.params)
        logits, cache = _dist_forward(
            params, cfg, self.dc, wd, prop_mask, self.randomness, e, train=True,
            halo_cache=self._cache, schedule=self.schedule)
        ls, correct, cnt = M.loss_and_metrics(logits, wd.labels, loss_mask)
        gcnt = cnt.sum()
        loss = ls.sum() / torch.clamp(gcnt, min=1.0)
        grads = _grads(self.dc.nparts * loss, params)
        metrics = {"loss": loss.detach(),
                   "train_acc": correct.sum() / torch.clamp(gcnt, min=1.0)}
        return grads, metrics, (cache if self.use_cache else None)

    def train_epoch(self) -> Dict[str, float]:
        grads, metrics, cache = self.train_step()
        if self.use_cache:
            self._cache = cache
        self.params, self.opt_state = adamw_update(
            grads, self.opt_state, self.params, self.dc.lr)
        self.epoch += 1
        return {k: float(v) for k, v in metrics.items()}

    def evaluate(self) -> float:
        """Eval accuracy: every train label propagated, fresh fp32 halo."""
        wd = self.wd
        prop = wd.train_mask if self.cfg.label_prop else torch.zeros_like(wd.train_mask)
        with torch.no_grad():
            logits, _ = _dist_forward(self.params, self.cfg, self.dc.sync_fp32(),
                                      wd, prop)
            _, correct, cnt = M.loss_and_metrics(logits, wd.labels, wd.eval_mask)
        return float(correct.sum()) / max(float(cnt.sum()), 1.0)

    def fit(self, epochs: int, log_every: int = 0) -> List[Dict]:
        history = []
        for _ in range(epochs):
            m = self.train_epoch()
            if log_every and (self.epoch % log_every == 0 or self.epoch == epochs):
                m["eval_acc"] = self.evaluate()
                m["epoch"] = self.epoch
                history.append(m)
        return history

    # -- checkpoint/resume -------------------------------------------------

    def _cache_lead(self) -> Tuple[int, ...]:
        """The halo cache's worker axes as the JAX package stores them:
        ``(G, W)`` under its nested hierarchical vmap, ``(P,)`` flat."""
        if self.dc.hierarchical:
            return (self.dc.num_groups, self.dc.group_size)
        return (self.dc.nparts,)

    def train_state(self) -> Dict:
        """The resumable state tree, keyed as the JAX package's: params,
        AdamW state and (for delayed-exchange schedules) the per-stage halo
        cache, reshaped from ``[P, rows, F]`` to the JAX package's worker
        axes. Every epoch's random draws derive from the epoch number, so
        this plus ``epoch`` reproduces the uninterrupted trajectory bit
        for bit."""
        state = {"params": self.params, "opt_state": self.opt_state}
        if self.use_cache:
            self._ensure_cache()
            lead = self._cache_lead()
            state["cache"] = [tuple(c.reshape(*lead, *c.shape[1:]) for c in layer)
                              for layer in self._cache]
        return state

    def save_train_state(self, manager, meta: Optional[Dict] = None):
        """Snapshot into a :class:`repro_torch.checkpoint.CheckpointManager`
        at step == epoch (atomic write + retention happen inside)."""
        m = dict(meta or {})
        m.setdefault("epoch", self.epoch)
        m.setdefault("mode", self.mode)
        return manager.save(self.train_state(), step=self.epoch, meta=m)

    def restore_train_state_from(self, manager, step: Optional[int] = None) -> int:
        """Restore from a manager's checkpoint (the newest valid one when
        ``step`` is None) and fast-forward ``self.epoch``; returns the
        restored step. Raises FileNotFoundError when nothing restorable
        exists."""
        from repro_torch.checkpoint.ckpt import restore_train_state
        if step is None:
            valid = manager.valid_steps()
            if not valid:
                raise FileNotFoundError(f"no valid checkpoint under {manager.dir}")
            step = valid[-1]
        state, manifest = restore_train_state(manager.path_for(step),
                                              self.train_state())
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        if self.use_cache:
            p = self.dc.nparts
            self._cache = [tuple(c.reshape(p, *c.shape[-2:]) for c in layer)
                           for layer in state["cache"]]
        self.epoch = int(manifest.get("meta", {}).get("epoch",
                                                      manifest.get("step") or step))
        return step

    # -- not ported yet ----------------------------------------------------

    def lower_step(self, *args, **kwargs):
        raise NotImplementedError(f"lower_step (the dry-run hook) {NOT_PORTED}")
