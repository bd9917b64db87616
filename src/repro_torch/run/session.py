"""build_session: lower a :class:`~repro_torch.run.spec.RunSpec` onto the
port's training stack (counterpart of ``repro.run.session``).

  graph source -> features -> normalization -> (flat | hierarchical)
  partition -> ``prepare_distributed_host`` -> device lift ->
  ``DistributedTrainer`` (the stacked vmap mode)

runs here once, stage by stage, and returns a :class:`Session` with the
operations the launchers perform: ``fit`` / ``train_epoch`` / ``evaluate``,
``lower`` (the recorded step the auditor reads; a ``shard_map`` session's
is every rank's own program) and the accounting
(``comm_stats``, ``partition_stats``, ``predicted_wire_bytes``,
``predicted_hlo_wire_bytes``). ``build_graph`` and ``build_partition``
are public, as there; serving uses them too, and :class:`BuildCache`
shares them across specs that agree on them (the sweep and the tuner).
``exec.auto`` names a tuner result (``python -m repro_torch.run.tune``,
or the JAX package's, whose layout is the same): :func:`resolve_auto`
swaps its winner's partition and schedule into the spec.

``exec.mode=multiproc`` runs one OS process per partition instead
(``repro_torch.launch.multiproc.MultiprocRuntime``): the host arrays are
its shared store, the parent lifts nothing to the device, and each rank
moves its own slice there. ``exec.mode=shard_map`` does the same with
the exchange and the gradient sum over ``torch.distributed`` collectives
between the ranks' devices (``repro_torch.launch.spmd.ShardMapRuntime``;
NCCL with one rank per card, gloo on the CPU, or gloo on one card when
the caller passes ``backend="gloo"``). ``Session.close()`` stops the
fleet.

``fit(ckpt_dir=...)`` snapshots the run every ``exec.ckpt_every`` epochs
into the JAX package's checkpoint format (per rank under multiproc, whose
supervisor also restores from there after a fault; under shard_map rank
0's replicated state and every rank's halo cache in one file), and
``fit(resume=True)`` restores the newest valid snapshot first.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import repro_torch.run.sources as sources  # populates the registries on import
from repro_torch.core.record import setup_span
from repro_torch.run.spec import FEATURE_SOURCES, GRAPH_SOURCES, RunSpec


def stage_wire_payload_bytes(rows: int, feat: int, bits: int) -> float:
    """One direction's all-to-all bytes per worker for a ``[rows, feat]``
    wire buffer as the port ships it: fp32 rows, or the packed int32 words
    of ``kernels.quant_pack`` (``words_per_row(feat, bits)`` a row) plus
    the two fp32 (zero, scale) params per ``ROW_GROUP`` rows. The JAX
    package ships one int32 holder per value instead
    (``repro.run.session.stage_hlo_payload_bytes``)."""
    from repro_torch.quant.stochastic import ROW_GROUP, words_per_row

    if not bits:
        return rows * feat * 4.0
    return rows * words_per_row(feat, bits) * 4.0 + 2.0 * (-(-rows // ROW_GROUP)) * 4.0


def build_graph(spec: RunSpec) -> Tuple[Any, np.ndarray]:
    """(normalized Graph, features [N, F]) for the spec's graph section.

    Features are synthesized on the *raw* graph (labels drive them, not
    edge weights); normalization attaches the aggregation edge weights
    before partitioning.
    """
    gs = spec.graph
    g = GRAPH_SOURCES.get(gs.source)(gs)
    x = FEATURE_SOURCES.get(sources.resolve_features(gs))(g, gs)
    if gs.norm == "mean":
        g = g.mean_normalized()
    elif gs.norm == "gcn":
        g = g.gcn_normalized()
    return g, x


@setup_span("setup.partition")
def build_partition(spec: RunSpec, g) -> Any:
    """Partition the (already normalized) graph per the spec: a flat
    ``PartitionedGraph`` or a two-level ``HierPartitionedGraph``, with the
    ``partition.refine`` post-pass applied to the labels before the halo
    plans are built. Equal to ``repro.run.session.build_partition``: the
    partition call ``build_*_partitioned_graph`` would make is made here
    (the partitioner reads no edge weight). The set-up span
    ``setup.partition`` (``core.record``) times it, and ``.labels`` the
    labels alone."""
    from repro_torch.graph import (build_hierarchical_partitioned_graph,
                                   build_partitioned_graph)
    from repro_torch.graph.partition import (partition_graph,
                                             partition_hierarchical,
                                             refine_bucket_max)
    ps = spec.partition
    if ps.hierarchical:
        gsz = ps.resolved_group_size()
        with setup_span("setup.partition.labels"):
            part = partition_hierarchical(g, ps.groups, gsz, seed=ps.seed)
            if ps.refine == "bucket-max":
                part = refine_bucket_max(g, part, nparts=ps.nparts,
                                         group_size=gsz, seed=ps.seed)
        return build_hierarchical_partitioned_graph(
            g, ps.groups, gsz, part=part, strategy=ps.strategy, seed=ps.seed)
    with setup_span("setup.partition.labels"):
        part = partition_graph(g, ps.nparts, seed=ps.seed)
        if ps.refine == "bucket-max":
            part = refine_bucket_max(g, part, nparts=ps.nparts, seed=ps.seed)
    return build_partitioned_graph(g, ps.nparts, part=part,
                                   strategy=ps.strategy, seed=ps.seed)


def resolve_auto(spec: RunSpec) -> RunSpec:
    """The ``exec.auto`` resolution path: when ``exec.auto`` names a tuner
    result file (``python -m repro_torch.run.tune --out ...``, or the JAX
    package's), swap the audited winner's partition + schedule sections
    into the caller's spec. The caller keeps naming its graph/model/exec;
    the tuner owns the performance knobs. Refuses a result tuned for a
    different graph section — a stale auto file must fail loudly, not run
    the wrong schedule silently."""
    from repro_torch.run.spec import SpecError
    if not spec.exec.auto:
        return spec
    path = spec.exec.auto
    try:
        with open(path) as f:
            result = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SpecError(f"exec.auto: cannot read tuner result {path!r}: {e}")
    winner = result.get("winner") or {}
    if not winner.get("spec"):
        raise SpecError(f"exec.auto: {path!r} carries no winner.spec "
                        "(re-run repro_torch.run.tune)")
    tuned = RunSpec.from_dict(winner["spec"])
    if tuned.graph.content_hash() != spec.graph.content_hash():
        raise SpecError(
            f"exec.auto: {path!r} was tuned for graph section "
            f"{tuned.graph.content_hash()}, this spec builds "
            f"{spec.graph.content_hash()} — re-tune for this graph")
    return dataclasses.replace(spec, partition=tuned.partition,
                               schedule=tuned.schedule).validate()


@dataclass
class BuildCache:
    """Shares the graph/partition stages across sessions whose specs agree
    on those stages (sweep grids over schedule/model knobs). Keys are
    content hashes of the contributing sub-specs, so a hit never crosses
    configurations."""

    graphs: Dict[str, Tuple[Any, np.ndarray]] = field(default_factory=dict)
    partitions: Dict[str, Any] = field(default_factory=dict)
    pstats: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    @staticmethod
    def _graph_key(spec: RunSpec) -> str:
        return spec.graph.content_hash()

    @staticmethod
    def _part_key(spec: RunSpec) -> str:
        return f"{spec.graph.content_hash()}|{spec.partition.content_hash()}"

    def graph(self, spec: RunSpec) -> Tuple[Any, np.ndarray]:
        key = self._graph_key(spec)
        if key not in self.graphs:
            self.graphs[key] = build_graph(spec)
        return self.graphs[key]

    def partition(self, spec: RunSpec, g) -> Any:
        key = self._part_key(spec)
        if key not in self.partitions:
            self.partitions[key] = build_partition(spec, g)
        return self.partitions[key]

    def partition_stats(self, spec: RunSpec, g) -> Dict[str, Any]:
        """``partition_stats`` for the spec's labels, cached alongside the
        partition itself (sweep grids re-read it per schedule variant)."""
        key = self._part_key(spec)
        if key not in self.pstats:
            from repro_torch.graph.partition import partition_stats
            self.pstats[key] = partition_stats(g, self.partition(spec, g).part)
        return self.pstats[key]


class Session:
    """A spec lowered onto the live stack: graph, partition, worker data
    and trainer, plus the driver-facing operations."""

    def __init__(self, spec: RunSpec, g, x, pg, wd, trainer):
        self.spec = spec
        self.graph = g
        self.x = x
        self.pg = pg
        self.wd = wd
        self.trainer = trainer
        self._pstats: Optional[Dict[str, Any]] = None

    # -- training ----------------------------------------------------------

    def fit(self, epochs: Optional[int] = None,
            log_every: Optional[int] = None,
            ckpt_dir: Optional[str] = None,
            resume: bool = False) -> List[Dict]:
        """Train for ``epochs`` (default: the spec's) and return history.

        ``log_every`` falls back to the spec's, whose 0 means "auto" (~10
        eval points); an explicit 0 skips evals entirely.

        ``ckpt_dir`` turns on periodic checkpointing (atomic snapshots
        every ``spec.exec.ckpt_every`` epochs, default every epoch) and
        ``resume=True`` restores the newest valid checkpoint before
        training — the epoch counter fast-forwards, so a resumed run
        trains only the remaining epochs and reproduces the uninterrupted
        trajectory bit for bit (all per-epoch randomness derives from the
        epoch number).
        """
        e = self.spec.exec
        n = e.epochs if epochs is None else epochs
        le = e.log_every if log_every is None else log_every
        if not le and log_every is None:
            le = max(n // 10, 1)
        if ckpt_dir is None:
            if resume:
                raise ValueError("resume=True needs ckpt_dir")
            return self.trainer.fit(n, log_every=le)

        every = e.ckpt_every if e.ckpt_every else 1
        tr = self.trainer
        save = None
        if hasattr(tr, "configure_ckpt"):
            # Multiproc: the ranks snapshot themselves inside train_epoch;
            # the parent points them at the directory (before they spawn)
            # and sends the restore command on resume.
            tr.configure_ckpt(ckpt_dir, every=every)
            if resume:
                tr.restore_from_ckpt()
        else:
            from repro_torch.checkpoint import CheckpointManager
            mgr = CheckpointManager(ckpt_dir)
            if resume:
                try:
                    tr.restore_train_state_from(mgr)
                except FileNotFoundError as err:
                    raise RuntimeError(
                        f"resume requested but no valid checkpoint under "
                        f"{ckpt_dir}") from err
            # Stamp provenance so a serving deployment can refuse a
            # checkpoint trained on a different graph (serve/server.py).
            meta = {"graph_hash": self.spec.graph.content_hash(),
                    "spec_hash": self.spec.content_hash()}
            save = lambda: tr.save_train_state(mgr, meta=meta)
        history = []
        while tr.epoch < n:
            m = tr.train_epoch()
            if save is not None and (tr.epoch % every == 0 or tr.epoch == n):
                save()
            if le and (tr.epoch % le == 0 or tr.epoch == n):
                m["eval_acc"] = tr.evaluate()
                m["epoch"] = tr.epoch
                history.append(m)
        return history

    def train_epoch(self) -> Dict[str, float]:
        return self.trainer.train_epoch()

    def evaluate(self) -> float:
        return self.trainer.evaluate()

    def lower(self, epoch: Optional[int] = None):
        """One training step recorded, changing no state: a forward and
        backward on the session's device. Stacked: the step of all workers
        (``core.record.LoweredStep``, ``DistributedTrainer.lower_step``).
        ``shard_map``: every rank's own program with the process group of
        each collective (``core.record.RankPrograms``,
        ``ShardMapRuntime.lower_step``), recorded in this process on the
        ``fake`` backend with no fleet started. Multiproc raises: it has
        no single step."""
        return self.trainer.lower_step(epoch)

    def close(self) -> None:
        """Release the trainer's resources (multiproc: stop the fleet and
        unlink the shared-memory segments); nothing to do when stacked."""
        close = getattr(self.trainer, "close", None)
        if close is not None:
            close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- accounting --------------------------------------------------------

    @property
    def schedule(self):
        return self.trainer.schedule

    def comm_stats(self):
        """The partition's ``CommStats`` (per-strategy/per-stage volumes)."""
        return self.pg.stats

    def partition_stats(self) -> Dict[str, Any]:
        """``graph.partition.partition_stats`` for this session's labels
        (cached)."""
        if self._pstats is None:
            from repro_torch.graph.partition import partition_stats
            self._pstats = partition_stats(self.graph, self.pg.part)
        return self._pstats

    def predicted_wire_bytes(self, feat_dim: Optional[int] = None
                             ) -> Dict[str, float]:
        """Per-stage predicted wire bytes per epoch under the schedule."""
        f = self.spec.graph.feat_dim if feat_dim is None else feat_dim
        return self.schedule.wire_volume_bytes(self.pg.stats, f)

    def predicted_hlo_wire_bytes(self) -> Dict[str, float]:
        """All-to-all bytes per worker expected in ONE recorded step with
        every stage's wire running (forward + backward), derived from the
        device plans: per stage and layer, the plan's wire rows
        (``send_gather_idx`` rows; the grouped inter stage wires only its
        1/``shard_size`` shard) at the layer's input width, both directions,
        in the port's wire format (:func:`stage_wire_payload_bytes`: packed
        int32 words, not the JAX package's one int32 holder per value). The
        auditor's ``predicted-bytes`` rule holds the recorded step to it;
        :meth:`predicted_wire_bytes` is the paper's cost model."""
        cfg = self.trainer.cfg
        feats = cfg.dims()[: cfg.num_layers]
        out: Dict[str, float] = {}
        total = 0.0
        for stage in self.schedule.stages:
            rows = int(self.schedule.plan_for(stage, self.wd).send_gather_idx.shape[-1])
            topo = self.schedule.topo(stage)
            if topo.kind == "grouped":
                rows //= topo.shard_size
            stage_bytes = sum(2.0 * stage_wire_payload_bytes(rows, f, stage.bits)
                              for f in feats)
            out[stage.level] = stage_bytes
            total += stage_bytes
        out["total"] = total
        return out

    def step_cache_size(self) -> Optional[int]:
        """Distinct step signatures among the epochs trained while the step
        recorder was on (eager PyTorch's count of compiled executables; the
        auditor's ``retrace-guard`` reads it). None under multiproc, which
        has no single step, and under shard_map, whose ranks' signatures
        the rule counts over their lowered programs."""
        sigs = getattr(self.trainer, "step_signatures", None)
        return None if sigs is None else len(sigs)

    def describe(self) -> str:
        return self.spec.describe()


def build_session(spec: RunSpec, device="cuda", randomness=None,
                  params: Optional[Dict] = None,
                  cache: Optional[BuildCache] = None,
                  backend: Optional[str] = None) -> Session:
    """Lower ``spec`` end to end onto ``device`` (the card unless the
    caller asks for the CPU; raises if the card is missing) and return the
    live :class:`Session`. ``exec.auto`` is resolved first
    (:func:`resolve_auto`). ``params`` and ``randomness`` default to fresh
    ones drawn from ``exec.seed`` (under multiproc ``randomness`` must
    pickle: every rank gets a copy); ``cache`` shares the graph and
    partition builds with other sessions. ``backend`` is shard_map's
    ``torch.distributed`` backend (default: NCCL on the card, gloo on the
    CPU; ``launch.spmd.resolve_backend``), and no other mode takes one.
    GAT is refused before the partition where it cannot run
    (``core.trainer.refuse_gat``)."""
    from repro_torch.core import DistributedTrainer
    from repro_torch.core.trainer import (lift_worker_data,
                                          prepare_distributed_host,
                                          refuse_gat, resolve_device)

    spec = resolve_auto(spec.validate())
    refuse_gat(spec.model.model, spec.partition.strategy, spec.exec.mode)
    if backend is not None and spec.exec.mode != "shard_map":
        raise ValueError(f"backend={backend!r} is for exec.mode=shard_map, not "
                         f"{spec.exec.mode!r}")
    dev = resolve_device(device)
    if cache is not None:
        g, x = cache.graph(spec)
        pg = cache.partition(spec, g)
    else:
        g, x = build_graph(spec)
        pg = build_partition(spec, g)
    hwd = prepare_distributed_host(g, x, pg)
    if spec.exec.mode == "multiproc":
        from repro_torch.launch.multiproc import MultiprocRuntime
        runtime = MultiprocRuntime(spec, hwd, device=dev, params=params,
                                   randomness=randomness)
        return Session(spec, g, x, pg, hwd, runtime)
    if spec.exec.mode == "shard_map":
        from repro_torch.launch.spmd import ShardMapRuntime
        runtime = ShardMapRuntime(spec, hwd, device=dev, params=params,
                                  randomness=randomness, backend=backend)
        return Session(spec, g, x, pg, hwd, runtime)
    wd = lift_worker_data(hwd, device=dev)
    dc = spec.schedule.to_dist_config(spec.partition, lr=spec.exec.lr)
    cfg = spec.model.to_gcn_config(spec.graph, spec.schedule)
    trainer = DistributedTrainer(cfg, dc, wd, mode=spec.exec.mode,
                                 seed=spec.exec.seed, params=params,
                                 randomness=randomness)
    return Session(spec, g, x, pg, wd, trainer)
