"""build_session: lower a :class:`~repro_torch.run.spec.RunSpec` onto the
port's training stack (counterpart of ``repro.run.session``).

  graph source -> features -> normalization -> (flat | hierarchical)
  partition -> ``prepare_distributed_host`` -> device lift ->
  ``DistributedTrainer`` (the stacked vmap mode)

runs here once, stage by stage, and returns a :class:`Session` with the
operations the drivers perform: ``fit`` / ``train_epoch`` / ``evaluate``
and the accounting (``comm_stats``, ``partition_stats``,
``predicted_wire_bytes``). ``build_graph`` and ``build_partition`` are
public, as there; serving uses them too.

``exec.mode=multiproc`` runs one OS process per partition instead
(``repro_torch.launch.multiproc.MultiprocRuntime``): the host arrays are
its shared store, the parent lifts nothing to the device, and each rank
moves its own slice there. ``Session.close()`` stops the fleet.

``fit(ckpt_dir=...)`` snapshots the run every ``exec.ckpt_every`` epochs
into the JAX package's checkpoint format (per rank under multiproc, whose
supervisor also restores from there after a fault), and
``fit(resume=True)`` restores the newest valid snapshot first.

Refused (they raise): ``exec.mode=shard_map`` (one card holds no
multi-device mesh; ``core.trainer.SHARD_MAP_REFUSED``), and ``exec.auto``
and ``lower``, not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import repro_torch.run.sources as sources  # populates the registries on import
from repro_torch.run.spec import FEATURE_SOURCES, GRAPH_SOURCES, RunSpec

NOT_PORTED = "is not ported to PyTorch yet (ROADMAP queue A); use the JAX package"


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


def build_partition(spec: RunSpec, g) -> Any:
    """Partition the (already normalized) graph per the spec: a flat
    ``PartitionedGraph`` or a two-level ``HierPartitionedGraph``, with the
    ``partition.refine`` post-pass applied to the labels before the halo
    plans are built. Equal to ``repro.run.session.build_partition``."""
    from repro_torch.graph import (build_hierarchical_partitioned_graph,
                                   build_partitioned_graph)
    from repro_torch.graph.partition import (partition_graph,
                                             partition_hierarchical,
                                             refine_bucket_max)
    ps = spec.partition
    if ps.hierarchical:
        gsz = ps.resolved_group_size()
        part = None
        if ps.refine == "bucket-max":
            part = partition_hierarchical(g, ps.groups, gsz, seed=ps.seed)
            part = refine_bucket_max(g, part, nparts=ps.nparts,
                                     group_size=gsz, seed=ps.seed)
        return build_hierarchical_partitioned_graph(
            g, ps.groups, gsz, part=part, strategy=ps.strategy, seed=ps.seed)
    part = None
    if ps.refine == "bucket-max":
        part = partition_graph(g, ps.nparts, seed=ps.seed)
        part = refine_bucket_max(g, part, nparts=ps.nparts, seed=ps.seed)
    return build_partitioned_graph(g, ps.nparts, part=part,
                                   strategy=ps.strategy, seed=ps.seed)


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


def build_session(spec: RunSpec, device="cuda", randomness=None,
                  params: Optional[Dict] = None) -> Session:
    """Lower ``spec`` end to end onto ``device`` (the card unless the
    caller asks for the CPU; raises if the card is missing) and return the
    live :class:`Session`. ``params`` and ``randomness`` default to fresh
    ones drawn from ``exec.seed`` (under multiproc ``randomness`` must
    pickle: every rank gets a copy)."""
    from repro_torch.core import DistributedTrainer
    from repro_torch.core.trainer import (SHARD_MAP_REFUSED, lift_worker_data,
                                          prepare_distributed_host,
                                          resolve_device)

    spec = spec.validate()
    if spec.exec.mode == "shard_map":
        raise NotImplementedError(SHARD_MAP_REFUSED)
    if spec.exec.auto:
        raise NotImplementedError(f"exec.auto (tuned schedules) {NOT_PORTED}")
    dev = resolve_device(device)
    g, x = build_graph(spec)
    pg = build_partition(spec, g)
    hwd = prepare_distributed_host(g, x, pg)
    if spec.exec.mode == "multiproc":
        from repro_torch.launch.multiproc import MultiprocRuntime
        runtime = MultiprocRuntime(spec, hwd, device=dev, params=params,
                                   randomness=randomness)
        return Session(spec, g, x, pg, hwd, runtime)
    wd = lift_worker_data(hwd, device=dev)
    dc = spec.schedule.to_dist_config(spec.partition, lr=spec.exec.lr)
    cfg = spec.model.to_gcn_config(spec.graph, spec.schedule)
    trainer = DistributedTrainer(cfg, dc, wd, mode=spec.exec.mode,
                                 seed=spec.exec.seed, params=params,
                                 randomness=randomness)
    return Session(spec, g, x, pg, wd, trainer)
