"""``exec.mode=shard_map``: one process per worker, the halo exchange and
the gradient sum over ``torch.distributed`` collectives.

Counterpart of the JAX package's ``shard_map`` trainer
(``repro/core/trainer.py:606-667``): the worker step mapped over a 1-D
``(workers,)`` mesh, or a 2-D ``(group, node)`` mesh for the hierarchical
exchange, parameters and AdamW state replicated, gradients summed over
the mesh, and ``eval_sm`` running the sync fp32 schedule. The JAX package
is one controller over many devices; here each worker is a process of its
own (rank ``r = g * W + w``) on its own device, and the parent drives them
by command, as ``launch.multiproc`` does. The two modes share the control
plane (``multiproc._Fleet``: the spawn context, the ``ShmArena`` store of
partition arrays, the command pipes) and the rank (``multiproc._RankBase``:
its slices of the store, and its forward, backward and AdamW step, the
stacked code at P = 1 with every draw taken at the stacked shape and the
rank's row kept). What differs is the wire:

* the exchange runs ``core.exchange.CollectiveWire`` over the mesh's
  process groups (``launch.mesh.mesh_groups``): all_to_all, the
  psum_scatter as an all_to_all and a sum in node order, the all_gather,
  issued asynchronously in a layer's ``issue`` phase and waited on in
  ``finalize``, so an overlapped stage's collectives run beside the local
  aggregation;
* the gradient sum is an all_gather of the flat gradient and the three
  loss scalars, then a sum over the P sources in rank order from zeros,
  as multiproc's mailbox sum runs it.

Every cross-rank sum is a data-moving collective followed by a local sum
in a fixed order, so no backend picks its own reduction order: a
``shard_map`` run equals a ``multiproc`` run bitwise on the same device
type, and a resumed run equals the uninterrupted one.

Backend and device: on the card NCCL, rank r on ``cuda:r``, which needs
``partition.nparts`` visible cards. On the CPU gloo. A caller may ask for
``backend="gloo"`` with a CUDA device, so that all ranks share one card
(``cuda:0``, or the device's index): that checks the rank logic on device
tensors, while gloo's CUDA collectives copy every buffer through host
memory, so its times are not NCCL's. The backend is never switched
silently. Rendezvous goes through a ``FileStore`` in a fresh temporary
directory, so sessions built at once never meet.

There is no respawn, as there is none in the JAX package's ``shard_map``:
a rank that fails makes the runtime raise, after it has stopped every
rank, unlinked the store and removed the rendezvous directory.

Lowering (``ShardMapRuntime.lower_step``, behind ``Session.lower()``)
starts no fleet: the parent builds each rank in turn from the partition
arrays it holds, in a world of torch's ``fake`` backend (its collectives
move no data), and records the rank's forward and backward under
``core.exchange.recording``. The result, ``core.record.RankPrograms``, is
every rank's own program with the process group of each collective: what
the auditor, the spec matrix and the GCN dry-run read, as the JAX
package's read the lowered ``shard_map`` module. The values of such a
step are meaningless; only the record is kept.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import exchange as X
from repro_torch.core.exchange import CollectiveWire, _timed_wire
from repro_torch.core.randomness import GeneratorRandomness
from repro_torch.core.record import LoweredStep, RankPrograms
from repro_torch.core.trainer import refuse_gat
from repro_torch.launch.mesh import Mesh, make_hier_worker_mesh, make_worker_mesh, mesh_groups
from repro_torch.launch.multiproc import (
    _PARENT_WAIT_S,
    _arena_arrays,
    _Fleet,
    _RankBase,
    _np,
    _WorkerFailure,
)
from repro_torch.launch.shm_store import ShmArena, rss_bytes, run_token
from repro_torch.optim.adamw import AdamWState, tree_leaves, tree_map

_PG_TIMEOUT_S = 600.0  # a collective that waits longer raises in its rank


def worker_mesh(dc) -> Mesh:
    """The mesh of a ``DistConfig``'s workers, with the schedule's axis
    names (``repro.run.session.build_mesh``'s)."""
    if dc.hierarchical:
        return make_hier_worker_mesh(dc.num_groups, dc.group_size,
                                     group_axis=dc.group_axis, node_axis=dc.node_axis)
    return make_worker_mesh(dc.nparts, axis=dc.axis_name)


def resolve_backend(device: torch.device, backend: Optional[str], nprocs: int,
                    check_cards: bool = True) -> tuple:
    """(backend, the device of each rank). NCCL puts rank r on ``cuda:r``
    and raises unless ``nprocs`` cards are visible (``check_cards``); gloo
    keeps every rank on ``device``."""
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"backend 'nccl' needs a CUDA device, not {device}")
        visible = torch.cuda.device_count()
        if check_cards and visible < nprocs:
            raise RuntimeError(
                f"exec.mode=shard_map over NCCL runs one rank per card: "
                f"{nprocs} ranks (partition.nparts) need {nprocs} visible cards, "
                f"{visible} are visible (backend='gloo' shares one card between "
                f"ranks, through host memory)")
        return backend, [f"cuda:{r}" for r in range(nprocs)]
    if backend != "gloo":
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return backend, [str(device)] * nprocs


class _SpmdRank(_RankBase):
    """A shard_map rank: the wire is :class:`CollectiveWire` over the
    mesh's process groups, the gradient sum an all_gather."""

    COMMANDS = _RankBase.COMMANDS + ("load",)

    def _device_name(self, manifest: dict) -> str:
        return manifest["dist"]["devices"][self.rank]

    def _connect(self, manifest: dict) -> None:
        import torch.distributed as dist

        d = manifest["dist"]
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        store = dist.FileStore(d["store"], self.nprocs)
        dist.init_process_group(d["backend"], store=store, rank=self.rank,
                                world_size=self.nprocs,
                                timeout=datetime.timedelta(seconds=_PG_TIMEOUT_S))
        self.groups = mesh_groups(Mesh(tuple(d["axes"]), tuple(d["sizes"])), self.rank)
        self.clock.update(wait_s=0.0, wire_bytes=0)

    def _transport(self, op_base, spec, topo, rows, feat):
        return CollectiveWire(topo, spec.bits, self.groups, self.rank, self.nprocs,
                              rows, feat, self.clock)

    def _counters(self) -> Dict[str, float]:
        return {k: self.clock[k] for k in ("wait_s", "wire_s", "wire_bytes")}

    @_timed_wire
    def _allreduce(self, op: str, vec: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        vec = vec.contiguous()
        if X.RECORDER is not None:
            with X.RECORDER.scoped((None, "")):
                CollectiveWire._note("psum", vec, dist.group.WORLD, self.nprocs)
        parts = torch.empty((self.nprocs, vec.numel()), dtype=vec.dtype,
                            device=vec.device)
        self.clock["wire_bytes"] += self.nprocs * vec.numel() * vec.element_size()
        work = dist.all_gather(list(parts.unbind(0)), vec, async_op=True)
        t0 = time.perf_counter()
        work.wait()
        self.clock["wait_s"] += time.perf_counter() - t0
        out = torch.zeros_like(vec)
        for s in range(self.nprocs):
            out += parts[s]
        return out

    def command(self, msg: dict) -> dict:
        if msg["cmd"] == "load":
            return self.load(msg)
        return super().command(msg)

    def load(self, msg: dict) -> dict:
        """Take the state :meth:`state` gives (this rank's cache rows)."""
        to = lambda a: torch.from_numpy(a).to(self.device)
        self.params = tree_map(to, msg["params"])
        step, mu, nu = msg["opt_state"]
        self.opt_state = AdamWState(step=int(step), mu=tree_map(to, mu),
                                    nu=tree_map(to, nu))
        if self.schedule.uses_cache:
            self.cache = [tuple(to(c)[None] for c in layer) for layer in msg["cache"]]
        self.epoch = int(msg["epoch"])
        return {"epoch": self.epoch}

    def close(self) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        super().close()


class _LowerRank(_SpmdRank):
    """A rank that the parent builds to record its program
    (:meth:`ShardMapRuntime.lower_step`): the runtime's own partition
    arrays, the runtime's device for every rank, and a world on torch's
    ``fake`` backend, whose collectives return at once and move no data."""

    def _device_name(self, manifest: dict) -> str:
        return manifest["device"]

    def _connect(self, manifest: dict) -> None:
        import torch.distributed as dist

        try:
            from torch.testing._internal.distributed.fake_pg import FakeStore

            dist.init_process_group("fake", store=FakeStore(), rank=self.rank,
                                    world_size=self.nprocs)
        except Exception as e:  # noqa: BLE001 — say why, never fall back
            raise RuntimeError(
                "lowering a shard_map step needs torch.distributed's 'fake' "
                f"backend, which did not open: {type(e).__name__}: {e}") from e
        d = manifest["dist"]
        self.groups = mesh_groups(Mesh(tuple(d["axes"]), tuple(d["sizes"])), self.rank)
        self.clock.update(wait_s=0.0, wire_bytes=0)

    def lower(self, epoch: int, wrap: Optional[Callable] = None) -> LoweredStep:
        """This rank's forward, backward and gradient sum at ``epoch``'s
        draws under the recorder, with no update. ``wrap(step)`` runs the
        step (a callable that returns the recorder) for a caller that
        measures it."""
        self.epoch = epoch

        def step():
            with X.recording(rank=self.rank) as rec:
                self._grad_step()
            return rec

        rec = step() if wrap is None else wrap(step)
        stale = tuple(s.level for s in self.schedule.stages if s.delayed and epoch % s.cd)
        return LoweredStep(ops=rec.ops, epoch=epoch, nparts=self.nprocs,
                           stale_levels=stale, rank=self.rank)


def check_one_program(programs: Sequence[LoweredStep]) -> None:
    """Raise, naming the first differing op, unless every rank issues the
    same ops (``StepOp.program_key``: kind, direction, layer, level, role,
    dtype, group size). The JAX package's program is one for every
    device; ranks that disagree would leave their peers waiting."""
    if not programs:
        return
    first = programs[0]
    for prog in programs[1:]:
        for i, (a, b) in enumerate(zip(first.ops, prog.ops)):
            if a.program_key() != b.program_key():
                raise RuntimeError(
                    f"shard_map lowering: rank {prog.rank}'s op {i} differs from rank "
                    f"{first.rank}'s: {b.program_key()} against {a.program_key()}")
        if len(prog.ops) != len(first.ops):
            raise RuntimeError(
                f"shard_map lowering: rank {prog.rank} records {len(prog.ops)} ops, "
                f"rank {first.rank} {len(first.ops)}")


class ShardMapRuntime(_Fleet):
    """P processes, one per worker, over one shared graph store and
    ``torch.distributed`` collectives: the trainer-shaped runtime behind
    ``exec.mode="shard_map"`` (see the module docstring).

    ``device`` is the ranks' device type ("cuda", or "cpu" with the
    kernels' plain versions); ``backend`` defaults to NCCL on the card and
    gloo on the CPU (:func:`resolve_backend`). ``params`` (a tree of
    tensors) and ``randomness`` default to the stacked trainer's, drawn
    from ``exec.seed``; ``randomness`` must pickle (each rank gets a copy).

    Lazy: the store is published and the ranks spawn on the first
    command. On the card the parent builds the kernels before it spawns.
    NCCL's card count is checked then too: :meth:`lower_step` needs no
    fleet, and records every rank on ``device``. A rank's error, or its
    death, stops the run: every rank is stopped, the store unlinked, and
    ``RuntimeError`` raised.
    """

    mode = "shard_map"
    _worker_cls = _SpmdRank

    def __init__(self, spec, hwd, device="cuda", params=None, randomness=None,
                 backend: Optional[str] = None):
        self.spec = spec
        refuse_gat(spec.model.model, mode="shard_map")
        self.nprocs = spec.partition.nparts
        if spec.exec.nprocs and spec.exec.nprocs != self.nprocs:
            raise ValueError(
                f"shard_map runs one process per partition: exec.nprocs "
                f"{spec.exec.nprocs} != partition.nparts {self.nprocs}")
        self.device = torch.device(device)
        self.backend, self.devices = resolve_backend(self.device, backend, self.nprocs,
                                                     check_cards=False)
        self.dc = spec.schedule.to_dist_config(spec.partition, lr=spec.exec.lr)
        self.schedule = self.dc.schedule()
        self.cfg = spec.model.to_gcn_config(spec.graph, spec.schedule)
        self.mesh = worker_mesh(self.dc)
        self.epoch = 0
        self.epoch_stats: List[dict] = []
        self.eval_launches: List[dict] = []  # per rank, of the last evaluate
        self.ready_stats: List[dict] = []
        self.token: Optional[str] = None
        self._arrays, self._meta = _arena_arrays(hwd)
        self._meta["feat_dims"] = list(self.cfg.dims()[: self.cfg.num_layers])
        self._params = None if params is None else _np(params)
        self._randomness = (randomness if randomness is not None
                            else GeneratorRandomness(spec.exec.seed))
        self._rendezvous: Optional[str] = None
        self._init_fleet()

    # -- lifecycle -------------------------------------------------------------

    def _ensure_started(self) -> None:
        if self._started:
            return
        resolve_backend(self.device, self.backend, self.nprocs)
        if self.device.type == "cuda":
            from repro_torch.kernels.build import build_all
            build_all()
        self.token = run_token()
        self._arena = ShmArena.publish(f"{self.token}-store", self._arrays)
        self._rendezvous = tempfile.mkdtemp(prefix="repro-spmd-")
        self._manifest = {
            "spec": self.spec.to_dict(), "meta": self._meta,
            "device": str(self.device), "randomness": self._randomness,
            "params": self._params,
            "store": {"name": self._arena.name, "table": self._arena.table},
            "dist": {"backend": self.backend, "devices": self.devices,
                     "store": f"{self._rendezvous}/store",
                     "axes": list(self.mesh.axis_names), "sizes": list(self.mesh.sizes)}}
        self._ctx = mp.get_context("spawn")
        self._procs = [None] * self.nprocs
        self._conns = [None] * self.nprocs
        for r in range(self.nprocs):
            self._spawn_rank(r)
        self._started = True
        self._install_signal_cleanup()
        try:
            reps = self._gather(_PARENT_WAIT_S, "startup", fail_fast=True)
        except _WorkerFailure as f:
            self._abort(f"startup failed: {f}"
                        + "".join(f"\n  rank {r}: {e}" for r, e in f.errors.items()))
        self.ready_stats = [reps[r] for r in range(self.nprocs)]

    def _command(self, msgs, what: str) -> List[dict]:
        """Send ``msgs`` (one message, or one per rank) and gather every
        rank's reply; a failure stops the run (no respawn)."""
        self._ensure_started()
        if isinstance(msgs, dict):
            msgs = [msgs] * self.nprocs
        try:
            for r, msg in enumerate(msgs):
                self._send(msg, what, [r])
            reps = self._gather(_PARENT_WAIT_S, what, fail_fast=True)
        except _WorkerFailure as f:
            self._abort(f"{f} during {what}"
                        + "".join(f"\n  rank {r}: {e}" for r, e in f.errors.items()))
        return [reps[r] for r in range(self.nprocs)]

    def close(self, force: bool = False) -> None:
        super().close(force)
        if self._rendezvous is not None:
            shutil.rmtree(self._rendezvous, ignore_errors=True)
            self._rendezvous = None

    # -- trainer-shaped interface -------------------------------------------

    def train_epoch(self) -> Dict[str, float]:
        reps = self._command({"cmd": "epoch"}, "train epoch")
        self.epoch = int(reps[0]["epoch"])
        self.epoch_stats.append({
            "epoch": self.epoch,
            "epoch_s": max(r["epoch_s"] for r in reps),
            "rank_epoch_s": [r["epoch_s"] for r in reps],
            **{k: [r[k] for r in reps] for k in ("wait_s", "wire_s", "wire_bytes",
                                                   "launches", "send_gathers")},
            "grad_norm": float(reps[0]["grad_norm"])})
        return {"loss": float(reps[0]["loss"]),
                "train_acc": float(reps[0]["train_acc"]),
                "epoch_s": float(self.epoch_stats[-1]["epoch_s"])}

    def evaluate(self) -> float:
        """Eval accuracy over the sync fp32 schedule (``eval_sm``)."""
        reps = self._command({"cmd": "eval"}, "evaluate")
        self.eval_launches = [r["launches"] for r in reps]
        return float(reps[0]["eval_acc"])

    def summary(self) -> dict:
        table, total = ShmArena.layout(self._arrays)
        out = {"mode": "shard_map", "nprocs": self.nprocs, "backend": self.backend,
               "devices": self.devices, "mesh": self.mesh.shape, "token": self.token,
               "parent_rss": rss_bytes(), "epoch_stats": self.epoch_stats,
               "store_bytes": int(total), "store_arrays": len(table)}
        if self._started:
            out["ranks"] = self._command({"cmd": "summary"}, "summary")
        return out

    def lower_step(self, epoch: Optional[int] = None,
                   wrap: Optional[Callable] = None) -> RankPrograms:
        """Every rank's own training step at ``epoch``'s draws (default: the
        next epoch's), recorded one rank after another in this process on
        ``device``, in a world of the ``fake`` backend (module docstring):
        no fleet starts and no state changes. Each rank is built from the
        runtime's partition arrays, then its forward, backward and
        gradient sum run (``wrap(step)`` runs them, for a caller that
        measures the step alone: the GCN dry-run counts its FLOPs). Raises
        if the ranks' programs differ (:func:`check_one_program`) or the
        ``fake`` backend does not open."""
        import torch.distributed as dist

        e = self.epoch if epoch is None else int(epoch)
        if dist.is_initialized():
            raise RuntimeError("lowering a shard_map step opens a world of its own; "
                               "this process is already in one")
        manifest = {"spec": self.spec.to_dict(), "meta": self._meta,
                    "device": str(self.device), "randomness": self._randomness,
                    "params": self._params,
                    "dist": {"axes": list(self.mesh.axis_names),
                             "sizes": list(self.mesh.sizes)}}
        programs: List[LoweredStep] = []
        for r in range(self.nprocs):
            rank = None
            try:
                rank = _LowerRank(r, self.nprocs, manifest, views=self._arrays)
                programs.append(rank.lower(e, wrap))
            finally:
                if rank is not None:
                    rank.close()
                if dist.is_initialized():
                    dist.destroy_process_group()
        check_one_program(programs)
        return RankPrograms(ranks=programs, epoch=e, nparts=self.nprocs,
                            stale_levels=programs[0].stale_levels)

    # -- checkpoint/resume -------------------------------------------------

    def train_state(self) -> Dict:
        """The resumable state tree in the JAX package's format: the
        replicated parameters and AdamW state (rank 0's copy, after
        checking that every rank holds the same bits) and, for delayed
        schedules, the halo cache with the ranks on its leading ``(P,)``
        axis, as the JAX package's ``shard_map`` trainer keeps it."""
        reps = self._command({"cmd": "state"}, "state")
        for r, rep in enumerate(reps[1:], start=1):
            for a, b in zip(tree_leaves((rep["params"], rep["opt_state"])),
                            tree_leaves((reps[0]["params"], reps[0]["opt_state"]))):
                if not np.array_equal(a, b):
                    raise RuntimeError(
                        f"shard_map: rank {r}'s replicated state differs from "
                        "rank 0's")
        step, mu, nu = reps[0]["opt_state"]
        state = {"params": tree_map(torch.from_numpy, reps[0]["params"]),
                 "opt_state": AdamWState(step=int(step), mu=tree_map(torch.from_numpy, mu),
                                         nu=tree_map(torch.from_numpy, nu))}
        if self.schedule.uses_cache:
            state["cache"] = [
                tuple(torch.from_numpy(np.stack([rep["cache"][l][i] for rep in reps]))
                      for i in range(len(reps[0]["cache"][l])))
                for l in range(len(reps[0]["cache"]))]
        return state

    def save_train_state(self, manager, meta: Optional[Dict] = None):
        """Snapshot into a :class:`repro_torch.checkpoint.CheckpointManager`
        at step == epoch."""
        m = dict(meta or {})
        m.setdefault("epoch", self.epoch)
        m.setdefault("mode", self.mode)
        return manager.save(self.train_state(), step=self.epoch, meta=m)

    def restore_train_state_from(self, manager, step: Optional[int] = None) -> int:
        """Restore every rank from a manager's checkpoint (the newest valid
        one when ``step`` is None) and fast-forward the epoch; returns the
        restored step. Raises FileNotFoundError when nothing restorable
        exists."""
        from repro_torch.checkpoint.ckpt import restore_train_state
        if step is None:
            valid = manager.valid_steps()
            if not valid:
                raise FileNotFoundError(f"no valid checkpoint under {manager.dir}")
            step = valid[-1]
        state, manifest = restore_train_state(manager.path_for(step), self.train_state())
        epoch = int(manifest.get("meta", {}).get("epoch", manifest.get("step") or step))
        opt = state["opt_state"]
        common = {"cmd": "load", "params": _np(state["params"]),
                  "opt_state": (opt.step, _np(opt.mu), _np(opt.nu)), "epoch": epoch}
        msgs: Sequence[dict] = [
            {**common, **({"cache": [[c[r].numpy() for c in layer]
                                     for layer in state["cache"]]}
                          if self.schedule.uses_cache else {})}
            for r in range(self.nprocs)]
        reps = self._command(list(msgs), "restore")
        self.epoch = int(reps[0]["epoch"])
        return step
