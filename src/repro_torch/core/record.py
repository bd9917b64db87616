"""The step recorder and the recorded step it yields.

``core.exchange.recording()`` switches on a :class:`StepRecorder`; the
hooks in ``core/exchange.py`` and ``core/trainer.py`` then note every wire
op and every aggregation in call order as a :class:`StepOp`: its kind,
the exchange stage and layer it belongs to, forward or backward, dtype,
stacked shape, bytes per worker and chunk count.
``DistributedTrainer.lower_step`` runs one forward and backward of the
current state under the recorder and returns the :class:`LoweredStep`.
The auditor (``repro_torch.analysis``) reads it; these types live in the
core layer so that the trainer does not import the layer above it.

What the recorder sees: every all-to-all (forward, and backward through
its ``autograd.Function``), the psum_scatter and all_gather of a grouped
stage where Python calls them (the quantized wire's backward included;
in a stacked step autograd's transposes of the fp32 pre- and post-wire
are not seen), the quantizer pair, and the forward aggregations (local
graph, send-side pre-aggregation, receive scatter). The aggregation
kernel's own backward is not recorded.

A ``shard_map`` run has no stacked step: each rank records its own
program (``launch.spmd.ShardMapRuntime.lower_step``), with the process
group of every collective it issues and the gradient sum (``psum``), and
:class:`RankPrograms` holds one :class:`LoweredStep` per rank. There every
transpose is issued from Python (``core.exchange.CollectiveWire``), so
nothing is left unseen.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Tuple

# "psum" is the gradient sum over all workers (a rank program's; the JAX
# package's all-reduce): a collective, not a wire starter.
COLLECTIVE_KINDS = ("all-to-all", "psum_scatter", "all_gather", "psum")
QUANT_KINDS = ("quant_pack", "dequant_unpack")
# The local aggregation: the bucketed kernel ("ell") or the edge-order
# scatter-add ("coo").
COMPUTE_KINDS = ("seg_aggregate", "index_add")

# Wire starters: the ops that begin a stage's pipeline (the grouped inter
# stage opens with its psum_scatter, an a2a stage with the all-to-all).
WIRE_START = ("all-to-all", "psum_scatter")

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def _klass(kind: str) -> str:
    if kind in COLLECTIVE_KINDS:
        return "collective"
    if kind in QUANT_KINDS:
        return "quant"
    if kind in COMPUTE_KINDS:
        return "compute"
    raise ValueError(f"unknown step op kind {kind!r}")


@dataclass(frozen=True)
class StepOp:
    """One recorded op, in call order."""

    kind: str                     # "all-to-all", "quant_pack", "seg_aggregate", ...
    klass: str                    # "collective" | "quant" | "compute"
    index: int                    # position in the step
    direction: str = "forward"    # "forward" | "backward"
    layer: Optional[int] = None
    level: str = ""               # the exchange stage ("flat", "intra", "inter")
    # all-to-all: "payload" (feature rows or packed words) or "params" (the
    # fp32 (zero, scale) per 4-row group); aggregation: "local", "send"
    # (pre-aggregation into the wire slots) or "recv" (receive scatter).
    role: str = ""
    dtype: str = ""               # torch dtype name without "torch."
    shape: Tuple[int, ...] = ()   # stacked: [P, ...]; a rank's: its own buffer
    bytes: int = 0                # per worker
    # all-to-all: the chunks it splits each worker's buffer into (one per
    # peer); psum_scatter / all_gather: the workers of a group it spans.
    chunks: Optional[int] = None
    # A rank program's collective: the global ranks of its process group
    # (empty in a stacked step, which has no process groups).
    group: Tuple[int, ...] = ()

    @property
    def group_size(self) -> Optional[int]:
        return self.chunks

    @property
    def trailing_dim(self) -> Optional[int]:
        return self.shape[-1] if self.shape else None

    @property
    def is_float(self) -> bool:
        return self.dtype in _FLOAT_DTYPES

    def signature(self) -> tuple:
        return (self.kind, self.direction, self.level, self.role, self.dtype,
                self.shape)

    def program_key(self) -> tuple:
        """What every rank of one program must agree on: a rank that issues
        another collective, or one over a group of another size, would
        leave its peers waiting."""
        return (self.kind, self.direction, self.layer, self.level, self.role,
                self.dtype, len(self.group))

    def wire_bytes(self) -> int:
        """The bytes this collective delivers to a rank, counted as the
        rank's ``wire_bytes`` counts them (``core.exchange.CollectiveWire``,
        ``launch.spmd``): an all-to-all's buffer once, a psum_scatter's
        input (its result times the group), an all_gather's result, and a
        psum's P gathered copies of its vector."""
        if self.kind in ("psum_scatter", "psum"):
            return self.bytes * (self.chunks or 1)
        return self.bytes if self.klass == "collective" else 0

    def as_event(self) -> dict:
        return {"line": self.index, "op": self.kind, "class": self.klass,
                "group_size": self.chunks if self.klass == "collective" else None,
                "layer": self.layer, "level": self.level,
                "direction": self.direction}


class StepRecorder:
    """Collects :class:`StepOp`\\ s while ``core.exchange.RECORDER`` is set.
    ``layer`` and ``level`` are the scope the trainer and the layer
    program set as they go; a backward op replays the scope its forward
    op was recorded in."""

    def __init__(self, rank: Optional[int] = None):
        self.ops: List[StepOp] = []
        self.rank = rank              # None: a stacked step
        self.layer: Optional[int] = None
        self.level: str = ""
        self.direction = "forward"

    def scope(self) -> Tuple[Optional[int], str]:
        return self.layer, self.level

    @contextlib.contextmanager
    def scoped(self, scope: Tuple[Optional[int], str],
               direction: str = "forward") -> Iterator[None]:
        """Record in ``scope`` (layer, level) and ``direction`` inside the
        block: an op that finishes what another began, out of its scope."""
        saved = self.layer, self.level, self.direction
        self.layer, self.level = scope
        self.direction = direction
        try:
            yield
        finally:
            self.layer, self.level, self.direction = saved

    def backward(self, scope: Tuple[Optional[int], str]):
        return self.scoped(scope, "backward")

    def note(self, kind: str, out, *, chunks: Optional[int] = None,
             role: str = "", level: Optional[str] = None,
             group: Tuple[int, ...] = ()) -> None:
        """Record ``kind`` producing ``out``: a stacked [P, ...] tensor, or
        under a rank's recorder the rank's own buffer (``[rows, F]`` or
        ``[1, rows, F]``; a meta tensor where the op's result is not one
        buffer). Reads only its shape and dtype, so the device is never
        waited on."""
        shape = tuple(int(d) for d in out.shape)
        nbytes = out.numel() * out.element_size()
        if self.rank is None:
            nbytes //= max(shape[0], 1)
        self.ops.append(StepOp(
            kind=kind, klass=_klass(kind), index=len(self.ops),
            direction=self.direction, layer=self.layer,
            level=self.level if level is None else level, role=role,
            dtype=str(out.dtype).replace("torch.", ""), shape=shape,
            bytes=int(nbytes), chunks=chunks, group=tuple(group)))

    def signature(self, start: int = 0) -> tuple:
        """The kinds, shapes and dtypes of the ops from ``start`` on: what
        a compiled step's cache key would hold."""
        return tuple(o.signature() for o in self.ops[start:])


@dataclass
class LoweredStep:
    """One recorded training step (forward and backward): the ops in call
    order plus the epoch it ran at and the delayed stages that epoch left
    stale (their wire does not run). ``rank`` is the rank whose own
    program it is, None for a stacked step of all workers."""

    ops: List[StepOp] = field(default_factory=list)
    epoch: int = 0
    nparts: int = 0
    stale_levels: Tuple[str, ...] = ()
    rank: Optional[int] = None

    @property
    def programs(self) -> Tuple["LoweredStep", ...]:
        """The per-worker programs: this step itself."""
        return (self,)

    def wire_bytes(self) -> int:
        """Σ :meth:`StepOp.wire_bytes` over the recorded collectives."""
        return sum(o.wire_bytes() for o in self.collectives())

    def walk(self, pred: Optional[Callable[[StepOp], bool]] = None
             ) -> List[StepOp]:
        return [o for o in self.ops if pred is None or pred(o)]

    def collectives(self, kind: Optional[str] = None) -> List[StepOp]:
        return self.walk(lambda o: o.klass == "collective"
                         and (kind is None or o.kind == kind))

    def computes(self) -> List[StepOp]:
        return self.walk(lambda o: o.klass == "compute")

    def collective_order(self) -> dict:
        """Overlap evidence with the keys of the JAX package's
        ``collective_order``, taken per layer of the forward: a layer
        passes when its first wire op comes before its local aggregation
        (``wire_before_compute``), and its first inter-stage wire op too
        (``inter_wire_before_compute``). The port adds
        ``inter_a2a_before_compute``: the inter stage's all-to-all too
        (the wire between groups, which the aggregation is to hide). The
        top-level flags hold for every layer; ``first_*`` are the first
        failing layer's (else the first layer's); ``layers`` lists each
        layer's."""
        def precedes(a: Optional[StepOp], b: Optional[StepOp]) -> bool:
            return a is not None and b is not None and a.index < b.index

        def as_event(o: Optional[StepOp]):
            return None if o is None else o.as_event()

        fwd = [o for o in self.ops if o.direction == "forward"]
        layers = sorted({o.layer for o in fwd if o.layer is not None})
        per_layer = []
        for layer in layers:
            ops = [o for o in fwd if o.layer == layer]
            first = lambda pred: next((o for o in ops if pred(o)), None)
            wire = first(lambda o: o.kind in WIRE_START)
            inter = first(lambda o: o.kind in WIRE_START and o.level == "inter")
            inter_a2a = first(lambda o: o.kind == "all-to-all" and o.level == "inter")
            compute = first(lambda o: o.klass == "compute" and o.role == "local")
            per_layer.append({
                "layer": layer,
                "first_wire": as_event(wire),
                "first_inter_wire": as_event(inter),
                "first_compute": as_event(compute),
                "wire_before_compute": precedes(wire, compute),
                "inter_wire_before_compute": precedes(inter, compute),
                "inter_a2a_before_compute": precedes(inter_a2a, compute),
            })
        flags = ("wire_before_compute", "inter_wire_before_compute",
                 "inter_a2a_before_compute")
        failing = [d for d in per_layer if not all(d[k] for k in flags)]
        pick = (failing or per_layer or [{}])[0]
        return {
            "events": [o.as_event() for o in self.ops],
            "first_wire": pick.get("first_wire"),
            "first_inter_wire": pick.get("first_inter_wire"),
            "first_compute": pick.get("first_compute"),
            **{k: bool(per_layer) and all(d[k] for d in per_layer) for k in flags},
            "layers": per_layer,
        }

    def as_text(self) -> str:
        """One line per op (the port's ``lowered.as_text()``)."""
        who = ("" if self.rank is None else f"rank {self.rank} of ")
        head = (f"# recorded step: epoch {self.epoch}, {who}{self.nparts} workers, "
                f"stale stages {list(self.stale_levels)}")
        lines = [head]
        for o in self.ops:
            layer = "-" if o.layer is None else o.layer
            group = f" group={list(o.group)}" if o.group else ""
            lines.append(
                f"{o.index:5d} {o.direction:8s} L{layer} {o.level or '-':5s} "
                f"{o.kind:14s} {o.role or '-':7s} {o.dtype}{list(o.shape)} "
                f"bytes/worker={o.bytes} chunks={o.chunks}{group}")
        return "\n".join(lines) + "\n"


@dataclass
class RankPrograms:
    """A lowered ``shard_map`` step: one :class:`LoweredStep` per rank, each
    the rank's own program (``launch.spmd.ShardMapRuntime.lower_step``).
    Its ops are read a rank at a time through :attr:`programs` (a
    ``LoweredStep``'s ``programs`` is itself alone), so that a sum over
    one program is a per-worker figure; ``collective_order`` holds a flag
    only where it holds on every rank, and ``as_text`` prints each rank's
    program."""

    ranks: List[LoweredStep] = field(default_factory=list)
    epoch: int = 0
    nparts: int = 0
    stale_levels: Tuple[str, ...] = ()

    @property
    def programs(self) -> Tuple[LoweredStep, ...]:
        return tuple(self.ranks)

    def collective_order(self) -> dict:
        """Rank 0's :meth:`LoweredStep.collective_order` (the first failing
        rank's where one fails), each flag the AND over the ranks, and
        ``ranks``: every rank's flags."""
        orders = [r.collective_order() for r in self.ranks]
        if not orders:
            return LoweredStep().collective_order()
        flags = ("wire_before_compute", "inter_wire_before_compute",
                 "inter_a2a_before_compute")
        failing = [o for o in orders if not all(o[k] for k in flags)]
        out = dict((failing or orders)[0])
        out.update({k: all(o[k] for o in orders) for k in flags})
        out["ranks"] = [{k: o[k] for k in flags} for o in orders]
        return out

    def as_text(self) -> str:
        return "".join(r.as_text() for r in self.ranks)
