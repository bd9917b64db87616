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
autograd's transposes of the fp32 pre- and post-wire are not seen), the
quantizer pair, and the forward aggregations (local graph, send-side
pre-aggregation, receive scatter). The aggregation kernel's own backward
is not recorded.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Tuple

COLLECTIVE_KINDS = ("all-to-all", "psum_scatter", "all_gather")
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
    shape: Tuple[int, ...] = ()   # stacked: [P, ...]
    bytes: int = 0                # per worker
    # all-to-all: the chunks it splits each worker's buffer into (one per
    # peer); psum_scatter / all_gather: the workers of a group it spans.
    chunks: Optional[int] = None

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

    def __init__(self):
        self.ops: List[StepOp] = []
        self.layer: Optional[int] = None
        self.level: str = ""
        self.direction = "forward"

    def scope(self) -> Tuple[Optional[int], str]:
        return self.layer, self.level

    @contextlib.contextmanager
    def backward(self, scope: Tuple[Optional[int], str]) -> Iterator[None]:
        saved = self.layer, self.level, self.direction
        self.layer, self.level = scope
        self.direction = "backward"
        try:
            yield
        finally:
            self.layer, self.level, self.direction = saved

    def note(self, kind: str, out, *, chunks: Optional[int] = None,
             role: str = "", level: Optional[str] = None) -> None:
        """Record ``kind`` producing ``out`` (a stacked [P, ...] tensor);
        reads only its shape and dtype, so the device is never waited on."""
        shape = tuple(int(d) for d in out.shape)
        nbytes = out.numel() * out.element_size() // max(shape[0], 1)
        self.ops.append(StepOp(
            kind=kind, klass=_klass(kind), index=len(self.ops),
            direction=self.direction, layer=self.layer,
            level=self.level if level is None else level, role=role,
            dtype=str(out.dtype).replace("torch.", ""), shape=shape,
            bytes=int(nbytes), chunks=chunks))

    def signature(self, start: int = 0) -> tuple:
        """The kinds, shapes and dtypes of the ops from ``start`` on: what
        a compiled step's cache key would hold."""
        return tuple(o.signature() for o in self.ops[start:])


@dataclass
class LoweredStep:
    """One recorded training step (forward and backward): the ops in call
    order plus the epoch it ran at and the delayed stages that epoch left
    stale (their wire does not run)."""

    ops: List[StepOp] = field(default_factory=list)
    epoch: int = 0
    nparts: int = 0
    stale_levels: Tuple[str, ...] = ()

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
        (``inter_wire_before_compute``). The top-level flags hold for
        every layer; ``first_*`` are the first failing layer's (else the
        first layer's); ``layers`` lists each layer's."""
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
            compute = first(lambda o: o.klass == "compute" and o.role == "local")
            per_layer.append({
                "layer": layer,
                "first_wire": as_event(wire),
                "first_inter_wire": as_event(inter),
                "first_compute": as_event(compute),
                "wire_before_compute": precedes(wire, compute),
                "inter_wire_before_compute": precedes(inter, compute),
            })
        failing = [d for d in per_layer if not (d["wire_before_compute"]
                                                and d["inter_wire_before_compute"])]
        pick = (failing or per_layer or [{}])[0]
        return {
            "events": [o.as_event() for o in self.ops],
            "first_wire": pick.get("first_wire"),
            "first_inter_wire": pick.get("first_inter_wire"),
            "first_compute": pick.get("first_compute"),
            "wire_before_compute": bool(per_layer) and all(
                d["wire_before_compute"] for d in per_layer),
            "inter_wire_before_compute": bool(per_layer) and all(
                d["inter_wire_before_compute"] for d in per_layer),
            "layers": per_layer,
        }

    def as_text(self) -> str:
        """One line per op (the port's ``lowered.as_text()``)."""
        head = (f"# recorded step: epoch {self.epoch}, {self.nparts} workers, "
                f"stale stages {list(self.stale_levels)}")
        lines = [head]
        for o in self.ops:
            layer = "-" if o.layer is None else o.layer
            lines.append(
                f"{o.index:5d} {o.direction:8s} L{layer} {o.level or '-':5s} "
                f"{o.kind:14s} {o.role or '-':7s} {o.dtype}{list(o.shape)} "
                f"bytes/worker={o.bytes} chunks={o.chunks}")
        return "\n".join(lines) + "\n"
