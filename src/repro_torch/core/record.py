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

The span recorder (:data:`SPANS`, the second half of this module) times
where the step's work runs: named ranges at the call sites of the
training step (``gnn.*``) and of the set-up (``setup.*``), each with the
scope above as attributes (layer, level, role, direction) and its parent.
A step's spans are live only while torch's profiler records; then each
opens a host range the profiler lists (``RecordFunctionFast``, which
casts no range onto the device timeline, as ``record_function`` would),
records a CUDA event at entry and at exit on the current stream, and
keeps its host seconds. Off, a site costs one flag check. A backward is
timed by hooking the forward's own autograd node (:func:`backward_of`),
under the forward span's name, direction backward. The set-up spans (the
partition and its labels) always run, on the host clock alone.
:func:`traced_steps` and :func:`setup_spans` read the records (the events
are resolved then, once the profiled window has closed).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

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


# --------------------------------------------------------------------------
# Spans: where the traced step's time goes, and the set-up's
# --------------------------------------------------------------------------

# The records kept (the newest): one per traced step, one per set-up root.
STEPS_KEPT = 64
SETUPS_KEPT = 64

# The fixed vocabulary. No name holds a kernel's name, so a roofline that
# matches kernel names never counts a span.
STEP_SPANS = (
    "gnn.step", "gnn.forward", "gnn.loss", "gnn.backward", "gnn.adamw",
    "gnn.lp_embed", "gnn.layer", "gnn.aggregate.local", "gnn.gat.gather", "gnn.gat.halo",
    "gnn.exchange.issue", "gnn.exchange.finalize", "gnn.exchange.send",
    "gnn.exchange.assemble", "gnn.exchange.send_gather",
    "gnn.exchange.pre_aggregate", "gnn.exchange.wire", "gnn.exchange.pre_wire",
    "gnn.exchange.a2a", "gnn.exchange.quantized", "gnn.exchange.quantize",
    "gnn.exchange.dequantize", "gnn.exchange.post_wire", "gnn.exchange.scatter",
)
SETUP_SPANS = ("setup.partition", "setup.partition.labels")
_STEP_NAMES = frozenset(STEP_SPANS)
_SETUP_NAMES = frozenset(SETUP_SPANS)
BACKWARD = "gnn.backward"

# The host range the profiler lists for a span (absent on an old torch).
_HostRange = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_OFF = contextlib.nullcontext()


@dataclass(slots=True)
class Span:
    """One named range: its parent (an index into its record's spans, None
    for the root), the scope it ran in, its seconds on the host's clock
    and, in a step on the card, on the device between its two events
    (None on the CPU). Self times leave out the children's."""

    name: str
    parent: Optional[int] = None
    layer: Optional[int] = None
    level: str = ""
    role: str = ""
    direction: str = "forward"
    which: str = ""
    host_s: float = 0.0
    device_s: Optional[float] = None
    self_host_s: float = 0.0
    self_device_s: Optional[float] = None


@dataclass
class SpanRecord:
    """The spans of one traced step (its ``epoch``) or of one set-up root,
    in the order they opened; span 0 is the root."""

    epoch: Optional[int] = None
    cuda: bool = False
    spans: List[Span] = field(default_factory=list)
    backward: Optional[int] = None   # the step's backward span
    # Per span: its start event while open, (start, end) once closed;
    # emptied once read.
    _events: list = field(default_factory=list, repr=False)

    def children(self, i: int) -> List[int]:
        return [j for j, s in enumerate(self.spans) if s.parent == i]

    def descendants(self, i: int) -> List[int]:
        out, todo = [], [i]
        while todo:
            kids = self.children(todo.pop())
            out += kids
            todo += kids
        return out

    def outermost(self, match: str) -> List[Span]:
        """The spans named ``match`` (or under the prefix ``match``, which
        ends in ".") with no such ancestor: a sum over them counts no
        time twice."""
        hit = [_matches(s.name, match) for s in self.spans]
        out = []
        for i, s in enumerate(self.spans):
            p = s.parent
            while hit[i] and p is not None and not hit[p]:
                p = self.spans[p].parent
            if hit[i] and p is None:
                out.append(s)
        return out

    def device_ms(self, match: str) -> Optional[float]:
        """Device ms of :meth:`outermost` (None without device times)."""
        spans = self.outermost(match)
        if any(s.device_s is None for s in spans) or not self.cuda:
            return None
        return 1e3 * sum(s.device_s for s in spans)

    def resolve(self) -> "SpanRecord":
        """Read the events once (waiting for the card), and the self times."""
        if any(isinstance(ev, tuple) for ev in self._events):
            for s, ev in zip(self.spans, self._events):
                if isinstance(ev, tuple):
                    ev[1].synchronize()
                    s.device_s = ev[0].elapsed_time(ev[1]) * 1e-3
            self._events = []
        kids_host = [0.0] * len(self.spans)
        kids_device = [0.0] * len(self.spans)
        for s in self.spans:
            if s.parent is not None:
                kids_host[s.parent] += s.host_s
                kids_device[s.parent] += s.device_s or 0.0
        for s, h, d in zip(self.spans, kids_host, kids_device):
            s.self_host_s = s.host_s - h
            s.self_device_s = None if s.device_s is None else s.device_s - d
        return self


def _matches(name: str, match: str) -> bool:
    return name.startswith(match) if match.endswith(".") else name == match


class SpanRecorder:
    """The kept records: ``steps`` (one per traced step) and ``setups``
    (one per set-up root and its children). ``step`` is the step being
    traced. Each thread keeps its own stack of open spans, since autograd
    runs the card's backward on a thread of its own: a span that opens
    there with an empty stack takes the step's backward span as parent."""

    def __init__(self):
        self.steps: deque = deque(maxlen=STEPS_KEPT)
        self.setups: deque = deque(maxlen=SETUPS_KEPT)
        self.step: Optional[SpanRecord] = None
        self._local = threading.local()

    def stack(self, kind: str = "step") -> list:
        """This thread's open spans of ``kind`` ("step" or "setup"), as
        (record, index) pairs."""
        return self._local.__dict__.setdefault(kind, [])


SPANS = SpanRecorder()
_NO_SCOPE = Span("")


def _host_range(name: str):
    if _HostRange is None or not _profiler._is_profiler_enabled:
        return None
    rf = _HostRange(name)
    rf.__enter__()
    return rf


def _pop(stack: list, top: tuple) -> None:
    if stack and stack[-1] == top:
        stack.pop()
    elif top in stack:
        stack.remove(top)


class _LiveSpan:
    """A step span while the profiler records (see :func:`span`)."""

    __slots__ = ("name", "scope", "layer", "level", "role", "which", "direction",
                 "rec", "i", "rf", "t0")

    def __init__(self, name: str, scope: Optional[Span] = None,
                 layer: Optional[int] = None, level: Optional[str] = None,
                 role: Optional[str] = None, which: Optional[str] = None,
                 direction: Optional[str] = None):
        if name not in _STEP_NAMES:
            raise ValueError(f"unknown span {name!r}")
        self.name, self.scope = name, scope
        self.layer, self.level, self.role = layer, level, role
        self.which, self.direction = which, direction

    def _record(self) -> Optional[SpanRecord]:
        return SPANS.step

    def __enter__(self) -> Optional[Span]:
        self.rf = _host_range(self.name)
        rec = self.rec = self._record()
        if rec is None:
            return None
        stack = SPANS.stack()
        if stack and stack[-1][0] is rec:
            parent = stack[-1][1]
        elif rec.spans:
            parent = 0 if rec.backward is None else rec.backward
        else:
            parent = None
        base = self.scope or (_NO_SCOPE if parent is None else rec.spans[parent])
        s = Span(self.name, parent,
                 base.layer if self.layer is None else self.layer,
                 base.level if self.level is None else self.level,
                 base.role if self.role is None else self.role,
                 base.direction if self.direction is None else self.direction,
                 base.which if self.which is None else self.which)
        self.i = len(rec.spans)
        rec.spans.append(s)
        if self.name == BACKWARD:
            rec.backward = self.i
        stack.append((rec, self.i))
        start = None
        if rec.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        rec._events.append(start)
        self.t0 = time.perf_counter()
        return s

    def __exit__(self, *exc) -> None:
        rec = self.rec
        if rec is not None:
            rec.spans[self.i].host_s = time.perf_counter() - self.t0
            if rec.cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                rec._events[self.i] = (rec._events[self.i], end)
            _pop(SPANS.stack(), (rec, self.i))
        if self.rf is not None:
            self.rf.__exit__(None, None, None)


class _StepRoot(_LiveSpan):
    """The root of a traced step: opens its record, and keeps it on exit."""

    __slots__ = ("epoch", "cuda")

    def __init__(self, epoch: int, device):
        super().__init__("gnn.step")
        self.epoch, self.cuda = epoch, torch.device(device).type == "cuda"

    def _record(self) -> SpanRecord:
        SPANS.step = SpanRecord(epoch=int(self.epoch), cuda=self.cuda)
        return SPANS.step

    def __exit__(self, *exc) -> None:
        super().__exit__(*exc)
        if SPANS.step is self.rec:
            SPANS.steps.append(self.rec)
            SPANS.step = None


def trace_step(epoch: int, device):
    """The root span of one training step (``gnn.step``) on ``device``; a
    no-op unless the profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _StepRoot(epoch, device)


def span(name: str, *, layer: Optional[int] = None, level: Optional[str] = None,
         role: Optional[str] = None, which: Optional[str] = None,
         direction: Optional[str] = None):
    """A span of the traced step inside ``with``; its attributes default to
    its parent's. A no-op unless the profiler records (and outside a
    traced step, only the host range)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _LiveSpan(name, layer=layer, level=level, role=role, which=which,
                     direction=direction)


def _hook_backward(node, fwd: Span, last=None) -> None:
    """Open ``fwd``'s backward span around the autograd node ``node`` (to
    the end of ``last``'s, when given): a pre-hook opens it, a post-hook
    closes it. Neither changes a gradient."""
    opened: list = []

    def pre(grad_outputs):
        cm = _LiveSpan(fwd.name, scope=fwd, direction="backward")
        cm.__enter__()
        opened.append(cm)

    def post(grad_inputs, grad_outputs):
        if opened:
            opened.pop().__exit__(None, None, None)

    node.register_prehook(pre)
    (node if last is None else last).register_hook(post)


def _open_step_span() -> Optional[Span]:
    """The innermost span this thread has open in the traced step."""
    stack = SPANS.stack()
    if stack and stack[-1][0] is SPANS.step:
        return SPANS.step.spans[stack[-1][1]]
    return None


def backward_of(out: torch.Tensor) -> torch.Tensor:
    """``out``; while a step is traced, its own autograd node (the op that
    made it) runs its backward under the innermost open span of this
    thread, that span's name and scope, direction backward. Call it inside
    the span's ``with``. Nothing traces: no hook."""
    if not _profiler._is_profiler_enabled or out.grad_fn is None:
        return out
    fwd = _open_step_span()
    if fwd is not None:
        _hook_backward(out.grad_fn, fwd)
    return out


def backward_between(out: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    """``out``, made inside the innermost open span from ``first`` (made
    there first); while a step is traced, the backward from ``out``'s own
    autograd node to the end of ``first``'s runs under that span, direction
    backward. Autograd runs the ready node made last first, so the nodes
    made between the two run before ``first``'s, and none made before them
    runs amid them. Nothing traces: no hook."""
    if (not _profiler._is_profiler_enabled or out.grad_fn is None
            or first.grad_fn is None):
        return out
    fwd = _open_step_span()
    if fwd is not None:
        _hook_backward(out.grad_fn, fwd, last=first.grad_fn)
    return out


def indexed(t: torch.Tensor, idx: torch.Tensor, name: str,
            which: Optional[str] = None) -> torch.Tensor:
    """``t[idx]``; while the profiler records, under the span ``name`` with
    its backward (the index op's own ``IndexBackward0`` node, which runs
    the sort-based ``indexing_backward_kernel`` on the card) hooked under
    the same name."""
    if not _profiler._is_profiler_enabled:
        return t[idx]
    with _LiveSpan(name, which=which):
        return backward_of(t[idx])


class setup_span:
    """A set-up span (``setup.*``): host seconds, kept whether or not a
    profiler records (and then also listed as a host range). A context
    manager, or a decorator that opens one around each call."""

    __slots__ = ("name", "rec", "i", "rf", "t0")

    def __init__(self, name: str):
        if name not in _SETUP_NAMES:
            raise ValueError(f"unknown set-up span {name!r}")
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with setup_span(name):
                return fn(*args, **kwargs)
        return run

    def __enter__(self) -> Span:
        stack = SPANS.stack("setup")
        if stack:
            self.rec, parent = stack[-1][0], stack[-1][1]
        else:
            self.rec, parent = SpanRecord(), None
            SPANS.setups.append(self.rec)
        s = Span(self.name, parent)
        self.i = len(self.rec.spans)
        self.rec.spans.append(s)
        self.rec._events.append(None)
        stack.append((self.rec, self.i))
        self.rf = _host_range(self.name)
        self.t0 = time.perf_counter()
        return s

    def __exit__(self, *exc) -> None:
        self.rec.spans[self.i].host_s = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _pop(SPANS.stack("setup"), (self.rec, self.i))


def traced_steps() -> List[SpanRecord]:
    """The kept step records, oldest first, resolved: call it once the
    profiled window has closed (it waits for the card)."""
    return [r.resolve() for r in SPANS.steps]


def setup_spans() -> List[SpanRecord]:
    """The kept set-up records (a root and its children each), oldest
    first, with self times."""
    return [r.resolve() for r in SPANS.setups]


def step_device_ms(steps: int, match: str) -> Optional[float]:
    """The mean over the last ``steps`` traced steps of the device ms of the
    outermost spans ``match`` names (:meth:`SpanRecord.outermost`): None
    with fewer records, or without device times (the CPU)."""
    recs = traced_steps()[-steps:] if steps > 0 else []
    if len(recs) < steps or not recs:
        return None
    ms = [r.device_ms(match) for r in recs]
    return None if any(m is None for m in ms) else sum(ms) / len(ms)


def setup_seconds(name: str, within: Optional[str] = None) -> Optional[float]:
    """Host seconds of the newest set-up span ``name``; with ``within``,
    of the spans ``name`` under the newest span ``within`` (summed).
    None when no such span was kept."""
    for rec in reversed(setup_spans()):
        roots = [i for i, s in enumerate(rec.spans) if s.name == (within or name)]
        if not roots:
            continue
        if within is None:
            return rec.spans[roots[-1]].host_s
        inner = [rec.spans[j].host_s for j in rec.descendants(roots[-1])
                 if rec.spans[j].name == name]
        return sum(inner) if inner else None
    return None
