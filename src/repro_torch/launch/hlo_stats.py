"""Collective, FLOP and traffic statistics of one recorded training step
(counterpart of ``repro.launch.hlo_stats``).

The JAX package parses them out of HLO text. The port has no HLO: its
lowered program is the recorded step, ``core.record.LoweredStep``
(``Session.lower()``), so every function here takes a ``LoweredStep`` or
a callable, never text.

* :func:`parse_collectives` sums the recorded collectives per kind, with
  the JAX package's dict shape. A recorded op's ``bytes`` is its result per
  worker and its ``chunks`` the group size g; the operand and ring wire
  bytes per worker follow the JAX package's table (the rows of the kinds
  the port runs; it runs no collective-permute)::

    op                  operand bytes      ring wire bytes per device
    all-gather          result / g         result * (g-1)/g
    all-reduce          result             result * 2(g-1)/g
    reduce-scatter      result * g         result * (g-1)
    all-to-all          result             result * (g-1)/g

  The recorder's ``psum_scatter`` is a reduce-scatter, its ``all_gather``
  an all-gather and a rank's ``psum`` (the gradient sum) an all-reduce.
  In a stacked step it does not see autograd's transposes of the fp32
  pre- and post-wire of a grouped stage (``core/record.py``): the result
  says so under ``unrecorded`` and counts no bytes for them. A
  ``shard_map`` step's rank programs record every collective, and the
  result is per worker: each field the most any rank moves.
* :func:`collective_order` is ``LoweredStep.collective_order()``.
* :func:`analyze_step` runs a callable once and counts its matmul FLOPs
  (``torch.utils.flop_counter.FlopCounterMode``) and the bytes of every
  tensor that each non-view op reads and writes, each kernel wrapper's
  call counted as one op (``kernels.traffic``). :func:`trace_step` does
  the same and also follows the bytes of live tensor storages
  (:class:`LiveBytes`); the LM dry-run runs it under ``FakeTensorMode``.

``while_trip_counts`` has no counterpart: the port's loops run, so a
layer loop's ops are recorded (and counted) once per trip.
"""

from __future__ import annotations

import weakref
from collections import Counter
from typing import Callable, Dict, Iterable, Tuple

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import traffic as kernel_traffic

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
# The recorder's collective kinds (core.record.COLLECTIVE_KINDS) under the
# JAX package's names.
RECORDED_AS = {"all-to-all": "all-to-all", "psum_scatter": "reduce-scatter",
               "all_gather": "all-gather", "psum": "all-reduce"}
_FIELDS = ("count", "operand_bytes", "result_bytes", "wire_bytes")
UNRECORDED = ("the backward's transposes of a grouped stage's fp32 "
              "reduce-scatter and all-gather run inside autograd, which the "
              "step recorder does not see: their bytes are not counted here")


def ring_bytes(kind: str, result: float, g: int) -> Tuple[float, float]:
    """(operand, wire) bytes per worker of a ``kind`` collective whose
    result per worker is ``result`` bytes, over a group of ``g``."""
    g = max(int(g), 1)
    if kind == "all-gather":
        return result / g, result * (g - 1) / g
    if kind == "all-reduce":
        return result, result * 2 * (g - 1) / g
    if kind == "reduce-scatter":
        return result * g, result * (g - 1)
    if kind == "all-to-all":
        return result, result * (g - 1) / g
    raise ValueError(f"unknown collective kind {kind!r}")


def _zero() -> Dict[str, Dict[str, float]]:
    return {k: dict.fromkeys(_FIELDS, 0.0) for k in KINDS}


def parse_collectives(lowered) -> dict:
    """``{kind: {count, operand_bytes, result_bytes, wire_bytes}}`` for
    each kind the step ran, plus ``total``; per worker and step. A stacked
    step with a grouped stage adds ``unrecorded``; rank programs give each
    field's most over the ranks (module docstring)."""
    per_rank = [_parse_one(p) for p in lowered.programs]
    out = per_rank[0]
    for other in per_rank[1:]:
        for kind, fields in other.items():
            mine = out.setdefault(kind, dict(fields))
            for f, v in fields.items():
                mine[f] = max(mine[f], v)
    return out


def _parse_one(lowered) -> dict:
    acc = _zero()
    grouped = False
    for op in lowered.collectives():
        kind = RECORDED_AS[op.kind]
        grouped = grouped or kind in ("reduce-scatter", "all-gather")
        operand, wire = ring_bytes(kind, float(op.bytes), op.chunks or 1)
        acc[kind]["count"] += 1
        acc[kind]["operand_bytes"] += operand
        acc[kind]["result_bytes"] += float(op.bytes)
        acc[kind]["wire_bytes"] += wire
    total = {f: sum(acc[k][f] for k in KINDS) for f in _FIELDS}
    out: dict = {k: v for k, v in acc.items() if v["count"]}
    out["total"] = total
    if grouped and lowered.rank is None:
        out["unrecorded"] = UNRECORDED
    return out


def collective_order(lowered) -> dict:
    """Program-order evidence of overlap, with the JAX package's keys
    (``events``, ``first_wire``, ``first_inter_wire``, ``first_compute``,
    ``wire_before_compute``, ``inter_wire_before_compute``) and the port's
    per-layer ``layers``: ``LoweredStep.collective_order()``."""
    return lowered.collective_order()


# Ops that move no data: the counterpart of the JAX package's _META_OPS.
# View ops (``OpOverload.is_view``) are skipped besides.
_META_OPS = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "record_stream", "set_", "device"))


def _all(args, kwargs, out):
    return args, kwargs, out


# Ops whose CPU kernel returns a scratch tensor that the CUDA kernel leaves
# empty: log_sigmoid's buffer is the size of its input on the CPU and has
# no elements on the card. The count takes the op's value alone (and
# leaves the buffer out of its backward's operands), so both devices give
# the same figure.
_SCRATCH = {
    "log_sigmoid_forward": lambda args, kwargs, out: (args, kwargs, out[0]),
    "log_sigmoid_backward": lambda args, kwargs, out: (args[:2], kwargs, out),
}


class _Traffic(TorchDispatchMode):
    """Sums the bytes of every tensor operand and result of each op that
    is not a view or a metadata op."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.by_op: Counter = Counter()

    def add(self, n: int) -> None:
        self.bytes += n
        self.by_op["kernel"] += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if not (func.is_view or name in _META_OPS):
            n = kernel_traffic.tensor_bytes(*_SCRATCH.get(name, _all)(args, kwargs or {}, out))
            self.bytes += n
            self.by_op[name] += n
        return out


class LiveBytes(TorchDispatchMode):
    """The peak bytes of tensor storages that ops create while the mode is
    on and that are still alive: each result's storage is counted once when
    it first appears and uncounted when it is freed (followed by weakref).
    The storages of ``held`` tensors (the step's arguments) are never
    counted, so an op that writes into them in place adds nothing. Works
    on real tensors and under ``FakeTensorMode`` alike."""

    def __init__(self, held: Iterable[torch.Tensor] = ()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, weakref.ref] = {}
        for t in held:
            st = t.untyped_storage()
            self._seen[id(st)] = weakref.ref(st)

    def _freed(self, key: int, n: int, ref) -> None:
        if self._seen.get(key) is ref:
            del self._seen[key]
            self.live -= n

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        ref = self._seen.get(key)
        if ref is not None and ref() is st:
            return
        n = st.nbytes()
        self.live += n
        self._seen[key] = weakref.ref(
            st, lambda r, key=key, n=n: self._freed(key, n, r))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track(t)
        self.peak = max(self.peak, self.live)
        return out


def analyze_step(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once; return ``{"dot_flops",
    "traffic_bytes"}`` (counterpart of ``analyze_hlo``).

    ``dot_flops``: the FLOPs ``FlopCounterMode`` counts (matmuls,
    batched matmuls, einsums and convolutions, forward and backward,
    recomputation included). As in the JAX package, the graph aggregation
    is no dot, so its FLOPs are not counted. ``traffic_bytes``: each
    non-view op's tensor operands and results, each counted once per op.
    The kernels of ``repro_torch.kernels`` launch through ctypes, past the
    dispatcher: each wrapper's call counts as one op that reads its tensor
    arguments and writes its results, on the card and on the CPU alike
    (its plain version's ops are not counted), so the two devices give the
    same figure."""
    out = trace_step(lambda: fn(*args, **kwargs))
    return {k: out[k] for k in ("dot_flops", "traffic_bytes")}


def trace_step(fn: Callable[[], object], held: Iterable[torch.Tensor] = ()) -> dict:
    """Run ``fn()`` once under the counters of :func:`analyze_step` and a
    :class:`LiveBytes` that leaves ``held`` out. Returns ``dot_flops``,
    ``traffic_bytes``, ``peak_live_bytes``, ``flop_counts`` (FLOPs by
    module and operator, ``FlopCounterMode.get_flop_counts``) and
    ``bytes_by_op`` (traffic by operator; ``kernel`` for the kernel
    wrappers)."""
    flops = FlopCounterMode(display=False)
    traffic = _Traffic()
    live = LiveBytes(held)
    with flops, traffic, kernel_traffic.counting(traffic.add), live:
        fn()
    counts = {str(mod): {str(op): int(n) for op, n in ops.items()}
              for mod, ops in flops.get_flop_counts().items()}
    return {"dot_flops": float(flops.get_total_flops()),
            "traffic_bytes": float(traffic.bytes),
            "peak_live_bytes": int(live.peak), "flop_counts": counts,
            "bytes_by_op": dict(traffic.by_op)}
