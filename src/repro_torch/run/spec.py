"""RunSpec: one declarative, serializable experiment description.

The paper's results are a *matrix* of configurations — partition strategy
x {flat, hierarchical G x W} x wire bits x delayed-comm cd x aggregation
backend x overlap — and every launcher, benchmark and example used to
assemble its corner of that matrix by hand. A :class:`RunSpec` is the
single entry point instead: five typed sub-specs covering the whole setup
pipeline,

  :class:`GraphSpec`      what graph + features (registry-dispatched
                          sources: ``sbm``, ``rmat``, ``erdos``; synthetic
                          feature hooks: ``sbm``, ``zeros``, ``random``),
  :class:`PartitionSpec`  how it is split (strategy, flat vs hierarchical
                          ``groups``/``group_size`` with auto-derivation),
  :class:`ScheduleSpec`   the exchange schedule knobs (bits/cd per stage,
                          overlap, aggregation backend — lowered onto
                          ``DistConfig``/``ExchangeSchedule``),
  :class:`ModelSpec`      the GCN architecture (``GCNConfig`` fields whose
                          values aren't derived from the graph),
  :class:`ExecSpec`       how it runs (vmap/shard_map, epochs, lr, seed).

Specs round-trip losslessly through ``to_dict()/from_dict()`` and JSON,
and carry a stable content hash (``content_hash()``) stamped into
benchmark artifacts so every recorded number names the exact
configuration that produced it. ``with_overrides(["schedule.bits=2"])``
is the ``--set`` layer every CLI shares.

``repro_torch.run.session.build_session(spec)`` turns a spec into a live
:class:`~repro_torch.run.session.Session` (a copy of ``repro/run/spec.py``,
held to it by ``tests/test_torch_host.py``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import typing
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional

from repro_torch.utils.registry import Registry

# Registry of graph sources: name -> builder(GraphSpec) -> Graph (with
# labels/train_mask populated). Registered in repro_torch.run.sources; external
# workloads can .add() their own and reference them from spec files.
GRAPH_SOURCES: Registry = Registry("graph source")
# Synthetic-features hook: name -> fn(Graph, GraphSpec) -> np.ndarray [N, F].
FEATURE_SOURCES: Registry = Registry("feature source")

_WIRE_BITS = (0, 2, 4, 8)


class SpecError(ValueError):
    """A RunSpec (or an override applied to one) is invalid."""


def _type_hints(cls) -> Dict[str, Any]:
    return typing.get_type_hints(cls)


def _coerce(value: Any, hint: Any, path: str) -> Any:
    """Coerce a JSON/str scalar onto a dataclass field's type hint."""
    origin = typing.get_origin(hint)
    if origin is typing.Union:  # Optional[T]
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if value is None:
            return None
        return _coerce(value, args[0], path)
    if hint is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str) and value.lower() in ("true", "false"):
            return value.lower() == "true"
        raise SpecError(f"{path}: expected bool, got {value!r}")
    if hint is int:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SpecError(f"{path}: expected int, got {value!r}")
        if isinstance(value, float) and not value.is_integer():
            raise SpecError(f"{path}: expected int, got {value!r}")
        return int(value)
    if hint is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SpecError(f"{path}: expected float, got {value!r}")
        return float(value)
    if hint is str:
        if not isinstance(value, str):
            raise SpecError(f"{path}: expected str, got {value!r}")
        return value
    return value


class _SubSpec:
    """Shared dict/JSON plumbing for the frozen sub-spec dataclasses."""

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def content_hash(self) -> str:
        """Stable short id of this sub-spec's content, prefixed by the
        spec kind's initials (``gs-`` for GraphSpec, ``ps-``, ``ss-``,
        ``ms-``, ``es-``) — the per-section analogue of
        ``RunSpec.content_hash``, used for build-cache keys."""
        prefix = "".join(c for c in type(self).__name__ if c.isupper()).lower()
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return f"{prefix}-" + hashlib.sha256(canon.encode()).hexdigest()[:12]

    @classmethod
    def from_dict(cls, d: Dict[str, Any], path: str = ""):
        if not isinstance(d, dict):
            raise SpecError(f"{path or cls.__name__}: expected an object, "
                            f"got {d!r}")
        hints = _type_hints(cls)
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise SpecError(
                f"{path or cls.__name__}: unknown field(s) "
                f"{sorted(unknown)}; known: {sorted(known)}")
        kw = {k: _coerce(v, hints[k], f"{path}.{k}" if path else k)
              for k, v in d.items()}
        return cls(**kw)


@dataclass(frozen=True)
class GraphSpec(_SubSpec):
    """What graph to build and how to synthesize its node features.

    ``source`` dispatches through :data:`GRAPH_SOURCES`; generator knobs
    not used by a source are simply ignored by it (``nodes``/``homophily``
    drive ``sbm``/``erdos``, ``scale``/``edge_factor`` drive ``rmat``).
    ``features`` dispatches through :data:`FEATURE_SOURCES`; the default
    ``auto`` picks block-correlated features when the source plants labels
    (``sbm``) and zeros otherwise (structural runs: ``rmat``/``erdos``).
    """

    source: str = "sbm"
    # sbm / erdos knobs
    nodes: int = 4096
    classes: int = 16          # sbm blocks; also the model's label count
    avg_degree: float = 16.0
    homophily: float = 0.8
    # rmat knobs
    scale: int = 13
    edge_factor: int = 8
    # features
    feat_dim: int = 64
    features: str = "auto"     # auto | sbm | zeros | random
    feat_noise: float = 2.5
    # normalization applied before partitioning (edge weights ride the cut)
    norm: str = "mean"         # mean | gcn | none
    seed: int = 0

    def validate(self) -> None:
        if self.source not in GRAPH_SOURCES:
            raise SpecError(f"graph.source: unknown source "
                            f"{self.source!r}; known: "
                            f"{list(GRAPH_SOURCES)}")
        if self.features != "auto" and self.features not in FEATURE_SOURCES:
            raise SpecError(f"graph.features: unknown feature source "
                            f"{self.features!r}; known: "
                            f"['auto'] + {list(FEATURE_SOURCES)}")
        if self.norm not in ("mean", "gcn", "none"):
            raise SpecError(f"graph.norm must be mean|gcn|none, "
                            f"got {self.norm!r}")
        if self.feat_dim < 1:
            raise SpecError(f"graph.feat_dim must be >= 1, got {self.feat_dim}")
        if self.classes < 1:
            raise SpecError(f"graph.classes must be >= 1, got {self.classes}")


@dataclass(frozen=True)
class PartitionSpec(_SubSpec):
    """How the graph is split across workers.

    ``groups=0`` is the flat P-way partition. ``groups=G`` requests the
    hierarchical two-level partition; ``group_size`` auto-derives as
    ``nparts // groups`` when left 0 (the common case — a spec names the
    worker count once).
    """

    nparts: int = 8
    strategy: str = "hybrid"   # hybrid | pre | post | vanilla
    groups: int = 0            # 0 = flat
    group_size: int = 0        # 0 = auto (nparts // groups)
    # Post-pass over the partition labels: "bucket-max" runs
    # refine_bucket_max (move hub rows off the worker defining each
    # bucket's cross-worker padded-slot max — the stacked-ELL cost the
    # balancer's total-slot objective misses); "none" keeps the raw
    # partitioner output.
    refine: str = "none"       # none | bucket-max
    seed: int = 0

    def validate(self) -> None:
        if self.nparts < 1:
            raise SpecError(f"partition.nparts must be >= 1, got {self.nparts}")
        if self.strategy not in ("hybrid", "pre", "post", "vanilla"):
            raise SpecError(
                f"partition.strategy must be hybrid|pre|post|vanilla, "
                f"got {self.strategy!r}")
        if self.refine not in ("none", "bucket-max"):
            raise SpecError(f"partition.refine must be none|bucket-max, "
                            f"got {self.refine!r}")
        if self.groups < 0 or self.group_size < 0:
            raise SpecError("partition.groups/group_size must be >= 0")
        if self.group_size and not self.groups:
            raise SpecError("partition.group_size needs partition.groups")
        if self.groups:
            if self.nparts % self.groups:
                raise SpecError(
                    f"partition.groups ({self.groups}) must divide "
                    f"partition.nparts ({self.nparts})")
            if self.group_size and self.groups * self.group_size != self.nparts:
                raise SpecError(
                    f"partition.groups * group_size ({self.groups}x"
                    f"{self.group_size}) must equal nparts ({self.nparts})")

    @property
    def hierarchical(self) -> bool:
        return self.groups > 0

    def resolved_group_size(self) -> int:
        """group_size with the ``nparts // groups`` auto-derivation applied."""
        if not self.groups:
            return 0
        return self.group_size or self.nparts // self.groups


@dataclass(frozen=True)
class ScheduleSpec(_SubSpec):
    """Exchange-schedule knobs, lowered onto ``DistConfig`` (and from there
    onto ``ExchangeSchedule``). ``None`` per-stage overrides inherit
    ``bits``/``cd``; note the hierarchical inter stage's *default* wire is
    Int2 (see ``DistConfig.schedule``) — pass ``inter_bits=0`` for an
    explicit fp32 slow wire.
    """

    bits: int = 0
    cd: int = 1
    intra_bits: Optional[int] = None
    inter_bits: Optional[int] = None
    intra_cd: Optional[int] = None
    inter_cd: Optional[int] = None
    overlap: Optional[bool] = None   # None = topology default
    agg_backend: str = "ell"         # ell | coo

    def validate(self, partition: Optional[PartitionSpec] = None) -> None:
        for name in ("bits", "intra_bits", "inter_bits"):
            v = getattr(self, name)
            if v is not None and v not in _WIRE_BITS:
                raise SpecError(f"schedule.{name} must be one of "
                                f"{_WIRE_BITS}, got {v}")
        for name in ("cd", "intra_cd", "inter_cd"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise SpecError(f"schedule.{name} must be >= 1, got {v}")
        if self.agg_backend not in ("coo", "ell"):
            raise SpecError(f"schedule.agg_backend must be coo|ell, "
                            f"got {self.agg_backend!r}")
        if partition is not None and not partition.hierarchical:
            bad = [n for n in ("intra_bits", "inter_bits",
                               "intra_cd", "inter_cd")
                   if getattr(self, n) is not None]
            if bad:
                raise SpecError(
                    f"schedule.{bad[0]} is a per-stage override of the "
                    "hierarchical schedule; set partition.groups as well")

    def to_dist_config(self, partition: PartitionSpec, lr: float = 0.01):
        """Lower onto the trainer's ``DistConfig``."""
        from repro_torch.core import DistConfig
        kw: Dict[str, Any] = dict(
            nparts=partition.nparts, bits=self.bits, cd=self.cd,
            lr=lr, agg_backend=self.agg_backend, overlap=self.overlap)
        if partition.hierarchical:
            kw.update(num_groups=partition.groups,
                      group_size=partition.resolved_group_size(),
                      intra_bits=self.intra_bits, inter_bits=self.inter_bits,
                      intra_cd=self.intra_cd, inter_cd=self.inter_cd)
        return DistConfig(**kw)


@dataclass(frozen=True)
class ModelSpec(_SubSpec):
    """``GCNConfig`` fields that aren't derived from the graph or schedule
    (``in_dim``/``num_classes`` come from :class:`GraphSpec`,
    ``quant_bits`` from :class:`ScheduleSpec`)."""

    model: str = "sage"        # gcn | sage | gin | gat
    hidden_dim: int = 256
    num_layers: int = 3
    dropout: float = 0.5
    norm: str = "layer"        # layer | none
    label_prop: bool = True
    lp_rate: float = 0.5
    gat_heads: int = 4

    def validate(self) -> None:
        if self.model not in ("gcn", "sage", "gin", "gat"):
            raise SpecError(f"model.model must be gcn|sage|gin|gat, "
                            f"got {self.model!r}")
        if self.num_layers < 1:
            raise SpecError(f"model.num_layers must be >= 1, "
                            f"got {self.num_layers}")
        if self.norm not in ("layer", "none"):
            raise SpecError(f"model.norm must be layer|none, got {self.norm!r}")

    def to_gcn_config(self, graph: GraphSpec, schedule: ScheduleSpec):
        from repro_torch.core import GCNConfig
        return GCNConfig(
            model=self.model, in_dim=graph.feat_dim,
            hidden_dim=self.hidden_dim, num_classes=graph.classes,
            num_layers=self.num_layers, dropout=self.dropout,
            norm=self.norm, label_prop=self.label_prop,
            lp_rate=self.lp_rate, quant_bits=schedule.bits,
            gat_heads=self.gat_heads)


@dataclass(frozen=True)
class ExecSpec(_SubSpec):
    """How the run executes: worker mapping, training length, optimizer."""

    mode: str = "vmap"         # vmap | shard_map | multiproc
    epochs: int = 50
    lr: float = 0.01
    seed: int = 0
    # Auto-scheduler resolution: path to a tuner result JSON (written by
    # ``python -m repro_torch.run.tune --out ...``). ``build_session`` swaps in
    # the audited winner's partition + schedule sections before building —
    # the spec names its graph/model/exec and lets the tuner own the
    # performance knobs. Empty = no resolution.
    auto: str = ""
    log_every: int = 0         # 0 = auto (epochs // 10)
    nprocs: int = 0            # multiproc only: 0 = partition.nparts
    # Fault tolerance (multiproc supervision + checkpoint/resume):
    ckpt_every: int = 0        # snapshot period in epochs (0 = off)
    max_restarts: int = 2      # worker respawns before degrading to abort
    heartbeat_s: float = 15.0  # stale-heartbeat hang deadline (0 = off)

    def validate(self) -> None:
        if self.mode not in ("vmap", "shard_map", "multiproc"):
            raise SpecError(f"exec.mode must be vmap|shard_map|multiproc, "
                            f"got {self.mode!r}")
        if self.epochs < 0:
            raise SpecError(f"exec.epochs must be >= 0, got {self.epochs}")
        if self.nprocs < 0:
            raise SpecError(f"exec.nprocs must be >= 0, got {self.nprocs}")
        if self.nprocs and self.mode != "multiproc":
            raise SpecError("exec.nprocs is only meaningful with "
                            f"mode='multiproc', got mode={self.mode!r}")
        if self.ckpt_every < 0:
            raise SpecError(f"exec.ckpt_every must be >= 0 (0 disables "
                            f"checkpointing), got {self.ckpt_every}")
        if self.max_restarts < 0:
            raise SpecError(f"exec.max_restarts must be >= 0, "
                            f"got {self.max_restarts}")
        if self.heartbeat_s < 0:
            raise SpecError(f"exec.heartbeat_s must be >= 0 (0 disables "
                            f"hang detection), got {self.heartbeat_s}")


@dataclass(frozen=True)
class RunSpec:
    """The full declarative experiment: graph x partition x schedule x
    model x exec. See module docstring."""

    graph: GraphSpec = field(default_factory=GraphSpec)
    partition: PartitionSpec = field(default_factory=PartitionSpec)
    schedule: ScheduleSpec = field(default_factory=ScheduleSpec)
    model: ModelSpec = field(default_factory=ModelSpec)
    exec: ExecSpec = field(default_factory=ExecSpec)

    # -- validation --------------------------------------------------------

    def validate(self) -> "RunSpec":
        self.graph.validate()
        self.partition.validate()
        self.schedule.validate(self.partition)
        self.model.validate()
        self.exec.validate()
        if (self.exec.mode == "multiproc" and self.exec.nprocs
                and self.exec.nprocs != self.partition.nparts):
            raise SpecError(
                "exec.nprocs: multiproc runs one process per partition; "
                f"got nprocs={self.exec.nprocs} with "
                f"partition.nparts={self.partition.nparts} (use 0 to "
                "inherit nparts)")
        return self

    # -- dict / JSON round-trip -------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name).to_dict()
                for f in fields(self)}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunSpec":
        if not isinstance(d, dict):
            raise SpecError(f"RunSpec: expected an object, got {d!r}")
        sections = {f.name: f.default_factory for f in fields(cls)}
        unknown = set(d) - set(sections)
        if unknown:
            raise SpecError(f"RunSpec: unknown section(s) {sorted(unknown)}; "
                            f"known: {sorted(sections)}")
        kw = {}
        for name, default_factory in sections.items():
            sub_cls = type(default_factory())
            kw[name] = (sub_cls.from_dict(d[name], path=name)
                        if name in d else default_factory())
        return cls(**kw).validate()

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "RunSpec":
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"RunSpec: invalid JSON: {e}") from None
        return cls.from_dict(d)

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "RunSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- identity ----------------------------------------------------------

    def content_hash(self) -> str:
        """Stable short id of the configuration *content* (key order and
        formatting don't matter; every field value does). Stamped into
        benchmark artifacts so a recorded row names its exact config."""
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return "rs-" + hashlib.sha256(canon.encode()).hexdigest()[:12]

    # -- the --set override layer -----------------------------------------

    def with_overrides(self, assignments: List[str]) -> "RunSpec":
        """Apply ``section.field=value`` assignments (the ``--set`` layer).

        Values parse as JSON scalars first (``2``, ``0.5``, ``true``,
        ``null``), falling back to bare strings (``hybrid``); each lands on
        the sub-spec field's declared type or raises :class:`SpecError`.
        """
        spec = self
        for a in assignments:
            if "=" not in a:
                raise SpecError(f"override {a!r}: expected KEY=VALUE")
            key, raw = a.split("=", 1)
            parts = key.strip().split(".")
            if len(parts) != 2:
                raise SpecError(
                    f"override {a!r}: key must be section.field "
                    f"(sections: {[f.name for f in fields(RunSpec)]})")
            section, fname = parts
            if section not in {f.name for f in fields(RunSpec)}:
                raise SpecError(
                    f"override {a!r}: unknown section {section!r} "
                    f"(sections: {[f.name for f in fields(RunSpec)]})")
            sub = getattr(spec, section)
            if fname not in {f.name for f in fields(sub)}:
                raise SpecError(
                    f"override {a!r}: unknown field {fname!r} in "
                    f"{section} (fields: {[f.name for f in fields(sub)]})")
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw  # bare string, e.g. strategy=hybrid
            value = _coerce(value, _type_hints(type(sub))[fname],
                            f"{section}.{fname}")
            sub = dataclasses.replace(sub, **{fname: value})
            spec = dataclasses.replace(spec, **{section: sub})
        return spec.validate()

    # -- convenience -------------------------------------------------------

    def describe(self) -> str:
        """One-line human summary (hash + the load-bearing knobs)."""
        p, s = self.partition, self.schedule
        topo = (f"hier {p.groups}x{p.resolved_group_size()}"
                if p.hierarchical else f"flat {p.nparts}")
        return (f"{self.content_hash()} {self.graph.source} "
                f"[{topo}/{p.strategy}] bits={s.bits} cd={s.cd} "
                f"agg={s.agg_backend} {self.model.model} "
                f"mode={self.exec.mode}")
