"""ServeSpec: one declarative, serializable online-inference description.

A serving deployment is a :class:`~repro_torch.run.spec.RunSpec` (which graph,
how it is partitioned, what model shape) plus the knobs that only exist at
inference time — where the trained parameters come from, how deep and how
wide the ego-net sampler reaches, how many requests pack into one
dispatch, and how stale a cached remote feature may be. :class:`ServeSpec`
carries both: the ``run`` section is a full RunSpec and the ``serve``
section a :class:`ServeConfig`, so a serving deployment round-trips
through JSON, hashes stably (``content_hash()``, ``sv-`` prefix, stamped
into the serving benchmark artifact), and shares the ``--set`` override
grammar with every other CLI.

``repro_torch.serve.server.build_server(spec)`` is the ``build_session``
analogue: it lowers a ServeSpec onto a live :class:`GNNServer`.

JSON files are distinguished from plain RunSpecs by their top-level
``serve`` key (see :func:`is_serve_spec_dict`) — the spec-matrix runner
uses this to drive ``specs/serve_*.json`` through ``build_server``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional

from repro_torch.run.spec import RunSpec, SpecError, _SubSpec


@dataclass(frozen=True)
class ServeConfig(_SubSpec):
    """The inference-only knobs (``serve.*`` in overrides and JSON)."""

    # Checkpoint directory read through CheckpointManager.load_latest()
    # (corrupt snapshots fall back to the previous good step). "" serves
    # freshly initialized parameters — the dry-run/smoke configuration.
    ckpt: str = ""
    # Per-layer neighbour fanout caps for the ego extractor: "full" keeps
    # every in-edge (exact inference — the parity-checked path), or a
    # comma list like "10,5" (outermost hop last value repeats if short).
    fanouts: str = "full"
    # Max requests packed into one block-diagonal dispatch.
    batch_size: int = 8
    # How long the batcher would hold a non-full batch open for stragglers
    # (recorded in artifacts; the synchronous drivers simulate arrival).
    batch_window_ms: float = 2.0
    # Staleness bound on cached remote features, in feature-store versions
    # (the delayed-comm cd knob of serving): 0 = always fresh, s = a cached
    # row may be served until it is s versions old.
    max_staleness: int = 0
    # Background cache sweep period, in batches (0 = never sweep).
    refresh_every: int = 1
    # Smallest padded-node shape class (power-of-two ladder floor) for the
    # retrace-free jit signature.
    min_nodes: int = 64
    seed: int = 0

    def validate(self) -> None:
        if self.batch_size < 1:
            raise SpecError(f"serve.batch_size must be >= 1, "
                            f"got {self.batch_size}")
        if self.batch_window_ms < 0:
            raise SpecError(f"serve.batch_window_ms must be >= 0, "
                            f"got {self.batch_window_ms}")
        if self.max_staleness < 0:
            raise SpecError(f"serve.max_staleness must be >= 0, "
                            f"got {self.max_staleness}")
        if self.refresh_every < 0:
            raise SpecError(f"serve.refresh_every must be >= 0, "
                            f"got {self.refresh_every}")
        if self.min_nodes < 8:
            raise SpecError(f"serve.min_nodes must be >= 8, "
                            f"got {self.min_nodes}")
        self._parse_fanouts()

    def _parse_fanouts(self) -> Optional[List[int]]:
        if self.fanouts in ("full", "", "0"):
            return None
        try:
            caps = [int(tok) for tok in self.fanouts.split(",")]
        except ValueError:
            raise SpecError(
                f"serve.fanouts must be 'full' or a comma list of ints "
                f"(e.g. '10,5'), got {self.fanouts!r}") from None
        if any(c < 1 for c in caps):
            raise SpecError(f"serve.fanouts entries must be >= 1, "
                            f"got {caps}")
        return caps

    def resolved_fanouts(self, num_layers: int) -> Optional[List[int]]:
        """Per-hop caps for an L-layer model (None = full fanout). A short
        list repeats its last entry for the remaining (deeper) hops."""
        caps = self._parse_fanouts()
        if caps is None:
            return None
        return [caps[min(h, len(caps) - 1)] for h in range(num_layers)]


@dataclass(frozen=True)
class ServeSpec:
    """The full declarative serving deployment: run x serve."""

    run: RunSpec = field(default_factory=RunSpec)
    serve: ServeConfig = field(default_factory=ServeConfig)

    def validate(self) -> "ServeSpec":
        self.run.validate()
        self.serve.validate()
        return self

    # -- dict / JSON round-trip -------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {"run": self.run.to_dict(), "serve": self.serve.to_dict()}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeSpec":
        if not isinstance(d, dict):
            raise SpecError(f"ServeSpec: expected an object, got {d!r}")
        unknown = set(d) - {"run", "serve"}
        if unknown:
            raise SpecError(f"ServeSpec: unknown section(s) "
                            f"{sorted(unknown)}; known: ['run', 'serve']")
        if "serve" not in d:
            raise SpecError("ServeSpec: missing the 'serve' section (a "
                            "plain RunSpec file? load it with RunSpec)")
        run = (RunSpec.from_dict(d["run"]) if "run" in d else RunSpec())
        serve = ServeConfig.from_dict(d["serve"], path="serve")
        return cls(run=run, serve=serve).validate()

    def to_json(self, indent: Optional[int] = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ServeSpec":
        try:
            d = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"ServeSpec: invalid JSON: {e}") from None
        return cls.from_dict(d)

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "ServeSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- identity ----------------------------------------------------------

    def content_hash(self) -> str:
        canon = json.dumps(self.to_dict(), sort_keys=True,
                           separators=(",", ":"))
        return "sv-" + hashlib.sha256(canon.encode()).hexdigest()[:12]

    # -- the --set override layer -----------------------------------------

    def with_overrides(self, assignments: List[str]) -> "ServeSpec":
        """``serve.field=value`` lands on the ServeConfig; every other
        ``section.field=value`` is delegated to the run spec's layer.

        Run assignments are applied as ONE batch (matching RunSpec's own
        semantics): cross-field validation runs after the last assignment,
        so e.g. ``partition.groups=0`` + ``schedule.inter_bits=null`` is
        legal in either order.
        """
        spec = self
        run_assignments = []
        for a in assignments:
            if "=" not in a:
                raise SpecError(f"override {a!r}: expected KEY=VALUE")
            key, raw = a.split("=", 1)
            section = key.strip().split(".", 1)[0]
            if section != "serve":
                run_assignments.append(a)
                continue
            fname = key.strip().split(".", 1)[1] if "." in key else ""
            known = {f.name for f in fields(ServeConfig)}
            if fname not in known:
                raise SpecError(f"override {a!r}: unknown field {fname!r} "
                                f"in serve (fields: {sorted(known)})")
            from repro_torch.run.spec import _coerce, _type_hints
            try:
                value = json.loads(raw)
            except json.JSONDecodeError:
                value = raw
            value = _coerce(value, _type_hints(ServeConfig)[fname],
                            f"serve.{fname}")
            spec = dataclasses.replace(
                spec, serve=dataclasses.replace(spec.serve,
                                                **{fname: value}))
        if run_assignments:
            spec = dataclasses.replace(
                spec, run=spec.run.with_overrides(run_assignments))
        return spec.validate()

    def describe(self) -> str:
        s = self.serve
        src = s.ckpt if s.ckpt else "fresh-init"
        return (f"{self.content_hash()} serve[{self.run.describe()}] "
                f"ckpt={src} fanouts={s.fanouts} B={s.batch_size} "
                f"staleness={s.max_staleness}")


def is_serve_spec_dict(d: Any) -> bool:
    """True when a decoded spec JSON is a ServeSpec (top-level ``serve``
    key) rather than a plain RunSpec — the matrix runner's dispatch."""
    return isinstance(d, dict) and "serve" in d
