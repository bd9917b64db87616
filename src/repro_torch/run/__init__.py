# RunSpec (copied from repro.run.spec), the session builder, and the
# sweep / tuner / CLI layer over them.
from repro_torch.run.spec import (
    FEATURE_SOURCES,
    GRAPH_SOURCES,
    ExecSpec,
    GraphSpec,
    ModelSpec,
    PartitionSpec,
    RunSpec,
    ScheduleSpec,
    SpecError,
)
from repro_torch.run.session import (
    BuildCache,
    Session,
    build_graph,
    build_partition,
    build_session,
    resolve_auto,
)
from repro_torch.run.sweep import product_overrides, sweep_one, sweep_rows
from repro_torch.run.tune import DEFAULT_AXES, audit_candidate, measure_epoch_s, tune
from repro_torch.run.cli import (
    LEGACY_ALIASES,
    add_spec_args,
    legacy_overrides,
    spec_from_args,
)

__all__ = [
    "FEATURE_SOURCES",
    "GRAPH_SOURCES",
    "ExecSpec",
    "GraphSpec",
    "ModelSpec",
    "PartitionSpec",
    "RunSpec",
    "ScheduleSpec",
    "SpecError",
    "BuildCache",
    "Session",
    "build_graph",
    "build_partition",
    "build_session",
    "resolve_auto",
    "product_overrides",
    "sweep_one",
    "sweep_rows",
    "DEFAULT_AXES",
    "audit_candidate",
    "measure_epoch_s",
    "tune",
    "LEGACY_ALIASES",
    "add_spec_args",
    "legacy_overrides",
    "spec_from_args",
]
