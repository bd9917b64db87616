# RunSpec (copied from repro.run.spec) and the session builder.
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
from repro_torch.run.session import (Session, build_graph, build_partition,
                                    build_session)

__all__ = [
    "FEATURE_SOURCES",
    "GRAPH_SOURCES",
    "ExecSpec",
    "GraphSpec",
    "ModelSpec",
    "PartitionSpec",
    "RunSpec",
    "ScheduleSpec",
    "Session",
    "SpecError",
    "build_graph",
    "build_partition",
    "build_session",
]
