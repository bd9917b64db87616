# RunSpec (copied from repro.run.spec) and the graph/partition stages of
# the session builder that serving needs.
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
from repro_torch.run.session import build_graph, build_partition

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
    "build_graph",
    "build_partition",
]
