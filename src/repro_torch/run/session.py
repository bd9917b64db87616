"""The graph and partition stages of ``repro.run.session``.

Serving needs only these two: the normalized graph with its features, and
the partition labels that decide which feature rows a server owns. The
halo plans, the trainer and the ``Session`` around them arrive with the
training slice.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np

import repro_torch.run.sources as sources  # populates the registries on import
from repro_torch.run.spec import FEATURE_SOURCES, GRAPH_SOURCES, RunSpec


def build_graph(spec: RunSpec) -> Tuple[Any, np.ndarray]:
    """(normalized Graph, features [N, F]) for the spec's graph section.

    Features are synthesized on the *raw* graph (labels drive them, not
    edge weights); normalization attaches the aggregation edge weights
    before partitioning.
    """
    gs = spec.graph
    g = GRAPH_SOURCES.get(gs.source)(gs)
    x = FEATURE_SOURCES.get(sources.resolve_features(gs))(g, gs)
    if gs.norm == "mean":
        g = g.mean_normalized()
    elif gs.norm == "gcn":
        g = g.gcn_normalized()
    return g, x


def build_partition(spec: RunSpec, g) -> np.ndarray:
    """Partition labels ``[N] int32`` for the (already normalized) graph:
    flat or two-level hierarchical, with the ``partition.refine``
    post-pass applied. Equal to ``repro.run.session.build_partition(spec,
    g).part``; the halo plans built around it there are not built here.
    """
    from repro_torch.graph.partition import (partition_graph,
                                             partition_hierarchical,
                                             refine_bucket_max)
    ps = spec.partition
    if ps.hierarchical:
        gsz = ps.resolved_group_size()
        part = partition_hierarchical(g, ps.groups, gsz, seed=ps.seed)
        if ps.refine == "bucket-max":
            part = refine_bucket_max(g, part, nparts=ps.nparts,
                                     group_size=gsz, seed=ps.seed)
    else:
        part = partition_graph(g, ps.nparts, seed=ps.seed)
        if ps.refine == "bucket-max":
            part = refine_bucket_max(g, part, nparts=ps.nparts, seed=ps.seed)
    return np.asarray(part, dtype=np.int32)
