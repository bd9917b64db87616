"""Built-in graph and feature sources for :class:`~repro_torch.run.spec.RunSpec`.

Each graph source is ``fn(GraphSpec) -> Graph`` returning an *unnormalized*
graph with ``labels`` and ``train_mask`` populated (structural sources plant
zero labels and an all-train mask, matching the dry-run stand-ins). Each
feature source is ``fn(Graph, GraphSpec) -> np.ndarray [N, feat_dim]``.

Importing this module populates :data:`~repro_torch.run.spec.GRAPH_SOURCES` and
:data:`~repro_torch.run.spec.FEATURE_SOURCES`; new workloads register additional
entries the same way and become addressable from spec files for free.
"""

from __future__ import annotations

import numpy as np

from repro_torch.graph import erdos_graph, rmat_graph, sbm_graph
from repro_torch.graph.generators import sbm_features
from repro_torch.graph.structure import Graph
from repro_torch.run.spec import FEATURE_SOURCES, GRAPH_SOURCES, GraphSpec


@GRAPH_SOURCES.register("sbm")
def _sbm(spec: GraphSpec) -> Graph:
    return sbm_graph(spec.nodes, spec.classes, avg_degree=spec.avg_degree,
                     homophily=spec.homophily, seed=spec.seed)


# The structural sources carry no labels/train_mask; the downstream stack
# handles that (partition weights skip the train term, prepare_distributed
# substitutes zero labels and an all-train mask), so dry-run specs lower
# the identical trainer without planting fake supervision.


@GRAPH_SOURCES.register("rmat")
def _rmat(spec: GraphSpec) -> Graph:
    return rmat_graph(spec.scale, edge_factor=spec.edge_factor,
                      seed=spec.seed)


@GRAPH_SOURCES.register("erdos")
def _erdos(spec: GraphSpec) -> Graph:
    return erdos_graph(spec.nodes, avg_degree=spec.avg_degree, seed=spec.seed)


@FEATURE_SOURCES.register("sbm")
def _sbm_feats(g: Graph, spec: GraphSpec) -> np.ndarray:
    # seed+1 decorrelates features from the generator's edge randomness
    # (the convention every existing driver used).
    x, _ = sbm_features(g, spec.feat_dim, noise=spec.feat_noise,
                        seed=spec.seed + 1)
    return x


@FEATURE_SOURCES.register("zeros")
def _zero_feats(g: Graph, spec: GraphSpec) -> np.ndarray:
    return np.zeros((g.num_nodes, spec.feat_dim), np.float32)


@FEATURE_SOURCES.register("random")
def _random_feats(g: Graph, spec: GraphSpec) -> np.ndarray:
    rng = np.random.default_rng(spec.seed + 1)
    return (spec.feat_noise
            * rng.normal(size=(g.num_nodes, spec.feat_dim))).astype(np.float32)


def resolve_features(spec: GraphSpec) -> str:
    """The ``auto`` rule: label-planting sources get the learnable
    block-correlated features, structural sources get zeros."""
    if spec.features != "auto":
        return spec.features
    return "sbm" if spec.source == "sbm" else "zeros"
