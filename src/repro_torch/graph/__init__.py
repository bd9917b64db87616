# Host-side graph preprocessing (NumPy), copied from repro.graph, with the
# halo plans (remote / mvc).
from repro_torch.graph.structure import (
    CSR,
    BucketedEll,
    Graph,
    block_diag_csrs,
    bucketed_ell_from_csr,
    coo_to_csr,
    stack_bucketed_ells,
    transpose_csr,
)
from repro_torch.graph.generators import rmat_graph, sbm_graph, erdos_graph
from repro_torch.graph.partition import (
    partition_graph,
    partition_hierarchical,
    refine_bucket_max,
)
from repro_torch.graph.mvc import hopcroft_karp, min_vertex_cover_bipartite
from repro_torch.graph.remote import (
    CommStats,
    GroupPairPlan,
    HaloPlan,
    HierHaloPlan,
    HierPartitionedGraph,
    PartitionedGraph,
    build_halo_plan,
    build_hier_halo_plan,
    build_hierarchical_partitioned_graph,
    build_partitioned_graph,
)

__all__ = [
    "CSR",
    "BucketedEll",
    "Graph",
    "block_diag_csrs",
    "bucketed_ell_from_csr",
    "coo_to_csr",
    "stack_bucketed_ells",
    "transpose_csr",
    "rmat_graph",
    "sbm_graph",
    "erdos_graph",
    "partition_graph",
    "partition_hierarchical",
    "refine_bucket_max",
    "hopcroft_karp",
    "min_vertex_cover_bipartite",
    "CommStats",
    "GroupPairPlan",
    "HaloPlan",
    "HierHaloPlan",
    "HierPartitionedGraph",
    "PartitionedGraph",
    "build_halo_plan",
    "build_hier_halo_plan",
    "build_hierarchical_partitioned_graph",
    "build_partitioned_graph",
]
