# Host-side graph preprocessing (NumPy), copied from repro.graph. The halo
# plans (repro.graph.remote / mvc) arrive with the training slice.
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
]
