from repro_torch.data.pipeline import (
    GraphDataset,
    TokenPipeline,
    make_gcn_dataset,
    synthetic_token_batches,
)

__all__ = ["TokenPipeline", "synthetic_token_batches", "GraphDataset",
           "make_gcn_dataset"]
