"""``serve_products_paper``: the paper's GraphSAGE served at full width.

The model is paper Table 2's ``ogbn-products`` row (``graphsage_paper.py``):
3-layer GraphSAGE, hidden 256, LayerNorm, label propagation, 100 input
features, 47 classes. It is served on that preset's synthetic stand-in, a
16384-node SBM graph of mean degree 25, because the dataset cannot be
downloaded. The deployment is ``specs/serve_flagship.json`` (hierarchical
2x4 partition, staleness bound 2, batches of 8) with the graph and model
widths of the preset and 3-hop ego-nets sampled at fanouts 15,10,5.
"""

from __future__ import annotations

from repro_torch.configs.graphsage_paper import PAPER_PRESETS
from repro_torch.serve.spec import ServeSpec

_P = PAPER_PRESETS["ogbn-products"]

# specs/serve_flagship.json, as its fields differ from the spec defaults.
FLAGSHIP = {
    "run": {
        "exec": {"epochs": 5},
        "graph": {"avg_degree": 10.0, "classes": 4, "feat_dim": 16,
                  "nodes": 256},
        "model": {"hidden_dim": 32, "num_layers": 2},
        "partition": {"groups": 2, "nparts": 8},
        "schedule": {"inter_bits": 2, "inter_cd": 2, "overlap": True},
    },
    "serve": {"max_staleness": 2},
}

OVERRIDES = [
    f"graph.nodes={_P.sbm_nodes}",
    f"graph.avg_degree={_P.sbm_degree}",
    f"graph.feat_dim={_P.feat_dim}",
    f"graph.classes={_P.num_classes}",
    f"model.hidden_dim={_P.hidden}",
    "model.num_layers=3",
    "serve.fanouts=15,10,5",
    "serve.batch_size=8",
]


def serve_products_paper(*extra: str) -> ServeSpec:
    """The serving configuration, with ``extra`` ``--set`` overrides."""
    return ServeSpec.from_dict(FLAGSHIP).with_overrides(OVERRIDES + list(extra))
