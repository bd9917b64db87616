"""``train_products_paper``: the paper's GraphSAGE trained at full width.

The schedule is ``specs/flagship_hier_int2_overlap.json``: 8 workers in a
hierarchical 2x4 exchange, fp32 within a group, Int2 between groups
refreshed every 2 epochs (``inter_cd=2``), two-phase overlap, the
bucketed-ELL aggregation, MVC hybrid pre/post-aggregation, lr 0.01. The
model and graph widths are paper Table 2's ``ogbn-products`` row
(``graphsage_paper.py``): 3-layer GraphSAGE, hidden 256, 100 input
features, 47 classes, dropout 0.5, LayerNorm, label propagation at rate
0.5. All 8 workers are stacked on one device (``exec.mode="vmap"``).

Cut to size: the 2.4 M-node dataset cannot be downloaded, so the graph is
the preset's synthetic stand-in, an SBM graph of 16384 nodes and mean
degree 25 (415,612 edges).
"""

from __future__ import annotations

from repro_torch.configs.graphsage_paper import PAPER_PRESETS
from repro_torch.run.spec import RunSpec

_P = PAPER_PRESETS["ogbn-products"]

# specs/flagship_hier_int2_overlap.json, as its fields differ from the spec
# defaults, with exec.mode left at its default, vmap.
FLAGSHIP = {
    "exec": {"epochs": 5},
    "graph": {"avg_degree": 10.0, "classes": 4, "feat_dim": 16, "nodes": 256},
    "model": {"hidden_dim": 32, "num_layers": 2},
    "partition": {"groups": 2, "nparts": 8},
    "schedule": {"inter_bits": 2, "inter_cd": 2, "overlap": True},
}

OVERRIDES = [
    f"graph.nodes={_P.sbm_nodes}",
    f"graph.avg_degree={_P.sbm_degree}",
    f"graph.feat_dim={_P.feat_dim}",
    f"graph.classes={_P.num_classes}",
    f"model.hidden_dim={_P.hidden}",
    "model.num_layers=3",
    f"exec.lr={_P.lr}",
]


def train_products_paper(*extra: str) -> RunSpec:
    """The training configuration, with ``extra`` ``--set`` overrides."""
    return RunSpec.from_dict(FLAGSHIP).with_overrides(OVERRIDES + list(extra))
