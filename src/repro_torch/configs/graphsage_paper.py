"""The paper's own model configs (Table 2): 3-layer GraphSAGE, hidden 256,
LayerNorm, dropout 0.5 — with per-dataset presets mapped to the synthetic
stand-ins available offline (DESIGN.md §8.3)."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.model import GCNConfig


@dataclass(frozen=True)
class GCNDatasetPreset:
    name: str
    feat_dim: int
    num_classes: int
    hidden: int
    epochs: int
    lr: float
    # synthetic stand-in parameters
    sbm_nodes: int
    sbm_degree: float


# Paper Table 2 rows (feat/class/hidden/epochs/lr), synthetic-scaled.
PAPER_PRESETS = {
    "ogbn-arxiv": GCNDatasetPreset("ogbn-arxiv", 128, 40, 256, 250, 0.01, 8192, 13.8),
    "reddit": GCNDatasetPreset("reddit", 602, 41, 256, 250, 0.01, 4096, 90.0),
    "ogbn-products": GCNDatasetPreset("ogbn-products", 100, 47, 256, 250, 0.01, 16384, 25.0),
    "ogbn-papers100M": GCNDatasetPreset("ogbn-papers100M", 128, 172, 256, 200, 0.005, 16384, 14.5),
    "uk-2007-05": GCNDatasetPreset("uk-2007-05", 128, 172, 128, 200, 0.01, 16384, 35.0),
}


def gcn_config(preset: GCNDatasetPreset, model: str = "sage",
               label_prop: bool = True, quant_bits: int = 0) -> GCNConfig:
    return GCNConfig(
        model=model,
        in_dim=preset.feat_dim,
        hidden_dim=preset.hidden,
        num_classes=preset.num_classes,
        num_layers=3,
        dropout=0.5,
        norm="layer",
        label_prop=label_prop,
        quant_bits=quant_bits,
    )
