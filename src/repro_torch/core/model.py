"""GCN model in PyTorch: config, parameter init, eval forward (Fig 2 flow).

Counterpart of ``repro/core/model.py``. The forward is parameterized by
``agg_fn(layer, h) -> z`` as there:

  (1) masked LP: train labels embedded into the features,
  (2) LayerNorm before every GCN layer,
  (3) aggregation (``agg_fn``),
  (4) UPDATE (linear transform / MLP), repeat.

Only the eval forward is ported; dropout, ``lp_masks`` and
``loss_and_metrics`` arrive with the training slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core import layers as L


@dataclass(frozen=True)
class GCNConfig:
    model: str = "sage"          # gcn | sage | gin (gat: not ported yet)
    in_dim: int = 128
    hidden_dim: int = 256        # paper Table 2: 256 (128 for UK-2007-05)
    num_classes: int = 40
    num_layers: int = 3          # paper: three-layer GraphSAGE
    dropout: float = 0.5
    norm: str = "layer"          # LayerNorm before each layer (Table 2)
    label_prop: bool = True      # masked label propagation (§6.1)
    lp_rate: float = 0.5         # fraction of train labels propagated
    quant_bits: int = 0          # 0 = fp32 comm; 2 = paper's Int2 scheme
    gat_heads: int = 4

    def dims(self) -> List[int]:
        return [self.in_dim] + [self.hidden_dim] * (self.num_layers - 1) + [self.num_classes]


def init_params(cfg: GCNConfig, generator: Optional[torch.Generator] = None,
                device="cpu") -> Dict:
    """Random parameters under the JAX package's keys. They are drawn on
    the CPU from ``generator`` (seeded 0 if None) and then moved to
    ``device``, so a seed gives the same weights on every device."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dims = cfg.dims()
    params: Dict = {
        "layers": [L.init_layer(gen, cfg.model, dims[i], dims[i + 1])
                   for i in range(cfg.num_layers)]
    }
    if cfg.label_prop:
        params["lp_embed"] = torch.randn((cfg.num_classes, cfg.in_dim),
                                         generator=gen) * 0.02
    return to_device(params, device)


def to_device(params: Dict, device) -> Dict:
    out: Dict = {"layers": [{k: v.to(device) for k, v in p.items()}
                            for p in params["layers"]]}
    if "lp_embed" in params:
        out["lp_embed"] = params["lp_embed"].to(device)
    return out


def forward(
    params: Dict,
    cfg: GCNConfig,
    x: torch.Tensor,                 # [N, in_dim] node features
    labels: torch.Tensor,            # [N] int labels
    prop_mask: torch.Tensor,         # [N] bool: labels embedded into features
    agg_fn: Callable[[int, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """The eval forward (``repro.core.model.forward`` with train=False)."""
    if cfg.model == "gat":
        raise NotImplementedError(L.GAT_NOT_PORTED)
    h = x
    if cfg.label_prop:
        emb = params["lp_embed"][labels.clamp(0, cfg.num_classes - 1).long()]
        h = h + torch.where(prop_mask[:, None], emb, 0.0)
    for l, p in enumerate(params["layers"]):
        if cfg.norm == "layer":
            h = L.layer_norm(h, p["ln_scale"], p["ln_bias"])
        z = agg_fn(l, h)
        h = L.apply_update(cfg.model, p, h, z)
        if l < cfg.num_layers - 1:
            h = torch.relu(h)
    return h
