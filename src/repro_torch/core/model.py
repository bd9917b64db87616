"""GCN model in PyTorch: config, parameter init, forward (Fig 2 flow).

Counterpart of ``repro/core/model.py``. The forward is parameterized by
``agg_fn(layer, h) -> z`` as there:

  (1) masked LP: train labels embedded into the features,
  (2) LayerNorm before every GCN layer,
  (3) dropout when training,
  (4) aggregation (``agg_fn``),
  (5) UPDATE (linear transform / MLP), repeat.

The random draws are arguments, because torch cannot replay JAX's
threefry: ``lp_masks`` takes the Bernoulli selection and ``forward`` a
``dropout_keep(layer, shape)`` callable that returns the keep mask. Every
tensor may carry leading worker axes (``[P, N, F]``): the layers act on
the last axis and ``loss_and_metrics`` sums over the node axis only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core import layers as L
from repro_torch.core.record import indexed


@dataclass(frozen=True)
class GCNConfig:
    model: str = "sage"          # gcn | sage | gin | gat
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
        "layers": [L.init_layer(gen, cfg.model, dims[i], dims[i + 1], cfg.gat_heads)
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


def lp_masks(sel: torch.Tensor, train_mask: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split train nodes into (propagate labels, compute loss) — §2.5.

    ``sel`` is the Bernoulli(``lp_rate``) draw of ``train_mask``'s shape.
    Propagated labels are *excluded* from the loss to avoid label leakage.
    """
    return train_mask & sel, train_mask & ~sel


def forward(
    params: Dict,
    cfg: GCNConfig,
    x: torch.Tensor,                 # [..., N, in_dim] node features
    labels: torch.Tensor,            # [..., N] int labels
    prop_mask: torch.Tensor,         # [..., N] bool: labels embedded into features
    agg_fn: Callable[[int, torch.Tensor], torch.Tensor],
    *,
    dropout_keep: Optional[Callable[[int, Tuple[int, ...]], torch.Tensor]] = None,
) -> torch.Tensor:
    """``repro.core.model.forward``. Training (dropout) when
    ``dropout_keep`` is given: layer ``l`` keeps ``dropout_keep(l,
    h.shape)`` (a bool mask drawn with probability ``1 - cfg.dropout``) and
    scales the kept values by ``1 / (1 - cfg.dropout)``."""
    h = x
    if cfg.label_prop:
        # The span gnn.lp_embed (and its backward) while the profiler records.
        emb = indexed(params["lp_embed"], labels.clamp(0, cfg.num_classes - 1).long(),
                      "gnn.lp_embed")
        h = h + torch.where(prop_mask[..., None], emb, 0.0)
    for l, p in enumerate(params["layers"]):
        if cfg.norm == "layer":
            h = L.layer_norm(h, p["ln_scale"], p["ln_bias"])
        if dropout_keep is not None and cfg.dropout > 0:
            # A tensor divisor: CUDA divides by a host scalar as a multiply
            # by its reciprocal, which can differ from the division.
            keep = torch.full((), 1.0 - cfg.dropout, device=h.device)
            h = torch.where(dropout_keep(l, tuple(h.shape)), h / keep, 0.0)
        if cfg.model == "gat":
            h = agg_fn(l, h)  # GAT fuses aggregate+update (attention needs both ends)
        else:
            h = L.apply_update(cfg.model, p, h, agg_fn(l, h))
        if l < cfg.num_layers - 1:
            h = torch.relu(h)
    return h


def loss_and_metrics(
    logits: torch.Tensor, labels: torch.Tensor, loss_mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked softmax cross entropy. Returns (loss_sum, correct_sum, count),
    summed over the node axis (one value per leading worker index)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    m = loss_mask.to(torch.float32)
    loss_sum = torch.sum(nll * m, dim=-1)
    correct = torch.sum((torch.argmax(logits, -1) == labels).to(torch.float32) * m,
                        dim=-1)
    return loss_sum, correct, torch.sum(m, dim=-1)
