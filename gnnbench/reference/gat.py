"""Plain reference of single-device full-batch GAT training: the graph's
edge list with a self loop on every node, per edge the attention score
``leaky_relu(a_dst . Wh_d + a_src . Wh_s, 0.2)``, a softmax over each
node's incoming edges, and the attention-weighted sum of ``Wh`` per head
(Velickovic et al., arXiv 1710.10903), with LayerNorm before, dropout
and label propagation as the paper's GraphSAGE. Plain PyTorch: gathers and
``index_add`` over the edges."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from gnnbench.reference import common as C


def prepare(cfg: Dict, traffic: Dict, raw: Dict, seed: int, device, placement=None) -> Dict:
    """The whole graph on one device (a single-device program places no rows)."""
    n = raw["num_nodes"]
    loops = np.arange(n)
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return {"n": n, "src": t(np.concatenate([raw["src"], loops]), torch.int64),
            "dst": t(np.concatenate([raw["dst"], loops]), torch.int64),
            "x": t(raw["x"], torch.float32), "labels": t(raw["labels"], torch.int64),
            "train": t(raw["train_mask"], torch.bool)}


def attention_layer(L: Dict, q: Dict, h: torch.Tensor, heads: int, control: bool):
    n, src, dst = L["n"], L["src"], L["dst"]
    wh = C.mm(h, q["w"], control)
    whh = wh.reshape(n, heads, -1)
    e_src = (whh * q["a_src"]).sum(-1)
    e_dst = (whh * q["a_dst"]).sum(-1)
    e = F.leaky_relu(e_dst[dst] + e_src[src], 0.2)                   # [E, H]
    top = torch.full((n, heads), -torch.inf, device=h.device, dtype=e.dtype).scatter_reduce(
        0, dst[:, None].expand(-1, heads), e.detach(), "amax")
    ex = torch.exp(e - top[dst])
    den = torch.zeros((n, heads), device=h.device, dtype=ex.dtype).index_add(0, dst, ex)
    alpha = ex / den[dst]
    out = torch.zeros_like(whh).index_add(0, dst, alpha[..., None] * whh[src])
    return out.reshape(n, -1) + q["b"]


def train(L: Dict, cfg: Dict, params0, draws, steps: int, control: bool = False,
          dtype=torch.float32) -> Dict:
    """Three steps (``steps``) of training from ``params0``; ``control``
    computes the dense products in TF32, ``dtype`` float64 gives a
    witness of what fp32 rounding alone moves."""
    m = cfg["model"]
    x = L["x"].to(dtype)

    def step(p, epoch):
        sel = draws.lp_select(epoch, tuple(L["train"].shape), m["lp_rate"], L["x"].device)
        prop, loss_mask = L["train"] & sel, L["train"] & ~sel
        h = x + torch.where(prop[:, None], p["lp_embed"][L["labels"]], 0.0)
        for l, q in enumerate(p["layers"]):
            h = C.layer_norm(h, q["ln_scale"], q["ln_bias"])
            keep = draws.dropout_keep(epoch, l, tuple(h.shape), 1.0 - m["dropout"], h.device)
            h = attention_layer(L, q, C.dropout(h, keep, m["dropout"]), m["heads"], control)
            if l < len(p["layers"]) - 1:
                h = F.relu(h)
        loss = C.masked_ce(h, L["labels"], loss_mask)
        return loss.detach(), C.grads(loss, p)

    return C.train(step, params0, cfg["optimizer"]["lr"], steps, dtype)


def run(cfg: Dict, traffic: Dict, raw: Dict, params0, draws, seed: int, device,
        steps: int = 3, control: bool = False, placement=None) -> Dict:
    return train(prepare(cfg, traffic, raw, seed, device), cfg, params0, draws, steps,
                 control)
