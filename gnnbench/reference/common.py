"""Pieces every plain reference shares: the dense product (in fp32, or in
TF32 for the control), LayerNorm, the masked cross entropy and AdamW.
Plain PyTorch; nothing of the program is imported."""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from gnnbench import trees

ADAM = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest even), as a
    tensor core reads an fp32 operand with TF32 on."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, control: bool) -> torch.Tensor:
    """``a @ b`` accumulated in fp32; the control reads both operands in
    TF32 (the precision below the configurations' fp32 with TF32 off)."""
    if control:
        return torch.matmul(_Tf32.apply(a), _Tf32.apply(b))
    return torch.matmul(a, b)


class _Tf32(torch.autograd.Function):
    """TF32 rounding whose gradient is rounded too: the backward's
    products read their operands in TF32 as well."""

    @staticmethod
    def forward(ctx, x):
        return to_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return to_tf32(g)


def layer_norm(h: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(h, (h.shape[-1],), scale, bias, eps=1e-5)


def dropout(h: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout with the drawn keep mask."""
    k = torch.full((), 1.0 - rate, device=h.device, dtype=h.dtype)
    return torch.where(keep, h / k, 0.0)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the nodes of ``mask`` (any leading axes)."""
    c = logits.shape[-1]
    nll = F.cross_entropy(logits.reshape(-1, c), labels.reshape(-1).long(),
                          reduction="none")
    m = mask.reshape(-1).to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def grads(loss: torch.Tensor, params) -> Dict:
    flat = trees.leaves(params)
    gs = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    by = {k: (g if g is not None else torch.zeros_like(flat[k]))
          for k, g in zip(flat, gs)}
    return _tree_like(params, by)


def _tree_like(params, by: Dict[str, torch.Tensor]):
    out = {"layers": [{k: by[f"layers.{i}.{k}"] for k in p}
                      for i, p in enumerate(params["layers"])]}
    if "lp_embed" in params:
        out["lp_embed"] = by["lp_embed"]
    return out


class AdamW:
    """AdamW with weight decay 0 (the port's default), bias-corrected."""

    def __init__(self, params, lr: float):
        self.lr, self.t = lr, 0
        flat = trees.leaves(params)
        self.m = {k: torch.zeros_like(v) for k, v in flat.items()}
        self.v = {k: torch.zeros_like(v) for k, v in flat.items()}

    def update(self, params, grads):
        b1, b2, eps = ADAM["b1"], ADAM["b2"], ADAM["eps"]
        self.t += 1
        p, g = trees.leaves(params), trees.leaves(grads)
        out = {}
        for k in p:
            self.m[k] = b1 * self.m[k] + (1 - b1) * g[k]
            self.v[k] = b2 * self.v[k] + (1 - b2) * g[k] * g[k]
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            out[k] = p[k] - self.lr * mhat / (torch.sqrt(vhat) + eps)
        return _tree_like(params, out)


def train(step, params0, lr: float, steps: int, dtype=torch.float32) -> Dict:
    """Run ``step(params, epoch) -> (loss, grads)`` for ``steps`` epochs
    under AdamW from ``params0`` (held in ``dtype``): each step's loss, the
    first gradient's leaf norms and each leaf's change after the last
    step."""
    params = {k: ([{n: t.to(dtype) for n, t in p.items()} for p in v] if k == "layers"
                  else v.to(dtype)) for k, v in params0.items()}
    opt = AdamW(params, lr)
    losses: List[float] = []
    grad_norms = None
    for e in range(steps):
        p = {k: ([{n: t.detach().requires_grad_(True) for n, t in q.items()} for q in v]
                 if k == "layers" else v.detach().requires_grad_(True))
             for k, v in params.items()}
        loss, g = step(p, e)
        losses.append(float(loss))
        if e == 0:
            grad_norms = trees.leaf_norms(g)
        with torch.no_grad():
            params = opt.update(params, g)
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": trees.change_norms(params, params0)}
