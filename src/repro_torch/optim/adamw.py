"""AdamW as plain functions on parameter trees of tensors.

Counterpart of ``repro/optim/adamw.py``, with its op order (bias
correction after the moment updates, ``b ** step`` in fp32) and its default
``weight_decay=0.0``. ``torch.optim.AdamW`` is not used: its default weight
decay is 0.01 and it orders the bias correction differently, so it would
not follow the JAX package's trajectory.

A tree is a tensor, or a dict or list of trees (the model's parameters).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of ``rest``, same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    return AdamWState(step=0, mu=tree_map(torch.zeros_like, params),
                      nu=tree_map(torch.zeros_like, params))


def adamw_update(
    grads,
    state: AdamWState,
    params,
    lr: float,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: float = 0.0,
):
    step = state.step + 1
    if grad_clip > 0:
        gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree_leaves(grads)))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    leaf = tree_leaves(params)[0]
    t = torch.tensor(float(step), dtype=torch.float32, device=leaf.device)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        return p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)

    new_params = tree_map(upd, params, mu, nu)
    return new_params, AdamWState(step=step, mu=mu, nu=nu)
