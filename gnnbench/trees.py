"""Parameter trees in the port's layout (``{"layers": [{name: tensor}],
"lp_embed": tensor}``), read leaf by leaf."""

from __future__ import annotations

from typing import Dict

import torch


def leaves(tree) -> Dict[str, torch.Tensor]:
    """A tree's leaves by dotted name (``layers.0.w_self``)."""
    out = {}
    for i, p in enumerate(tree["layers"]):
        for k in sorted(p):
            out[f"layers.{i}.{k}"] = p[k]
    if "lp_embed" in tree:
        out["lp_embed"] = tree["lp_embed"]
    return out


def leaf_norms(tree) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in leaves(tree).items()}


def change_norms(tree, start) -> Dict[str, float]:
    a, b = leaves(tree), leaves(start)
    return {k: float(torch.linalg.vector_norm(a[k].double() - b[k].double())) for k in a}


def clone(tree):
    return {k: ([{n: t.clone() for n, t in p.items()} for p in v] if k == "layers"
                else v.clone()) for k, v in tree.items()}
