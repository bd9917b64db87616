"""GNN layer definitions in PyTorch (counterpart of ``repro/core/layers.py``).

UPDATE stages for GCN, GraphSAGE and GIN (§3.2). The AGGREGATE stage is
supplied by the caller as ``agg_fn``, as in the JAX package. GAT
(``gat_aggregate``/``gat_aggregate_bucketed``) is not ported yet.

The dense products stay ``torch.matmul`` in full fp32: the JAX package
left them to XLA outside any kernel, and the port needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default) for
them to stay fp32 on the card; the server sets it.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

Params = Dict[str, torch.Tensor]

GAT_NOT_PORTED = ("model 'gat' is not ported to PyTorch yet; "
                  "serve gcn, sage or gin, or use the JAX package")


def glorot(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * lim


def init_layer(gen: torch.Generator, model: str, d_in: int, d_out: int) -> Params:
    """A layer's parameters on the CPU, under the JAX package's keys."""
    p: Params = {
        "ln_scale": torch.ones(d_in),
        "ln_bias": torch.zeros(d_in),
        "b": torch.zeros(d_out),
    }
    if model == "gcn":
        p["w"] = glorot(gen, (d_in, d_out))
    elif model == "sage":
        p["w_self"] = glorot(gen, (d_in, d_out))
        p["w_neigh"] = glorot(gen, (d_in, d_out))
    elif model == "gin":
        p["eps"] = torch.zeros(())
        p["w1"] = glorot(gen, (d_in, d_out))
        p["b1"] = torch.zeros(d_out)
        p["w2"] = glorot(gen, (d_out, d_out))
    elif model == "gat":
        raise NotImplementedError(GAT_NOT_PORTED)
    else:
        raise ValueError(f"unknown model {model!r}")
    return p


def layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def apply_update(model: str, p: Params, h: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """UPDATE(h, z): combine node state with aggregated neighbours."""
    if model == "gcn":
        # Self-loop is part of the normalized adjacency; z already includes h.
        return z @ p["w"] + p["b"]
    if model == "sage":
        return h @ p["w_self"] + z @ p["w_neigh"] + p["b"]
    if model == "gin":
        s = (1.0 + p["eps"]) * h + z
        return torch.relu(s @ p["w1"] + p["b1"]) @ p["w2"] + p["b"]
    if model == "gat":
        raise NotImplementedError(GAT_NOT_PORTED)
    raise ValueError(f"apply_update: {model!r} has no linear UPDATE")
