"""A cell's inputs, made from ``--seed`` alone: the graph, its labels, train
mask and features (the frozen generators of ``gnnbench.frozen``), the
model's initial parameters (on the device, from a seeded generator there),
and the random draws of a training step.

Both sides get the same inputs: the program through the graph and feature
sources this module registers (``make_program_graph``), and through the
``params`` and ``randomness`` arguments of its entry points; the reference
reads the raw arrays and draws the same numbers itself.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from gnnbench.frozen import generators as gen


def seed_rng(seed: int, *name: int) -> np.random.Generator:
    """A numpy generator for one named use of the seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *name]))


def make_graph(graph: Dict, classes: int, feat_dim: int, seed: int) -> Dict:
    """The raw graph of a configuration's ``graph`` section (``num_nodes``,
    ``mean_degree``) under a traffic file's (``kind``, ``structure_seed``
    and the generator's knobs): ``num_nodes``, ``src``, ``dst``
    (unnormalized, no self loops, undirected), ``labels``, ``train_mask``
    and the features ``x`` [N, feat_dim] (class centroid plus noise), as
    numpy arrays.

    The graph, its labels and its train split are the cell's dataset, made
    from ``structure_seed``: every run trains on the same graph, as users
    train on one, and every seed costs the same work. The features come
    from ``seed``, as do the weights and the draws."""
    kind = graph["kind"]
    structure = int(graph["structure_seed"])
    if kind == "sbm":
        g = gen.sbm_graph(graph["num_nodes"], classes, avg_degree=graph["mean_degree"],
                          homophily=graph["homophily"], seed=structure)
    elif kind == "rmat":
        scale = int(graph["num_nodes"]).bit_length() - 1
        if 1 << scale != graph["num_nodes"]:
            raise ValueError(f"rmat needs a power of two of nodes, not {graph['num_nodes']}")
        g = gen.rmat_graph(scale, edge_factor=graph["edge_factor"], seed=structure)
        rng = seed_rng(structure, 1)
        g.labels = rng.integers(0, classes, size=g.num_nodes).astype(np.int32)
        g.train_mask = rng.random(g.num_nodes) < graph["train_share"]
    else:
        raise ValueError(f"unknown graph kind {kind!r}")
    x, _ = gen.sbm_features(g, feat_dim, noise=graph["feat_noise"], seed=int(seed))
    return {"num_nodes": int(g.num_nodes), "src": g.src.copy(), "dst": g.dst.copy(),
            "labels": np.asarray(g.labels, np.int32).copy(),
            "train_mask": np.asarray(g.train_mask, bool).copy(), "x": x}


# --------------------------------------------------------------------------
# The program's graph and feature sources
# --------------------------------------------------------------------------

SOURCE = "gnnbench"
_CURRENT: Dict = {}


def register_program_sources(raw: Dict) -> None:
    """Hand ``raw`` to the program: its ``graph.source=gnnbench`` and
    ``graph.features=gnnbench`` (``repro_torch.run.sources``' registries)
    return copies of these arrays."""
    from repro_torch.graph.structure import Graph as PortGraph
    from repro_torch.run.spec import FEATURE_SOURCES, GRAPH_SOURCES

    _CURRENT.clear()
    _CURRENT.update(raw)
    if SOURCE not in GRAPH_SOURCES:
        GRAPH_SOURCES.add(SOURCE, lambda spec: PortGraph(
            _CURRENT["num_nodes"], _CURRENT["src"].copy(), _CURRENT["dst"].copy(),
            labels=_CURRENT["labels"].copy(),
            train_mask=_CURRENT["train_mask"].copy()))
        FEATURE_SOURCES.add(SOURCE, lambda g, spec: _CURRENT["x"].copy())


def make_program_graph(raw: Dict):
    """The raw arrays as the port's Graph (the single-device entry takes
    one directly)."""
    from repro_torch.graph.structure import Graph as PortGraph
    return PortGraph(raw["num_nodes"], raw["src"].copy(), raw["dst"].copy(),
                     labels=raw["labels"].copy(), train_mask=raw["train_mask"].copy())


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------


def layer_shapes(model: Dict):
    """Per layer, the (name, shape, kind) of each parameter, in the port's
    keys; kind is glorot, ones or zeros."""
    dims = ([model["in_dim"]] + [model["hidden_dim"]] * (model["num_layers"] - 1)
            + [model["num_classes"]])
    out = []
    for i in range(model["num_layers"]):
        d_in, d_out = dims[i], dims[i + 1]
        leaves = [("ln_scale", (d_in,), "ones"), ("ln_bias", (d_in,), "zeros"),
                  ("b", (d_out,), "zeros")]
        if model["model"] == "sage":
            leaves += [("w_self", (d_in, d_out), "glorot"),
                       ("w_neigh", (d_in, d_out), "glorot")]
        elif model["model"] == "gat":
            dh = d_out // model["heads"]
            leaves += [("w", (d_in, d_out), "glorot"),
                       ("a_src", (model["heads"], dh), "glorot"),
                       ("a_dst", (model["heads"], dh), "glorot")]
        else:
            raise ValueError(f"no parameters for model {model['model']!r}")
        out.append(leaves)
    return out


def make_params(model: Dict, seed: int, device) -> Dict:
    """Initial parameters in the port's tree, made on ``device`` from the
    seed in two draws: every glorot matrix from one uniform buffer, the
    label embedding (N(0, 0.02^2)) from one normal draw."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), 7]).generate_state(1, np.uint64)[0]
                      & 0x7FFFFFFFFFFFFFFF))
    shapes = layer_shapes(model)
    total = sum(math.prod(s) for leaves in shapes for _, s, k in leaves if k == "glorot")
    u = torch.rand(total, generator=g, device=device)
    layers, at = [], 0
    for leaves in shapes:
        p = {}
        for name, shape, kind in leaves:
            if kind == "glorot":
                n = math.prod(shape)
                lim = math.sqrt(6.0 / (shape[-2] + shape[-1]))
                p[name] = (u[at:at + n].reshape(shape) * 2.0 - 1.0) * lim
                at += n
            elif kind == "ones":
                p[name] = torch.ones(shape, device=device)
            else:
                p[name] = torch.zeros(shape, device=device)
        layers.append(p)
    params = {"layers": layers}
    if model["label_prop"]:
        params["lp_embed"] = torch.randn((model["num_classes"], model["in_dim"]),
                                         generator=g, device=device) * 0.02
    return params


# --------------------------------------------------------------------------
# Random draws
# --------------------------------------------------------------------------

_KINDS = {"lp": 1, "dropout": 2, "quant": 3}


class Draws:
    """The random draws of a training step, by name, with the methods the
    port's trainers call (``lp_select``, ``dropout_keep``,
    ``quant_uniform``). Every draw seeds its own ``torch.Generator`` on the
    device from (seed, epoch, name), so a draw does not depend on the
    order it is asked for: the scheme of the port's ``GeneratorRandomness``,
    so a run draws the numbers that the port's own default would."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def _uniform(self, shape, device, *name: int) -> torch.Tensor:
        state = np.random.SeedSequence([self.seed, *name]).generate_state(2, np.uint32)
        g = torch.Generator(device=device)
        g.manual_seed(int(state[0]) << 31 ^ int(state[1]))
        return torch.rand(shape, generator=g, device=device)

    def lp_select(self, epoch: int, shape, rate: float, device) -> torch.Tensor:
        return self._uniform(shape, device, epoch, _KINDS["lp"]) < rate

    def dropout_keep(self, epoch: int, layer: int, shape, keep: float,
                     device) -> torch.Tensor:
        return self._uniform(shape, device, epoch, _KINDS["dropout"], layer) < keep

    def quant_uniform(self, epoch: int, layer: int, stage: int, backward: bool,
                      shape, device) -> torch.Tensor:
        return self._uniform(shape, device, epoch, _KINDS["quant"], layer, stage,
                             int(backward))
