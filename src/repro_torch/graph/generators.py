"""Synthetic graph generators.

Offline container: the OGB / Reddit / IGB datasets used in the paper are not
downloadable, so the experiments run on synthetic graphs chosen to match the
relevant structural regimes (see DESIGN.md §8.3):

* ``rmat_graph``  — power-law/community structure, the regime that stresses
  partition cut quality and communication imbalance (scaling/comm experiments).
* ``sbm_graph``   — stochastic block model with a learnable community signal
  plus correlated node features (accuracy/convergence experiments).
* ``erdos_graph`` — uniform random baseline (worst-case cuts).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.graph.structure import Graph


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    undirected: bool = True,
) -> Graph:
    """R-MAT (Graph500-style) generator: 2**scale nodes, edge_factor*n edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    d = 1.0 - a - b - c
    for bit in range(scale):
        r = rng.random(m)
        # Quadrant choice per edge per bit.
        src_bit = (r >= a + b).astype(np.int64)
        dst_bit = (((r >= a) & (r < a + b)) | (r >= a + b + c)).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    g = Graph(n, src.astype(np.int32), dst.astype(np.int32))
    g = g.remove_self_loops().dedupe()
    if undirected:
        g = g.make_undirected()
    g.meta.update(kind="rmat", scale=scale, edge_factor=edge_factor)
    return g


def sbm_graph(
    num_nodes: int,
    num_blocks: int,
    avg_degree: float = 20.0,
    homophily: float = 0.9,
    seed: int = 0,
) -> Graph:
    """Stochastic block model with planted community labels.

    ``homophily`` is the fraction of edge endpoints that stay inside the block.
    Labels are the block ids; a GCN can recover them from structure + features.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_blocks, size=num_nodes).astype(np.int32)
    m = int(num_nodes * avg_degree / 2)
    src = rng.integers(0, num_nodes, size=m).astype(np.int64)
    same = rng.random(m) < homophily
    # For homophilous edges pick dst uniformly inside src's block; otherwise anywhere.
    by_block = [np.where(labels == b)[0] for b in range(num_blocks)]
    dst = rng.integers(0, num_nodes, size=m).astype(np.int64)
    for b in range(num_blocks):
        sel = same & (labels[src] == b)
        cnt = int(sel.sum())
        if cnt and len(by_block[b]):
            dst[sel] = rng.choice(by_block[b], size=cnt)
    g = Graph(num_nodes, src.astype(np.int32), dst.astype(np.int32), labels=labels)
    g = g.remove_self_loops().dedupe().make_undirected()
    g.labels = labels
    train = rng.random(num_nodes) < 0.5
    g.train_mask = train
    g.meta.update(kind="sbm", num_blocks=num_blocks, homophily=homophily)
    return g


def erdos_graph(num_nodes: int, avg_degree: float = 8.0, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(num_nodes * avg_degree / 2)
    src = rng.integers(0, num_nodes, size=m).astype(np.int32)
    dst = rng.integers(0, num_nodes, size=m).astype(np.int32)
    g = Graph(num_nodes, src, dst).remove_self_loops().dedupe().make_undirected()
    g.meta.update(kind="erdos")
    return g


def sbm_features(
    g: Graph, feat_dim: int, noise: float = 1.0, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Block-correlated node features: class centroid + Gaussian noise."""
    if g.labels is None:
        raise ValueError("graph has no labels")
    rng = np.random.default_rng(seed)
    k = int(g.labels.max()) + 1
    centroids = rng.normal(size=(k, feat_dim)).astype(np.float32)
    x = centroids[g.labels] + noise * rng.normal(size=(g.num_nodes, feat_dim)).astype(np.float32)
    return x.astype(np.float32), g.labels
