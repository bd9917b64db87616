"""k-hop ego-network extraction over the (partitioned) graph.

An online request is "classify node v now". Answering it with an L-layer
GCN needs v's distance-<=L in-neighbourhood: layer l of the forward reads
the post-layer-(l-1) values of each node's in-neighbours, so the value at
v after L layers depends on exactly the nodes within L in-edge hops.

:func:`extract_ego` materializes that neighbourhood as a *relabeled local
CSR* with a sharp exactness contract:

* nodes at distance <= L-1 from the targets get their COMPLETE in-edge
  rows, sliced verbatim from the global CSR (same neighbour order, same
  weights — so the degree-ladder bucket K and the reduction order inside
  ``bucketed_aggregate`` match the full-batch forward bit for bit);
* nodes at exactly distance L are included as columns (their *input*
  features feed the deepest aggregation) but get EMPTY rows — their own
  post-layer values are garbage-by-construction and provably never reach
  the target logits, so leaving the rows empty keeps the subgraph minimal
  without breaking parity.

BFS discovery order == row order, so ``nodes[:num_targets]`` are the
request targets and the i-th CSR row is the i-th discovered node.

:func:`sample_neighbors` is the fanout-capped variant (DGL-style
neighbour sampling for latency-bounded serving): per-hop caps subsample
each frontier row *order-preservingly* (sorted choice), trading exactness
for bounded work. ``fanouts=None`` degrades to ``extract_ego``.

The extractor works on any object exposing a global ``csr_by_dst()``-form
CSR — the serving layer passes the full graph's CSR regardless of how the
feature store is partitioned; partition ownership only matters to the
feature cache, not to the structure walk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.graph.structure import CSR


@dataclass(frozen=True)
class EgoNet:
    """One request's relabeled k-hop neighbourhood.

    ``nodes``      — global node ids, BFS order (targets first); local id
                     of global node ``nodes[i]`` is ``i``.
    ``num_targets``— how many leading entries of ``nodes`` are request
                     targets (their logits are the answer).
    ``csr``        — local-id CSR: complete rows for every node expanded
                     (distance <= L-1), empty rows for the distance-L rim.
    ``num_expanded`` — count of rows with complete neighbourhoods; rows
                     ``[num_expanded, len(nodes))`` are the rim.
    """

    nodes: np.ndarray
    num_targets: int
    csr: CSR
    num_expanded: int

    @property
    def num_nodes(self) -> int:
        return int(self.nodes.shape[0])


def _subsample_row(idx: np.ndarray, w: np.ndarray, cap: int,
                   rng: np.random.Generator
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Cap one neighbour row, keeping the survivors in their original
    relative order so repeated extraction stays deterministic per seed."""
    if idx.shape[0] <= cap:
        return idx, w
    keep = np.sort(rng.choice(idx.shape[0], size=cap, replace=False))
    return idx[keep], w[keep]


def extract_ego(csr: CSR, targets: Sequence[int], num_hops: int,
                fanouts: Optional[Sequence[int]] = None,
                rng: Optional[np.random.Generator] = None) -> EgoNet:
    """Extract the distance-<=``num_hops`` in-neighbourhood of ``targets``.

    ``csr`` is the GLOBAL dst-indexed operator (row v = in-neighbours of
    v, the aggregation the model trains on). ``fanouts``, when given, is
    one per-row cap per hop (hop 0 = the targets' own rows) and switches
    the walk to sampled mode; full-fanout extraction is exact and is the
    configuration covered by the bit-parity guarantee.
    """
    if num_hops < 0:
        raise ValueError(f"extract_ego: num_hops must be >= 0, "
                         f"got {num_hops}")
    tgt = np.asarray(list(targets), dtype=np.int64)
    if tgt.size == 0:
        raise ValueError("extract_ego: empty target list")
    if tgt.min() < 0 or tgt.max() >= csr.num_rows:
        raise ValueError(
            f"extract_ego: target ids out of range [0, {csr.num_rows})")
    if np.unique(tgt).size != tgt.size:
        raise ValueError("extract_ego: duplicate target ids in one "
                         "request (merge them client-side)")
    if fanouts is not None:
        if len(fanouts) != num_hops:
            raise ValueError(
                f"extract_ego: need one fanout per hop "
                f"({num_hops}), got {len(fanouts)}")
        if rng is None:
            rng = np.random.default_rng(0)

    local = {int(v): i for i, v in enumerate(tgt)}
    nodes: List[int] = [int(v) for v in tgt]
    # Per expanded node, its (global-id neighbour list, weights) — index
    # in this list == local row id, because expansion follows discovery
    # order exactly.
    rows: List[Tuple[np.ndarray, np.ndarray]] = []

    frontier = list(range(tgt.size))  # local ids awaiting expansion
    for hop in range(num_hops):
        nxt: List[int] = []
        for u in frontier:
            g = nodes[u]
            lo, hi = int(csr.indptr[g]), int(csr.indptr[g + 1])
            idx = np.asarray(csr.indices[lo:hi], dtype=np.int64)
            w = np.asarray(csr.weights[lo:hi], dtype=np.float32)
            if fanouts is not None:
                idx, w = _subsample_row(idx, w, int(fanouts[hop]), rng)
            rows.append((idx, w))
            for nb in idx:
                nb = int(nb)
                if nb not in local:
                    local[nb] = len(nodes)
                    nodes.append(nb)
                    nxt.append(local[nb])
        frontier = nxt
    # frontier now holds the distance-num_hops rim: columns, empty rows.

    num_expanded = len(rows)
    n = len(nodes)
    indptr = np.zeros(n + 1, dtype=np.int64)
    all_idx: List[np.ndarray] = []
    all_w: List[np.ndarray] = []
    for r, (idx, w) in enumerate(rows):
        indptr[r + 1] = indptr[r] + idx.shape[0]
        all_idx.append(np.asarray([local[int(v)] for v in idx],
                                  dtype=np.int32))
        all_w.append(w)
    indptr[num_expanded + 1:] = indptr[num_expanded]  # rim rows are empty
    ego_csr = CSR(
        indptr=indptr,
        indices=(np.concatenate(all_idx) if all_idx
                 else np.zeros(0, np.int32)),
        weights=(np.concatenate(all_w) if all_w
                 else np.zeros(0, np.float32)),
        num_rows=n, num_cols=n)
    return EgoNet(nodes=np.asarray(nodes, dtype=np.int64),
                  num_targets=int(tgt.size),
                  csr=ego_csr, num_expanded=num_expanded)


def sample_neighbors(csr: CSR, targets: Sequence[int], num_hops: int,
                     fanouts: Sequence[int],
                     rng: Optional[np.random.Generator] = None) -> EgoNet:
    """Fanout-capped ego extraction (latency-bounded, inexact)."""
    return extract_ego(csr, targets, num_hops, fanouts=fanouts, rng=rng)


def remote_frontier(ego: EgoNet, part: np.ndarray, home: int) -> np.ndarray:
    """Global ids in ``ego`` whose features live off-partition — the set
    the serving feature cache must cover before the dispatch."""
    owner = np.asarray(part)[ego.nodes]
    return ego.nodes[owner != home]
