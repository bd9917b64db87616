"""Host-side graph containers (numpy) used for preprocessing.

The paper's pipeline does all graph preprocessing (partitioning, remote-graph
construction, MVC) on the host with NetworkX/METIS before training; we mirror
that split — numpy here, JAX arrays only in the training step.

Edges are directed ``src -> dst``: messages flow from ``src`` into the
aggregation of ``dst`` (i.e. ``src in N(dst)``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class CSR:
    """Compressed-sparse-row adjacency grouped by destination row.

    ``indptr[d]:indptr[d+1]`` spans the incoming neighbour slots of row ``d``;
    ``indices`` holds source ids and ``weights`` the per-edge coefficients.
    This layout *is* the paper's "clustering and sorting" (§4 step 1): all
    sources that aggregate into the same destination are contiguous, so the
    destination row can stay resident in the fastest memory tier.
    """

    indptr: np.ndarray  # [num_rows + 1] int32
    indices: np.ndarray  # [nnz] int32 (source ids)
    weights: np.ndarray  # [nnz] float32
    num_rows: int
    num_cols: int

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_degrees(self) -> np.ndarray:
        return np.diff(self.indptr)


def coo_to_csr(
    src: np.ndarray,
    dst: np.ndarray,
    weights: Optional[np.ndarray],
    num_rows: int,
    num_cols: int,
) -> CSR:
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if weights is None:
        weights = np.ones(src.shape[0], dtype=np.float32)
    weights = np.asarray(weights, dtype=np.float32)
    order = np.argsort(dst, kind="stable")
    src, dst, weights = src[order], dst[order], weights[order]
    indptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.add.at(indptr, dst + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int64)
    return CSR(indptr=indptr, indices=src, weights=weights, num_rows=num_rows, num_cols=num_cols)


@dataclass
class Graph:
    """A directed graph in COO form with optional edge weights."""

    num_nodes: int
    src: np.ndarray
    dst: np.ndarray
    edge_weight: Optional[np.ndarray] = None
    # Optional node-level payloads used by the GCN datasets.
    labels: Optional[np.ndarray] = None
    train_mask: Optional[np.ndarray] = None
    meta: dict = field(default_factory=dict)

    def __post_init__(self):
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst shape mismatch")

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def in_degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, dtype=np.int64)
        np.add.at(deg, self.dst, 1)
        return deg

    def out_degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_nodes, dtype=np.int64)
        np.add.at(deg, self.src, 1)
        return deg

    def dedupe(self) -> "Graph":
        key = self.src.astype(np.int64) * self.num_nodes + self.dst
        _, keep = np.unique(key, return_index=True)
        keep.sort()
        ew = self.edge_weight[keep] if self.edge_weight is not None else None
        return Graph(self.num_nodes, self.src[keep], self.dst[keep], ew,
                     self.labels, self.train_mask, dict(self.meta))

    def remove_self_loops(self) -> "Graph":
        keep = self.src != self.dst
        ew = self.edge_weight[keep] if self.edge_weight is not None else None
        return Graph(self.num_nodes, self.src[keep], self.dst[keep], ew,
                     self.labels, self.train_mask, dict(self.meta))

    def add_self_loops(self) -> "Graph":
        loops = np.arange(self.num_nodes, dtype=np.int32)
        src = np.concatenate([self.src, loops])
        dst = np.concatenate([self.dst, loops])
        ew = None
        if self.edge_weight is not None:
            ew = np.concatenate([self.edge_weight, np.ones(self.num_nodes, np.float32)])
        return Graph(self.num_nodes, src, dst, ew, self.labels, self.train_mask, dict(self.meta))

    def make_undirected(self) -> "Graph":
        """Mirror every edge (paper converts papers100M to undirected)."""
        fwd = self.remove_self_loops()
        src = np.concatenate([fwd.src, fwd.dst])
        dst = np.concatenate([fwd.dst, fwd.src])
        g = Graph(self.num_nodes, src, dst, None, self.labels, self.train_mask, dict(self.meta))
        return g.dedupe()

    def gcn_normalized(self, self_loops: bool = True) -> "Graph":
        """Attach symmetric-normalized weights w_uv = d_u^-1/2 d_v^-1/2."""
        g = self.add_self_loops() if self_loops else self
        deg = np.zeros(g.num_nodes, dtype=np.float64)
        np.add.at(deg, g.dst, 1.0)
        inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)), 0.0)
        w = (inv_sqrt[g.src] * inv_sqrt[g.dst]).astype(np.float32)
        return Graph(g.num_nodes, g.src, g.dst, w, g.labels, g.train_mask, dict(g.meta))

    def mean_normalized(self, self_loops: bool = True) -> "Graph":
        """Attach mean-aggregator weights w_uv = 1/deg_in(v) (GraphSAGE)."""
        g = self.add_self_loops() if self_loops else self
        deg = np.zeros(g.num_nodes, dtype=np.float64)
        np.add.at(deg, g.dst, 1.0)
        w = (1.0 / np.maximum(deg[g.dst], 1.0)).astype(np.float32)
        return Graph(g.num_nodes, g.src, g.dst, w, g.labels, g.train_mask, dict(g.meta))

    def csr_by_dst(self) -> CSR:
        return coo_to_csr(self.src, self.dst, self.edge_weight, self.num_nodes, self.num_nodes)


def block_diag_csrs(csrs: Sequence[CSR]) -> CSR:
    """Merge CSRs into one block-diagonal operator (no cross-block edges).

    Block b's rows land at ``sum(num_rows[:b])`` and its column ids shift by
    ``sum(num_cols[:b])``, so aggregating the concatenated feature rows with
    the merged layout equals aggregating each block independently — the
    packing the serving batcher (and any many-small-graphs workload) uses
    to push B irregular graphs through one bucketed-ELL dispatch. Per-row
    neighbour order is preserved exactly, which is what keeps the packed
    reduction bit-identical to the per-graph one.
    """
    if not csrs:
        return CSR(np.zeros(1, np.int64), np.zeros(0, np.int32),
                   np.zeros(0, np.float32), 0, 0)
    indptr = [np.zeros(1, np.int64)]
    indices: List[np.ndarray] = []
    weights: List[np.ndarray] = []
    row_off = 0
    col_off = 0
    nnz_off = 0
    for c in csrs:
        indptr.append(np.asarray(c.indptr[1:], np.int64) + nnz_off)
        indices.append(np.asarray(c.indices, np.int32) + col_off)
        weights.append(np.asarray(c.weights, np.float32))
        row_off += c.num_rows
        col_off += c.num_cols
        nnz_off += c.nnz
    return CSR(indptr=np.concatenate(indptr),
               indices=(np.concatenate(indices) if indices
                        else np.zeros(0, np.int32)),
               weights=(np.concatenate(weights) if weights
                        else np.zeros(0, np.float32)),
               num_rows=row_off, num_cols=col_off)


def transpose_csr(csr: CSR) -> CSR:
    """The reverse-graph CSR: out_t[c] = sum over entries (r, c, w) of w*g[r].

    Aggregating with the transposed layout *is* the VJP of aggregating with
    the original one — the bucketed-ELL backward pass is built on this.
    """
    rows = np.repeat(np.arange(csr.num_rows, dtype=np.int32),
                     np.diff(csr.indptr))
    return coo_to_csr(rows, csr.indices, csr.weights,
                      num_rows=csr.num_cols, num_cols=csr.num_rows)


def ell_from_csr(
    csr: CSR,
    max_nnz: Optional[int] = None,
    on_overflow: str = "error",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert CSR to padded ELL (indices, weights, mask).

    The TPU aggregation kernel consumes fixed-shape neighbour slots; padding
    slots point at row 0 with weight 0 so gathers stay in-bounds.
    Returns (idx [R, K], w [R, K], valid [R, K]).

    When ``max_nnz`` is smaller than the max row degree the layout cannot
    hold every edge: ``on_overflow="error"`` (default) raises — use
    :func:`bucketed_ell_from_csr`, which never drops edges, for graphs whose
    max degree makes a single-K layout impractical; ``"truncate"`` keeps
    only the first ``max_nnz`` slots per row (explicit opt-in to the lossy
    behaviour that used to happen silently).
    """
    deg = csr.row_degrees()
    k = int(deg.max()) if max_nnz is None and csr.nnz else int(max_nnz or 0)
    k = max(k, 1)
    if csr.nnz and int(deg.max()) > k:
        if on_overflow == "error":
            raise ValueError(
                f"ell_from_csr: max_nnz={k} < max row degree "
                f"{int(deg.max())} would drop edges; pass "
                f"on_overflow='truncate' to keep the first {k} slots per "
                "row, or use bucketed_ell_from_csr (lossless)")
        if on_overflow != "truncate":
            raise ValueError(f"unknown on_overflow {on_overflow!r}")
    rows = csr.num_rows
    idx = np.zeros((rows, k), dtype=np.int32)
    w = np.zeros((rows, k), dtype=np.float32)
    valid = np.zeros((rows, k), dtype=bool)
    if csr.nnz:
        row_ids = np.repeat(np.arange(rows), deg)
        slots = np.arange(csr.nnz) - csr.indptr[row_ids]
        keep = slots < k
        r, s = row_ids[keep], slots[keep]
        idx[r, s] = csr.indices[keep]
        w[r, s] = csr.weights[keep]
        valid[r, s] = True
    return idx, w, valid


# --------------------------------------------------------------------------
# Degree-bucketed blocked-ELL (the aggregation kernel's production layout)
# --------------------------------------------------------------------------


@dataclass
class EllBucket:
    """One degree class: every member row has degree in (k/growth, k].

    ``rows[i]`` is the destination row the i-th bucket row scatters into;
    ``idx``/``w`` are its neighbour slots (0-padded past the degree).
    """

    k: int
    rows: np.ndarray  # [Rb] int64
    idx: np.ndarray   # [Rb, k] int32
    w: np.ndarray     # [Rb, k] float32


@dataclass
class BucketedEll:
    """Degree-bucketed blocked-ELL layout of one (possibly rectangular)
    aggregation operator: out[rows] += sum_k w * x[idx], per bucket.

    Rows are split by degree class so padding waste is bounded by the
    bucket growth factor instead of the max degree (see
    ``bucketed_ell_from_csr``). Zero-degree rows appear in no bucket.
    """

    num_rows: int
    num_cols: int
    nnz: int
    buckets: List[EllBucket] = field(default_factory=list)

    @property
    def ks(self) -> List[int]:
        return [b.k for b in self.buckets]

    @property
    def padded_slots(self) -> int:
        return sum(b.rows.shape[0] * b.k for b in self.buckets)

    @property
    def padding_ratio(self) -> float:
        """Padded slots per edge; the growth-2 ladder guarantees < 2."""
        return self.padded_slots / max(self.nnz, 1)


def degree_bucket_ladder(max_degree: int, min_k: int = 1,
                         growth: int = 2) -> List[int]:
    """Slot counts {min_k, min_k*growth, ...} covering ``max_degree``."""
    ks = []
    k = max(int(min_k), 1)
    while True:
        ks.append(k)
        if k >= max_degree:
            return ks
        k = max(k * growth, k + 1)


def bucket_padded_degrees(degrees: np.ndarray, min_k: int = 1,
                          growth: int = 2) -> np.ndarray:
    """Per-row padded slot count under the bucket ladder: the smallest
    ladder K >= degree (0 for degree-0 rows, which join no bucket). This
    is the cost the blocked-ELL layout actually pays per row — the
    bucket-aware partitioner weights nodes by it instead of raw degree."""
    deg = np.asarray(degrees)
    out = np.zeros(deg.shape, dtype=np.int64)
    pos = deg > 0
    if pos.any():
        ks = np.asarray(degree_bucket_ladder(int(deg.max()), min_k, growth))
        out[pos] = ks[np.searchsorted(ks, deg[pos])]
    return out


def bucketed_slot_count(degrees: np.ndarray, min_k: int = 1,
                        growth: int = 2) -> int:
    """Padded slots a degree multiset occupies under the bucket ladder —
    the layout cost ``partition_stats`` accounts per partition without
    materializing the layout."""
    return int(bucket_padded_degrees(degrees, min_k, growth).sum())


def bucketed_ell_from_csr(csr: CSR, min_k: int = 1,
                          growth: int = 2) -> BucketedEll:
    """Split CSR rows into degree buckets and pad each to its bucket's K.

    A row of degree d lands in the bucket with K = the smallest ladder slot
    count >= d, so (with the default growth-2 ladder) it wastes < d slots:
    total padded slots < 2 * nnz on ANY graph — versus max-degree padding's
    ``num_rows * max_degree`` blow-up on power-law graphs. Lossless: every
    edge keeps exactly one slot (cf. ``ell_from_csr``'s overflow error).
    """
    out = BucketedEll(csr.num_rows, csr.num_cols, csr.nnz)
    if not csr.nnz:
        return out
    deg = csr.row_degrees()
    lo = 0
    for k in degree_bucket_ladder(int(deg.max()), min_k, growth):
        sel = np.where((deg > lo) & (deg <= k))[0]
        lo = k
        if not len(sel):
            continue
        d = deg[sel]
        offs = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
        pos = np.repeat(csr.indptr[sel], d) + offs
        rr = np.repeat(np.arange(len(sel)), d)
        idx = np.zeros((len(sel), k), dtype=np.int32)
        w = np.zeros((len(sel), k), dtype=np.float32)
        idx[rr, offs] = csr.indices[pos]
        w[rr, offs] = csr.weights[pos]
        out.buckets.append(EllBucket(k, sel.astype(np.int64), idx, w))
    return out


def stack_bucketed_ells(
    ells: Sequence[BucketedEll],
    row_align: int = 8,
) -> List[Tuple[int, np.ndarray, np.ndarray, np.ndarray]]:
    """Pad per-worker bucketed layouts to common shapes for vmap/shard_map.

    Buckets are merged on the union ladder across workers; each bucket's
    row count is padded to the max across workers (rounded up to
    ``row_align`` for the kernel's sublane tiling). Padding rows scatter a
    zero contribution into row 0. Returns [(k, rows [P, Rk], idx
    [P, Rk, k], w [P, Rk, k])], one entry per bucket.
    """
    ks = sorted({b.k for e in ells for b in e.buckets})
    out = []
    for k in ks:
        per = [next((b for b in e.buckets if b.k == k), None) for e in ells]
        rmax = max(b.rows.shape[0] if b is not None else 0 for b in per)
        rmax = max(row_align, -(-rmax // row_align) * row_align)
        rows = np.zeros((len(ells), rmax), dtype=np.int64)
        idx = np.zeros((len(ells), rmax, k), dtype=np.int64)
        w = np.zeros((len(ells), rmax, k), dtype=np.float32)
        for p, b in enumerate(per):
            if b is None:
                continue
            n = b.rows.shape[0]
            rows[p, :n] = b.rows
            idx[p, :n] = b.idx
            w[p, :n] = b.w
        out.append((k, rows, idx, w))
    return out
