"""Remote-graph construction: hybrid pre-/post-aggregation via MVC (paper §5).

After partitioning, each worker owns a subgraph split into:

* a **local graph** (both endpoints owned) aggregated with the optimized
  operator, and
* a **remote graph** (cut edges) whose communication is minimized by
  classifying every cut edge as *pre-aggregation* (partial sum computed at
  the source worker, one row per covered destination) or *post-aggregation*
  (raw source feature sent once, aggregated at the destination) — Algo 1.

The classification solves Minimum Vertex Cover on the bipartite remote graph
of every ordered partition pair (König/Hopcroft–Karp ⇒ optimal volume,
§5.3). ``strategy`` selects the paper's ablations (Table 5):

  ``vanilla`` — one transfer per cut edge (Fig 4a)
  ``pre``     — all edges pre-aggregated  (Fig 4b, DistGNN-style [44])
  ``post``    — all boundary sources raw  (Fig 4c, SAR/BNS/Pipe-style [46,56-58])
  ``hybrid``  — MVC hybrid                (Fig 4d, this paper)

All arrays here are host-side numpy; ``repro_torch.core.distributed`` lifts them
into padded JAX buffers for the shard_map all-to-all.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.graph.mvc import min_vertex_cover_bipartite, verify_cover
from repro_torch.quant.stochastic import wire_bytes as quant_wire_bytes
from repro_torch.graph.partition import partition_graph, partition_hierarchical
from repro_torch.graph.structure import (
    CSR,
    BucketedEll,
    Graph,
    bucketed_ell_from_csr,
    coo_to_csr,
    transpose_csr,
)


@dataclass
class PairPlan:
    """Halo-exchange plan for one ordered partition pair q -> p.

    The wire buffer for this pair has ``n_post + n_pre`` feature rows:
    rows ``[0, n_post)`` are raw covered-source features, rows
    ``[n_post, n_post + n_pre)`` are pre-aggregated partials (one per
    covered destination).
    """

    q: int
    p: int
    n_post: int
    n_pre: int
    # sender (q) side
    post_gather_local: np.ndarray  # [n_post] local src ids to copy raw
    pre_src_local: np.ndarray      # [pre_nnz] local src id per pre edge
    pre_slot: np.ndarray           # [pre_nnz] partial-row slot per pre edge
    pre_weight: np.ndarray         # [pre_nnz]
    # receiver (p) side
    post_row: np.ndarray           # [post_nnz] wire row (< n_post) per post edge
    post_dst_local: np.ndarray     # [post_nnz] local dst id per post edge
    post_weight: np.ndarray        # [post_nnz]
    pre_dst_local: np.ndarray      # [n_pre] local dst id per partial row

    @property
    def volume(self) -> int:
        return self.n_post + self.n_pre


@dataclass
class CommStats:
    """Logical communication volumes (feature rows) per strategy — Table 5.

    The hierarchical fields are populated by
    ``build_hierarchical_partitioned_graph`` and stay zero for flat plans:
    ``intra_rows``/``inter_rows`` are the realized two-level volumes (fast
    intra-group exchange vs the group-aggregated inter-group exchange), and
    ``flat_inter_rows`` is what the same cross-group traffic would cost on a
    flat worker-to-worker all_to_all — the hierarchy's savings are
    ``flat_inter_rows / inter_rows``.
    """

    nparts: int
    vanilla: int
    pre: int
    post: int
    hybrid: int
    per_pair_hybrid: np.ndarray  # [P, P] volume q->p under selected strategy
    selected: str
    padded_rows_per_pair: int    # wire padding for the selected strategy
    # --- hierarchical (two-level) accounting; 0 when the plan is flat.
    num_groups: int = 0
    group_size: int = 0
    intra_rows: int = 0          # rows on intra-group exchanges (fast fabric)
    inter_rows: int = 0          # rows crossing groups after group aggregation
    flat_inter_rows: int = 0     # same cross-group traffic under flat a2a

    @property
    def hierarchical(self) -> bool:
        return self.num_groups > 1

    def inter_savings(self) -> float:
        """Flat-vs-hierarchical row ratio on the slow (inter-group) level."""
        if not self.inter_rows:
            return 1.0
        return self.flat_inter_rows / self.inter_rows

    def stage_rows(self, stage: Optional[str] = None,
                   strategy: Optional[str] = None) -> int:
        """Logical feature rows one exchange stage sends per epoch.

        ``stage`` None/"flat" -> the flat exchange under ``strategy`` (or
        the selected one); "intra"/"inter" -> the realized two-level rows.
        """
        if stage in (None, "flat"):
            return getattr(self, strategy or self.selected)
        if stage == "intra":
            return self.intra_rows
        if stage == "inter":
            return self.inter_rows
        raise ValueError(f"unknown stage {stage!r}")

    def volume_bytes(self, feat_dim: int, bits: int = 32,
                     strategy: str = None, stage: str = None,
                     cd: int = 1) -> float:
        """Predicted wire bytes per epoch for one exchange stage.

        ``bits`` 32/0 -> fp32 rows; 2/4/8 -> quantized payload plus the
        fp32 (zero, scale) pair per 4-row quant group (Eqn 5's params
        term). ``cd`` amortizes a delayed-comm stage over its refresh
        period. This is the prediction the exchange schedule's realized
        per-stage volumes are checked against (benchmarks/comm_volume.py).
        """
        rows = self.stage_rows(stage, strategy)
        if bits in (0, 32):
            return rows * feat_dim * 4.0 / cd
        return quant_wire_bytes(rows, feat_dim, bits) / cd

    def as_dict(self) -> dict:
        d = {
            "nparts": self.nparts,
            "vanilla": self.vanilla,
            "pre": self.pre,
            "post": self.post,
            "hybrid": self.hybrid,
            "selected": self.selected,
            "padded_rows_per_pair": self.padded_rows_per_pair,
        }
        if self.hierarchical:
            d.update({
                "num_groups": self.num_groups,
                "group_size": self.group_size,
                "intra_rows": self.intra_rows,
                "inter_rows": self.inter_rows,
                "flat_inter_rows": self.flat_inter_rows,
                "inter_savings": round(self.inter_savings(), 4),
            })
        return d


@dataclass
class PartitionedGraph:
    """Everything a distributed full-batch trainer needs, per partition."""

    nparts: int
    part: np.ndarray                 # [N] global node -> part
    owned: List[np.ndarray]          # global ids owned by each part (sorted)
    local_index: np.ndarray          # [N] global node -> local id within part
    local_csr: List[CSR]             # local (intra-part) aggregation graphs
    pair_plans: Dict[Tuple[int, int], PairPlan]
    stats: CommStats
    num_nodes: int
    max_owned: int                   # max nodes per part (local padding)
    # Degree-bucketed blocked-ELL layouts of each local graph, fixed at
    # partition time (MG-GCN-style): forward, and the reverse-graph layout
    # that drives the aggregation kernel's custom VJP.
    local_ell: List[BucketedEll] = field(default_factory=list)
    local_ell_t: List[BucketedEll] = field(default_factory=list)

    def halo_in_volume(self, p: int) -> int:
        return sum(pl.volume for (q, pp), pl in self.pair_plans.items() if pp == p)


@dataclass
class HaloPlan:
    """Padded, device-ready halo plan (built by repro_torch.core.distributed)."""

    nparts: int
    rows_per_pair: int
    send_gather_idx: np.ndarray   # [P, P*R] local ids (post rows), 0 padded
    send_gather_mask: np.ndarray  # [P, P*R] bool
    pre_src: np.ndarray           # [P, pre_nnz_max] local src ids per pre edge
    pre_slot: np.ndarray          # [P, pre_nnz_max] flat wire slot (dest-major)
    pre_weight: np.ndarray        # [P, pre_nnz_max]
    recv_row: np.ndarray          # [P, recv_nnz_max] flat recv row per edge
    recv_dst: np.ndarray          # [P, recv_nnz_max] local dst per edge
    recv_weight: np.ndarray       # [P, recv_nnz_max]


def _classify_pair(
    sub_src: np.ndarray,
    sub_dst: np.ndarray,
    sub_w: np.ndarray,
    strategy: str,
) -> Tuple[np.ndarray, dict]:
    """Return boolean mask ``is_post`` per cut edge of this pair + volumes."""
    srcs, src_inv = np.unique(sub_src, return_inverse=True)
    dsts, dst_inv = np.unique(sub_dst, return_inverse=True)
    volumes = {
        "vanilla": len(sub_src),
        "pre": len(dsts),
        "post": len(srcs),
    }
    if strategy == "post":
        is_post = np.ones(len(sub_src), dtype=bool)
    elif strategy == "pre":
        is_post = np.zeros(len(sub_src), dtype=bool)
    elif strategy == "vanilla":
        # Executed as post-aggregation but *without* source dedup is pointless
        # on the wire buffer model; vanilla exists for volume accounting only.
        is_post = np.ones(len(sub_src), dtype=bool)
    elif strategy == "hybrid":
        cover_u, cover_v = min_vertex_cover_bipartite(
            len(srcs), len(dsts), src_inv, dst_inv
        )
        assert verify_cover(src_inv, dst_inv, cover_u, cover_v)
        # Algo 1: src in cover -> post (send raw src once); else dst in cover -> pre.
        is_post = cover_u[src_inv]
        not_covered = ~(cover_u[src_inv] | cover_v[dst_inv])
        assert not not_covered.any(), "MVC failed to cover some cut edge"
        volumes["hybrid"] = int(cover_u.sum() + cover_v.sum())
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    if "hybrid" not in volumes:
        n_post_srcs = len(np.unique(sub_src[is_post])) if is_post.any() else 0
        n_pre_dsts = len(np.unique(sub_dst[~is_post])) if (~is_post).any() else 0
        volumes["hybrid"] = n_post_srcs + n_pre_dsts
    return is_post, volumes


def build_partitioned_graph(
    g: Graph,
    nparts: int,
    part: Optional[np.ndarray] = None,
    strategy: str = "hybrid",
    seed: int = 0,
) -> PartitionedGraph:
    """Partition ``g`` and build local graphs + pre/post halo plans."""
    if g.edge_weight is None:
        g = Graph(g.num_nodes, g.src, g.dst,
                  np.ones(g.num_edges, np.float32), g.labels, g.train_mask, dict(g.meta))
    if part is None:
        part = partition_graph(g, nparts, seed=seed)
    part = np.asarray(part, dtype=np.int32)

    owned = [np.sort(np.where(part == p)[0]).astype(np.int64) for p in range(nparts)]
    local_index = np.zeros(g.num_nodes, dtype=np.int64)
    for p in range(nparts):
        local_index[owned[p]] = np.arange(len(owned[p]))
    max_owned = max((len(o) for o in owned), default=0)

    sp, dp = part[g.src], part[g.dst]
    is_local = sp == dp

    # Local graphs (reindexed to local ids, CSR by local dst).
    local_csr: List[CSR] = []
    for p in range(nparts):
        sel = is_local & (dp == p)
        ls = local_index[g.src[sel]]
        ld = local_index[g.dst[sel]]
        lw = g.edge_weight[sel]
        local_csr.append(coo_to_csr(ls, ld, lw, len(owned[p]), len(owned[p])))

    # Remote graphs per ordered pair + MVC classification.
    pair_plans: Dict[Tuple[int, int], PairPlan] = {}
    totals = {"vanilla": 0, "pre": 0, "post": 0, "hybrid": 0}
    per_pair = np.zeros((nparts, nparts), dtype=np.int64)
    cut_sel = ~is_local
    cs, cd, cw = g.src[cut_sel], g.dst[cut_sel], g.edge_weight[cut_sel]
    csp, cdp = part[cs], part[cd]
    for q in range(nparts):
        for p in range(nparts):
            if q == p:
                continue
            sel = (csp == q) & (cdp == p)
            if not sel.any():
                continue
            es, ed, ew = cs[sel], cd[sel], cw[sel]
            is_post, volumes = _classify_pair(es, ed, ew, strategy)
            for k in totals:
                totals[k] += volumes[k]

            # Post side: distinct covered srcs, sent raw.
            post_src_g = es[is_post]
            post_dst_g = ed[is_post]
            post_w = ew[is_post]
            post_srcs, post_row = (np.unique(post_src_g, return_inverse=True)
                                   if is_post.any() else (np.array([], np.int64), np.array([], np.int64)))
            # Pre side: distinct covered dsts, one partial row each.
            pre_src_g = es[~is_post]
            pre_dst_g = ed[~is_post]
            pre_w = ew[~is_post]
            pre_dsts, pre_slot = (np.unique(pre_dst_g, return_inverse=True)
                                  if (~is_post).any() else (np.array([], np.int64), np.array([], np.int64)))

            plan = PairPlan(
                q=q, p=p,
                n_post=len(post_srcs), n_pre=len(pre_dsts),
                post_gather_local=local_index[post_srcs].astype(np.int64),
                pre_src_local=local_index[pre_src_g].astype(np.int64),
                pre_slot=pre_slot.astype(np.int64),
                pre_weight=pre_w.astype(np.float32),
                post_row=post_row.astype(np.int64),
                post_dst_local=local_index[post_dst_g].astype(np.int64),
                post_weight=post_w.astype(np.float32),
                pre_dst_local=local_index[pre_dsts].astype(np.int64),
            )
            pair_plans[(q, p)] = plan
            vol = plan.volume if strategy != "vanilla" else volumes["vanilla"]
            per_pair[q, p] = vol

    selected_total = {"vanilla": totals["vanilla"], "pre": totals["pre"],
                      "post": totals["post"], "hybrid": totals["hybrid"]}[strategy]
    # For execution, pre/post/hybrid all use deduped buffers; per_pair holds
    # the realized row counts for the *selected* strategy.
    if strategy != "vanilla":
        realized = sum(pl.volume for pl in pair_plans.values())
        assert realized == selected_total or strategy in ("pre", "post"), \
            (realized, selected_total)
    padded = int(per_pair.max()) if per_pair.size else 0

    stats = CommStats(
        nparts=nparts,
        vanilla=totals["vanilla"],
        pre=totals["pre"],
        post=totals["post"],
        hybrid=totals["hybrid"],
        per_pair_hybrid=per_pair,
        selected=strategy,
        padded_rows_per_pair=padded,
    )
    return PartitionedGraph(
        nparts=nparts,
        part=part,
        owned=owned,
        local_index=local_index,
        local_csr=local_csr,
        pair_plans=pair_plans,
        stats=stats,
        num_nodes=g.num_nodes,
        max_owned=max_owned,
        local_ell=[bucketed_ell_from_csr(c) for c in local_csr],
        local_ell_t=[bucketed_ell_from_csr(transpose_csr(c))
                     for c in local_csr],
    )


def build_halo_plan(pg: PartitionedGraph, rows_per_pair: Optional[int] = None) -> HaloPlan:
    """Flatten per-pair plans into fixed-shape (padded) device arrays.

    Wire layout: each part sends ``P`` chunks of ``R = rows_per_pair`` rows;
    chunk ``p`` of sender ``q`` holds ``[post raws | pre partials | padding]``
    for pair (q, p). After ``all_to_all`` the receiver sees chunk ``q`` at
    offset ``q*R``.
    """
    P = pg.nparts
    R = rows_per_pair if rows_per_pair is not None else max(pg.stats.padded_rows_per_pair, 1)

    pre_nnz_max = 1
    recv_nnz_max = 1
    for p in range(P):
        pre_nnz = sum(len(pl.pre_src_local) for (q, pp), pl in pg.pair_plans.items() if q == p)
        recv_nnz = sum(len(pl.post_row) + pl.n_pre
                       for (q, pp), pl in pg.pair_plans.items() if pp == p)
        pre_nnz_max = max(pre_nnz_max, pre_nnz)
        recv_nnz_max = max(recv_nnz_max, recv_nnz)

    send_gather_idx = np.zeros((P, P * R), dtype=np.int64)
    send_gather_mask = np.zeros((P, P * R), dtype=bool)
    pre_src = np.zeros((P, pre_nnz_max), dtype=np.int64)
    pre_slot = np.zeros((P, pre_nnz_max), dtype=np.int64)
    pre_weight = np.zeros((P, pre_nnz_max), dtype=np.float32)
    recv_row = np.zeros((P, recv_nnz_max), dtype=np.int64)
    recv_dst = np.zeros((P, recv_nnz_max), dtype=np.int64)
    recv_weight = np.zeros((P, recv_nnz_max), dtype=np.float32)

    pre_fill = np.zeros(P, dtype=np.int64)
    recv_fill = np.zeros(P, dtype=np.int64)
    for (q, p), pl in pg.pair_plans.items():
        if pl.volume > R:
            raise ValueError(f"pair ({q},{p}) volume {pl.volume} > rows_per_pair {R}")
        base = p * R  # offset inside q's send buffer
        # Sender q: raw post rows.
        n_post = pl.n_post
        send_gather_idx[q, base:base + n_post] = pl.post_gather_local
        send_gather_mask[q, base:base + n_post] = True
        # Sender q: pre-aggregation scatter into partial rows.
        k = len(pl.pre_src_local)
        f = pre_fill[q]
        pre_src[q, f:f + k] = pl.pre_src_local
        pre_slot[q, f:f + k] = base + n_post + pl.pre_slot
        pre_weight[q, f:f + k] = pl.pre_weight
        pre_fill[q] += k
        # Receiver p: post edges + pre partial adds, recv chunk q at q*R.
        rbase = q * R
        kpost = len(pl.post_row)
        f = recv_fill[p]
        recv_row[p, f:f + kpost] = rbase + pl.post_row
        recv_dst[p, f:f + kpost] = pl.post_dst_local
        recv_weight[p, f:f + kpost] = pl.post_weight
        f += kpost
        npre = pl.n_pre
        recv_row[p, f:f + npre] = rbase + n_post + np.arange(npre)
        recv_dst[p, f:f + npre] = pl.pre_dst_local
        recv_weight[p, f:f + npre] = 1.0  # edge weights already applied at source
        recv_fill[p] += kpost + npre

    return HaloPlan(
        nparts=P,
        rows_per_pair=R,
        send_gather_idx=send_gather_idx,
        send_gather_mask=send_gather_mask,
        pre_src=pre_src,
        pre_slot=pre_slot,
        pre_weight=pre_weight,
        recv_row=recv_row,
        recv_dst=recv_dst,
        recv_weight=recv_weight,
    )


# --------------------------------------------------------------------------
# Hierarchical (two-level) halo plans — the paper's contribution (2)
# --------------------------------------------------------------------------


@dataclass
class GroupPairPlan:
    """Group-level halo plan for one ordered group pair gq -> gp.

    The inter-group wire buffer for this pair has ``n_post + n_pre`` rows:
    rows ``[0, n_post)`` are raw covered-source features (each crosses the
    group boundary ONCE even when it feeds several workers of gp — the flat
    plan sends it once per destination worker), rows ``[n_post, ...)`` are
    per-destination partials merged across ALL of gq's senders at the group
    aggregation step (the flat plan ships one partial per sender worker).
    All node ids here are global; ``build_hier_halo_plan`` lowers them to
    per-worker local indices.
    """

    gq: int
    gp: int
    n_post: int
    n_pre: int
    post_srcs: np.ndarray    # [n_post] global covered source ids (wire order)
    post_row: np.ndarray     # [post_nnz] wire row (< n_post) per post edge
    post_dst: np.ndarray     # [post_nnz] global dst per post edge
    post_weight: np.ndarray  # [post_nnz]
    pre_src: np.ndarray      # [pre_nnz] global src per pre edge
    pre_slot: np.ndarray     # [pre_nnz] partial-row slot (< n_pre) per edge
    pre_weight: np.ndarray   # [pre_nnz]
    pre_dsts: np.ndarray     # [n_pre] global covered destination ids

    @property
    def volume(self) -> int:
        return self.n_post + self.n_pre


@dataclass
class HierPartitionedGraph:
    """Flat P-way partition plus group-level plans for the two-level exchange."""

    base: PartitionedGraph
    num_groups: int
    group_size: int
    group_pair_plans: Dict[Tuple[int, int], GroupPairPlan]
    stats: CommStats  # base stats + per-level hierarchical volumes

    # Delegates so trainer-side code can treat flat/hier uniformly.
    @property
    def nparts(self) -> int:
        return self.base.nparts

    @property
    def part(self) -> np.ndarray:
        return self.base.part

    @property
    def owned(self) -> List[np.ndarray]:
        return self.base.owned

    @property
    def local_index(self) -> np.ndarray:
        return self.base.local_index

    @property
    def local_csr(self) -> List[CSR]:
        return self.base.local_csr

    @property
    def max_owned(self) -> int:
        return self.base.max_owned

    @property
    def num_nodes(self) -> int:
        return self.base.num_nodes


@dataclass
class HierHaloPlan:
    """Padded device-ready two-level plan.

    ``intra`` is a per-group flat exchange: chunk index = destination rank
    inside the group (``group_size`` chunks of ``intra.rows_per_pair`` rows).
    ``inter`` is each worker's additive contribution to its group's outgoing
    buffer (``num_groups`` chunks of ``inter.rows_per_pair`` rows; a psum
    over the intra-group axis materializes the group buffer). Both reuse the
    ``HaloPlan`` array layout so the device lowering is shared.
    """

    nparts: int
    num_groups: int
    group_size: int
    intra: HaloPlan
    inter: HaloPlan


def build_hierarchical_partitioned_graph(
    g: Graph,
    num_groups: int,
    group_size: int,
    part: Optional[np.ndarray] = None,
    strategy: str = "hybrid",
    seed: int = 0,
) -> HierPartitionedGraph:
    """Partition hierarchically and build both worker- and group-level plans.

    Same-group worker pairs keep the flat per-pair (MVC-classified) plans —
    they ride the fast intra-group exchange. Cross-group edges are
    re-classified at *group* granularity: MVC on the bipartite remote graph
    of (sources in gq) x (destinations in gp), which both dedups raw sources
    across gp's workers and merges partials across gq's workers.
    """
    if g.edge_weight is None:
        g = Graph(g.num_nodes, g.src, g.dst,
                  np.ones(g.num_edges, np.float32), g.labels, g.train_mask,
                  dict(g.meta))
    if part is None:
        part = partition_hierarchical(g, num_groups, group_size, seed=seed)
    part = np.asarray(part, dtype=np.int32)
    nparts = num_groups * group_size
    base = build_partitioned_graph(g, nparts, part=part, strategy=strategy,
                                   seed=seed)

    grp = part // group_size
    sp, dp = grp[g.src], grp[g.dst]
    cross = sp != dp
    cs, cd, cw = g.src[cross], g.dst[cross], g.edge_weight[cross]
    csg, cdg = grp[cs], grp[cd]

    group_pair_plans: Dict[Tuple[int, int], GroupPairPlan] = {}
    inter_rows = 0
    for gq in range(num_groups):
        for gp in range(num_groups):
            if gq == gp:
                continue
            sel = (csg == gq) & (cdg == gp)
            if not sel.any():
                continue
            es, ed, ew = cs[sel], cd[sel], cw[sel]
            is_post, _ = _classify_pair(es, ed, ew, strategy)
            post_srcs, post_row = (np.unique(es[is_post], return_inverse=True)
                                   if is_post.any()
                                   else (np.array([], np.int64),
                                         np.array([], np.int64)))
            pre_dsts, pre_slot = (np.unique(ed[~is_post], return_inverse=True)
                                  if (~is_post).any()
                                  else (np.array([], np.int64),
                                        np.array([], np.int64)))
            plan = GroupPairPlan(
                gq=gq, gp=gp,
                n_post=len(post_srcs), n_pre=len(pre_dsts),
                post_srcs=post_srcs.astype(np.int64),
                post_row=post_row.astype(np.int64),
                post_dst=ed[is_post].astype(np.int64),
                post_weight=ew[is_post].astype(np.float32),
                pre_src=es[~is_post].astype(np.int64),
                pre_slot=pre_slot.astype(np.int64),
                pre_weight=ew[~is_post].astype(np.float32),
                pre_dsts=pre_dsts.astype(np.int64),
            )
            group_pair_plans[(gq, gp)] = plan
            inter_rows += plan.volume

    intra_rows = sum(pl.volume for (q, p), pl in base.pair_plans.items()
                     if q // group_size == p // group_size)
    flat_inter_rows = sum(pl.volume for (q, p), pl in base.pair_plans.items()
                          if q // group_size != p // group_size)

    stats = dataclasses.replace(
        base.stats,
        num_groups=num_groups,
        group_size=group_size,
        intra_rows=int(intra_rows),
        inter_rows=int(inter_rows),
        flat_inter_rows=int(flat_inter_rows),
    )
    base.stats = stats
    return HierPartitionedGraph(
        base=base,
        num_groups=num_groups,
        group_size=group_size,
        group_pair_plans=group_pair_plans,
        stats=stats,
    )


def build_hier_halo_plan(
    hpg: HierPartitionedGraph,
    intra_rows_per_pair: Optional[int] = None,
    inter_rows_per_group_pair: Optional[int] = None,
) -> HierHaloPlan:
    """Lower the two-level plan to fixed-shape per-worker arrays.

    Intra wire layout (per worker): ``group_size`` chunks of ``R_i`` rows,
    chunk r = rows for the same-group worker with rank r. Inter wire layout:
    ``num_groups`` chunks of ``R_e`` rows, chunk gp = this worker's additive
    contribution to the group buffer destined for group gp. ``R_i`` is padded
    to a multiple of 4 (quant row groups) and ``R_e`` to a multiple of
    ``4 * group_size`` so the buffer reduce-scatters evenly over the
    intra-group axis with quant groups intact.
    """
    base = hpg.base
    P = base.nparts
    G, W = hpg.num_groups, hpg.group_size
    part = base.part
    lidx = base.local_index

    same_group = {k: pl for k, pl in base.pair_plans.items()
                  if k[0] // W == k[1] // W}
    R_i = intra_rows_per_pair
    if R_i is None:
        R_i = max((pl.volume for pl in same_group.values()), default=1)
    R_i = max(4, (R_i + 3) // 4 * 4)

    R_e = inter_rows_per_group_pair
    if R_e is None:
        R_e = max((pl.volume for pl in hpg.group_pair_plans.values()),
                  default=1)
    quantum = 4 * W
    R_e = max(quantum, (R_e + quantum - 1) // quantum * quantum)

    # --- Level 1: intra-group flat exchange (chunk = destination rank).
    i_pre_counts = np.zeros(P, dtype=np.int64)
    i_recv_counts = np.zeros(P, dtype=np.int64)
    for (q, p), pl in same_group.items():
        i_pre_counts[q] += len(pl.pre_src_local)
        i_recv_counts[p] += len(pl.post_row) + pl.n_pre
    i_pre_max = max(1, int(i_pre_counts.max()))
    i_recv_max = max(1, int(i_recv_counts.max()))

    isg_idx = np.zeros((P, W * R_i), dtype=np.int64)
    isg_mask = np.zeros((P, W * R_i), dtype=bool)
    ipre_src = np.zeros((P, i_pre_max), dtype=np.int64)
    ipre_slot = np.zeros((P, i_pre_max), dtype=np.int64)
    ipre_w = np.zeros((P, i_pre_max), dtype=np.float32)
    irecv_row = np.zeros((P, i_recv_max), dtype=np.int64)
    irecv_dst = np.zeros((P, i_recv_max), dtype=np.int64)
    irecv_w = np.zeros((P, i_recv_max), dtype=np.float32)

    ipre_fill = np.zeros(P, dtype=np.int64)
    irecv_fill = np.zeros(P, dtype=np.int64)
    for (q, p), pl in same_group.items():
        if pl.volume > R_i:
            raise ValueError(
                f"intra pair ({q},{p}) volume {pl.volume} > rows_per_pair {R_i}")
        base_off = (p % W) * R_i
        n_post = pl.n_post
        isg_idx[q, base_off:base_off + n_post] = pl.post_gather_local
        isg_mask[q, base_off:base_off + n_post] = True
        k = len(pl.pre_src_local)
        f = ipre_fill[q]
        ipre_src[q, f:f + k] = pl.pre_src_local
        ipre_slot[q, f:f + k] = base_off + n_post + pl.pre_slot
        ipre_w[q, f:f + k] = pl.pre_weight
        ipre_fill[q] += k
        rbase = (q % W) * R_i
        kpost = len(pl.post_row)
        f = irecv_fill[p]
        irecv_row[p, f:f + kpost] = rbase + pl.post_row
        irecv_dst[p, f:f + kpost] = pl.post_dst_local
        irecv_w[p, f:f + kpost] = pl.post_weight
        f += kpost
        npre = pl.n_pre
        irecv_row[p, f:f + npre] = rbase + n_post + np.arange(npre)
        irecv_dst[p, f:f + npre] = pl.pre_dst_local
        irecv_w[p, f:f + npre] = 1.0
        irecv_fill[p] += kpost + npre

    intra = HaloPlan(
        nparts=W, rows_per_pair=R_i,
        send_gather_idx=isg_idx, send_gather_mask=isg_mask,
        pre_src=ipre_src, pre_slot=ipre_slot, pre_weight=ipre_w,
        recv_row=irecv_row, recv_dst=irecv_dst, recv_weight=irecv_w,
    )

    # --- Level 2: per-worker contribution to the group send buffer + the
    # per-worker scatter of the reassembled group recv buffer.
    pre_owner = {}   # (gq, gp) -> worker owning each pre edge's source
    post_owner = {}  # (gq, gp) -> worker owning each post row's source
    dst_owner_post = {}
    dst_owner_pre = {}
    e_pre_counts = np.zeros(P, dtype=np.int64)
    e_recv_counts = np.zeros(P, dtype=np.int64)
    for key, pl in hpg.group_pair_plans.items():
        post_owner[key] = part[pl.post_srcs]
        pre_owner[key] = part[pl.pre_src]
        dst_owner_post[key] = part[pl.post_dst]
        dst_owner_pre[key] = part[pl.pre_dsts]
        e_pre_counts += np.bincount(pre_owner[key], minlength=P)
        e_recv_counts += np.bincount(dst_owner_post[key], minlength=P)
        e_recv_counts += np.bincount(dst_owner_pre[key], minlength=P)
    e_pre_max = max(1, int(e_pre_counts.max()))
    e_recv_max = max(1, int(e_recv_counts.max()))

    esg_idx = np.zeros((P, G * R_e), dtype=np.int64)
    esg_mask = np.zeros((P, G * R_e), dtype=bool)
    epre_src = np.zeros((P, e_pre_max), dtype=np.int64)
    epre_slot = np.zeros((P, e_pre_max), dtype=np.int64)
    epre_w = np.zeros((P, e_pre_max), dtype=np.float32)
    erecv_row = np.zeros((P, e_recv_max), dtype=np.int64)
    erecv_dst = np.zeros((P, e_recv_max), dtype=np.int64)
    erecv_w = np.zeros((P, e_recv_max), dtype=np.float32)

    epre_fill = np.zeros(P, dtype=np.int64)
    erecv_fill = np.zeros(P, dtype=np.int64)
    for (gq, gp), pl in hpg.group_pair_plans.items():
        if pl.volume > R_e:
            raise ValueError(
                f"group pair ({gq},{gp}) volume {pl.volume} > rows {R_e}")
        base_off = gp * R_e
        # Senders (workers of gq): raw post rows, owner-exclusive slots.
        owners = post_owner[(gq, gp)]
        slots = base_off + np.arange(len(owners))
        esg_idx[owners, slots] = lidx[pl.post_srcs]
        esg_mask[owners, slots] = True
        # Senders: pre partials, additive across the group (merged by psum).
        owners = pre_owner[(gq, gp)]
        for w in np.unique(owners):
            sel = owners == w
            k = int(sel.sum())
            f = epre_fill[w]
            epre_src[w, f:f + k] = lidx[pl.pre_src[sel]]
            epre_slot[w, f:f + k] = base_off + pl.n_post + pl.pre_slot[sel]
            epre_w[w, f:f + k] = pl.pre_weight[sel]
            epre_fill[w] += k
        # Receivers (workers of gp): chunk gq sits at gq * R_e.
        rbase = gq * R_e
        owners = dst_owner_post[(gq, gp)]
        for w in np.unique(owners):
            sel = owners == w
            k = int(sel.sum())
            f = erecv_fill[w]
            erecv_row[w, f:f + k] = rbase + pl.post_row[sel]
            erecv_dst[w, f:f + k] = lidx[pl.post_dst[sel]]
            erecv_w[w, f:f + k] = pl.post_weight[sel]
            erecv_fill[w] += k
        owners = dst_owner_pre[(gq, gp)]
        for w in np.unique(owners):
            sel = owners == w
            k = int(sel.sum())
            f = erecv_fill[w]
            erecv_row[w, f:f + k] = rbase + pl.n_post + np.where(sel)[0]
            erecv_dst[w, f:f + k] = lidx[pl.pre_dsts[sel]]
            erecv_w[w, f:f + k] = 1.0
            erecv_fill[w] += k

    inter = HaloPlan(
        nparts=G, rows_per_pair=R_e,
        send_gather_idx=esg_idx, send_gather_mask=esg_mask,
        pre_src=epre_src, pre_slot=epre_slot, pre_weight=epre_w,
        recv_row=erecv_row, recv_dst=erecv_dst, recv_weight=erecv_w,
    )
    return HierHaloPlan(nparts=P, num_groups=G, group_size=W,
                        intra=intra, inter=inter)
