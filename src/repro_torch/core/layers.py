"""GNN layer definitions in PyTorch (counterpart of ``repro/core/layers.py``).

UPDATE stages for GCN, GraphSAGE and GIN (§3.2), and GAT, whose attention
fuses aggregation and update. The AGGREGATE stage of the linear models is
supplied by the caller as ``agg_fn``, as in the JAX package.

The dense products stay ``torch.matmul`` in full fp32: the JAX package
left them to XLA outside any kernel, and the port needs
``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default) for
them to stay fp32 on the card; the server sets it.

GAT's attention is plain ``jnp`` in the JAX package (no Pallas kernel), so
it is plain PyTorch here. Its weighted sum takes one of two forms:

* with autograd recording (training), ``einsum`` over the slots, which
  differentiates in the attention weights;
* otherwise (evaluation, serving), the ``seg_aggregate`` kernel over a
  stacked layout whose workers are the heads: ``Wh`` laid out ``[H, N,
  dh]``, each head's slot weights its attention. The kernel sums each
  row's slots in slot order and stores the row once, so a served row
  equals its full-batch value bit for bit, as the linear models' rows do.

Distributed (the stacked workers of ``core.trainer``), a layer's softmax
runs over in-edges that arrive in parts: the local graph's while the
halo's wire is in flight, then each exchange stage's received rows. A
:class:`GatPartial` holds, per destination and head, the running maximum
of the scores and the sums of ``exp(e - max)`` and of ``exp(e - max) *
Wh_src`` over the in-edges seen so far; ``merge_halo`` adds a stage's
halo in-edges by a log-sum-exp rescale and ``finish`` divides, so the
softmax is one over all of a node's in-edges, exact to rounding.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core.record import backward_between, indexed, span
from repro_torch.kernels.seg_aggregate import (DeviceBucketedEll, DeviceEllBucket,
                                               add_rows, bucketed_aggregate, flat_rows)

Params = Dict[str, torch.Tensor]


def glorot(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    fan_in, fan_out = shape[-2], shape[-1]
    lim = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen, dtype=dtype) * 2.0 - 1.0) * lim


def init_layer(gen: torch.Generator, model: str, d_in: int, d_out: int,
               heads: int = 4) -> Params:
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
        if d_out % heads:
            raise ValueError(f"gat: d_out {d_out} % heads {heads}")
        dh = d_out // heads
        p["w"] = glorot(gen, (d_in, d_out))
        p["a_src"] = glorot(gen, (heads, dh))
        p["a_dst"] = glorot(gen, (heads, dh))
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
    raise ValueError(f"apply_update: {model!r} has no linear UPDATE")


def _heads(p: Params, wh: torch.Tensor, heads: int):
    """(Wh as [N, H, dh], e_src [N, H], e_dst [N, H]) of ``wh = h @ W``.
    The per-head dot products reduce over dh in one fixed order whatever
    N is."""
    whh = wh.reshape(wh.shape[0], heads, wh.shape[-1] // heads)
    return whh, (whh * p["a_src"]).sum(-1), (whh * p["a_dst"]).sum(-1)


def _attention_inputs(p: Params, h: torch.Tensor, heads: int):
    """:func:`_heads` of ``h @ W``."""
    return _heads(p, h @ p["w"], heads)


NEG = -1e9   # the score of an invalid slot


def _scores(e_dst_rows: torch.Tensor, e_src: torch.Tensor, idx: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
    """e [R, K, H]: leaky_relu(e_dst[r] + e_src[idx[r, k]]) on the valid
    slots, :data:`NEG` on the others. The gather ``e_src[idx]`` is the span
    ``gnn.gat.gather`` (``which`` ``e_src``)."""
    e = torch.nn.functional.leaky_relu(
        e_dst_rows[:, None, :] + indexed(e_src, idx, "gnn.gat.gather", which="e_src"), 0.2)
    return torch.where(valid[..., None], e, NEG)


def _attention(e_dst_rows: torch.Tensor, e_src: torch.Tensor, idx: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """alpha [R, K, H]: softmax over each row's valid slots of
    :func:`_scores` (so a degree-0 row stays finite), 0 on the invalid
    slots."""
    alpha = torch.softmax(_scores(e_dst_rows, e_src, idx, valid), dim=1)
    return torch.where(valid[..., None], alpha, 0.0)


def _records_grad(p: Params, h: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and (h.requires_grad or p["w"].requires_grad)


def gat_aggregate(
    p: Params,
    h: torch.Tensor,          # [N, d_in]
    ell_idx: torch.Tensor,    # [R, K]
    ell_valid: torch.Tensor,  # [R, K] bool
    heads: int,
) -> torch.Tensor:
    """Full GAT layer on a dense ELL neighbourhood (one graph)."""
    r = ell_idx.shape[0]
    whh, e_src, e_dst = _attention_inputs(p, h, heads)
    idx = ell_idx.long()
    alpha = _attention(e_dst[:r], e_src, idx, ell_valid)
    out = torch.einsum("rkh,rkhd->rhd", alpha, whh[idx])
    return out.reshape(r, -1) + p["b"]


def gat_aggregate_bucketed(
    p: Params,
    h: torch.Tensor,          # [N, d_in]
    ell: DeviceBucketedEll,   # one graph's degree-bucketed layout
    num_rows: int,
    heads: int,
) -> torch.Tensor:
    """GAT layer on the shared degree-bucketed ELL layout.

    Every row's neighbour slots live in exactly one degree bucket, so the
    per-row softmax is computed bucket-locally over K (not max-degree)
    slots. Slot validity is w > 0 (padding weights are exactly 0;
    normalized edge weights are strictly positive). Each destination row
    is in one bucket, so adding each bucket's rows onto zeros is one add
    per row. Only a bucket's real rows (``n``) are computed: the JAX
    package's padding rows add exact zeros. In training, the three
    gathers of each bucket are the span ``gnn.gat.gather`` (``which``:
    ``e_dst``, ``e_src``, ``whh``), forward and backward, while torch's
    profiler records.
    """
    whh, e_src, e_dst = _attention_inputs(p, h, heads)
    dh = whh.shape[-1]
    if _records_grad(p, h):
        out = torch.zeros((num_rows, heads * dh), dtype=whh.dtype, device=whh.device)
        for b in ell.buckets:
            if not b.n:
                continue
            rows, idx = b.rows[:b.n].long(), b.idx[:b.n].long()
            alpha = _attention(indexed(e_dst, rows, "gnn.gat.gather", which="e_dst"),
                               e_src, idx, b.w[:b.n] > 0)
            agg = torch.einsum("rkh,rkhd->rhd", alpha,
                               indexed(whh, idx, "gnn.gat.gather", which="whh"))
            out = out.index_add(0, rows, agg.reshape(b.n, heads * dh))
        return out + p["b"]
    # Heads as the stacked axis of one seg_aggregate launch.
    stacked = []
    for b in ell.buckets:
        if not b.n:
            continue
        rows, idx = b.rows[:b.n], b.idx[:b.n]
        alpha = _attention(e_dst[rows.long()], e_src, idx.long(), b.w[:b.n] > 0)
        stacked.append(DeviceEllBucket(
            rows=rows.expand(heads, b.n).contiguous(),
            idx=idx.expand(heads, *idx.shape).contiguous(),
            w=alpha.permute(2, 0, 1).contiguous(), n=b.n,
            counts=torch.full((heads,), b.n, dtype=torch.int32, device=whh.device)))
    xs = whh.permute(1, 0, 2).contiguous()                    # [H, N, dh]
    out = bucketed_aggregate(xs, DeviceBucketedEll(tuple(stacked)), num_rows)
    return out.permute(1, 0, 2).reshape(num_rows, heads * dh) + p["b"]


# --------------------------------------------------------------------------
# GAT over a partitioned graph: softmax partials, local then halo
# --------------------------------------------------------------------------


def _partial(whh: torch.Tensor, e_src: torch.Tensor, e_dst: torch.Tensor,
             src_rows: int, dst_rows: int,
             coo: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
    """(max [P * dst_rows, H], sums [P * dst_rows, H, dh + 1]) over one
    stacked map of in-edges ``coo`` (src, dst, w), [P, nnz], source rows
    ``whh``/``e_src`` ([P * src_rows] flat), destination scores ``e_dst``
    ([P * dst_rows]): each row's maximum first, then the edges' terms
    added in a fixed order. The padding entries (w = 0, all at row 0) are
    dropped first, so no row's gathers pile up in the index backward."""
    n, heads, dh = e_dst.shape[0], whh.shape[1], whh.shape[2]
    keep = (coo[2] != 0).reshape(-1).nonzero().squeeze(1)
    src = flat_rows(coo[0], src_rows).reshape(-1)[keep]
    dst = flat_rows(coo[1], dst_rows).reshape(-1)[keep]
    e = torch.nn.functional.leaky_relu(
        indexed(e_dst, dst, "gnn.gat.gather", which="e_dst")
        + indexed(e_src, src, "gnn.gat.gather", which="e_src"), 0.2)
    top = torch.full((n, heads), NEG, dtype=whh.dtype, device=whh.device).scatter_reduce(
        0, dst[:, None].expand_as(e), e.detach(), "amax")
    ex = torch.exp(e - top[dst])[..., None]
    vals = torch.cat([ex * indexed(whh, src, "gnn.gat.gather", which="whh"), ex], -1)
    acc = torch.zeros((n, heads, dh + 1), dtype=whh.dtype, device=whh.device)
    return top, add_rows(acc, dst, vals)


class GatPartial(NamedTuple):
    """One GAT layer's softmax over the in-edges seen so far, for every
    destination row of the stacked workers (``shape`` (P, M), held flat):
    ``top`` [P * M, H], the scores' running maximum (a constant of the
    softmax, detached), and ``acc`` [P * M, H, dh + 1], the sums of
    ``exp(e - top) * Wh_src`` and, last, of ``exp(e - top)``."""

    p: Params
    heads: int
    layer: int
    shape: Tuple[int, int]
    e_dst: torch.Tensor
    top: torch.Tensor
    acc: torch.Tensor

    def merge(self, top: torch.Tensor, acc: torch.Tensor) -> "GatPartial":
        """This partial and another over other in-edges of the same rows,
        rescaled to their common maximum."""
        m = torch.maximum(self.top, top)
        return self._replace(top=m, acc=self.acc * torch.exp(self.top - m)[..., None]
                             + acc * torch.exp(top - m)[..., None])

    def merge_halo(self, recv: torch.Tensor, plan) -> "GatPartial":
        """Merge one exchange stage's halo in-edges: the received rows
        ``recv`` [P, K, F] (raw sources; a plan with pre-aggregated slots
        is refused before training) transformed and scored here, each
        received entry of ``plan`` (``recv_row`` -> ``recv_dst``) an
        in-edge. The span ``gnn.gat.halo`` (``layer``), forward and
        backward, while the profiler records."""
        P, K, F = recv.shape
        with span("gnn.gat.halo", layer=self.layer):
            wh = recv.reshape(P * K, F) @ self.p["w"]
            whh, e_src, _ = _heads(self.p, wh, self.heads)
            top, acc = _partial(whh, e_src, self.e_dst, K, self.shape[1],
                                (plan.recv_row, plan.recv_dst, plan.recv_weight))
            out = self.merge(top, acc)
            backward_between(out.acc, wh)
        return out

    def finish(self) -> torch.Tensor:
        """The layer's output [P, M, H * dh]: each row's weighted sum over
        its softmax's sum, plus the bias (rows with no in-edge: the bias)."""
        den = self.acc[..., -1:]
        out = self.acc[..., :-1] / torch.where(den > 0, den, 1.0)
        return out.reshape(*self.shape, -1) + self.p["b"]


def gat_local_partial(p: Params, h: torch.Tensor, heads: int, layer: int,
                      coo: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> GatPartial:
    """The softmax partials of every stacked worker's local in-edges (self
    loops included), the ``coo`` (src, dst, w) arrays, for ``h`` [P, M, F]."""
    P, M, F = h.shape
    whh, e_src, e_dst = _attention_inputs(p, h.reshape(P * M, F), heads)
    top, acc = _partial(whh, e_src, e_dst, M, M, coo)
    return GatPartial(p, heads, layer, (P, M), e_dst, top, acc)
