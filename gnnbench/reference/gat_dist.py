"""Plain reference of distributed full-batch GAT training with the paper's
exchange: raw halo rows only (``partition.strategy=post``), an optional
two-level hierarchy, stochastically rounded integer wires and delayed
halos.

The attention is ``reference/gat.py``'s over the raw edge list with a self
loop on every node: per edge the score ``leaky_relu(a_dst . Wh_d + a_src .
Wh_s, 0.2)``, one softmax over each node's in-edges, the weighted sum of
``Wh`` per head (Velickovic et al., arXiv 1710.10903). What the exchange
changes is where an edge reads its source row: an edge inside a worker,
or across an fp32 stage synchronised every epoch, reads this epoch's row;
an edge across a delayed stage reads the row its last refresh epoch
received (detached); an edge across a quantized stage reads that stage's
wire row, rounded with the formula ``floor((h - Z) * (1 / S) + u)`` per
4-row group and read back. Each source's ``Wh`` is computed from the row
the edge reads.

The P workers sit on a leading axis, as one device trains them. From the
program it takes only where rows sit (``placement``, read with
``reference/sage.py``'s helpers): the node each stacked row holds, and a
quantized stage's wire plan, which is held to the raw edges
(``edges_off``; a plan that counts an in-edge other than once, or that
sends a pre-aggregated row, is refused here).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from gnnbench.reference import common as C
from gnnbench.reference import sage as S


def prepare(cfg: Dict, traffic: Dict, raw: Dict, seed: int, device, placement: Dict) -> Dict:
    """The stacked worker arrays on the device and, for each stage, the
    in-edges that cross it (flat destination rows, and source rows in the
    table the stage serves), from the raw edges placed by the program's
    ``placement``."""
    owned = np.asarray(placement["owned"], np.int64)
    P, M = owned.shape
    hier = traffic["partition"].get("groups", 0) > 0
    G = traffic["partition"]["groups"] if hier else 1
    W = P // G
    n = raw["num_nodes"]
    real = owned >= 0
    pos = np.full(n, -1, np.int64)
    pos[owned[real]] = np.flatnonzero(real)
    off = int(np.abs(np.bincount(owned[real], minlength=n) - 1).sum())

    src = np.concatenate([raw["src"], np.arange(n)]).astype(np.int64)
    dst = np.concatenate([raw["dst"], np.arange(n)]).astype(np.int64)
    inv = (1.0 / np.bincount(dst, minlength=n)).astype(np.float32)
    ws, wd = pos[src] // M, pos[dst] // M
    crossing = np.where(ws == wd, -1, 0 if not hier else np.where(ws // W == wd // W, 0, 1))

    t = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.int64, device=device)
    fresh = crossing == -1
    stages = []
    for si, spec in enumerate(S._stages(traffic["schedule"], hier)):
        sel = crossing == si
        if not spec["bits"]:
            if spec["cd"] == 1:
                fresh |= sel
                stages.append({**spec, "kind": "fresh"})
            else:
                stages.append({**spec, "kind": "exact",
                               "edges": (t(pos[src[sel]]), t(pos[dst[sel]]))})
            continue
        plan = placement["stages"][si]
        if plan["level"] != spec["level"]:
            raise ValueError(f"stage {si} is {plan['level']!r} in the program, "
                             f"{spec['level']!r} in the traffic file")
        if np.asarray(plan["pre_mask"]).any():
            raise ValueError(f"stage {si} sends pre-aggregated rows: GAT reads raw "
                             "halo rows only (partition.strategy=post)")
        K, send, recv, wire_off = S._wire(plan, spec["level"], owned, inv,
                                          np.stack([src[sel], dst[sel]]), n, G, W)
        off += wire_off
        stages.append({**spec, "kind": "wire", "rows": K,
                       "send": (t(send[0]), t(send[1])), "edges": (t(recv[0]), t(recv[1]))})
    if off:
        raise ValueError(f"the program's placement counts {off} in-edges or nodes "
                         "other than once (edges_off)")

    x = np.zeros((P, M, raw["x"].shape[1]), np.float32)
    x[real] = raw["x"][owned[real]]
    labels = np.zeros((P, M), np.int64)
    labels[real] = raw["labels"][owned[real]]
    train = np.zeros((P, M), bool)
    train[real] = raw["train_mask"][owned[real]]
    f = lambda v, dt: torch.as_tensor(v, dtype=dt, device=device)
    return {"P": P, "G": G, "W": W, "M": M, "stages": stages,
            "fresh": (t(pos[src[fresh]]), t(pos[dst[fresh]])), "edges_off": off,
            "x": f(x, torch.float32), "labels": f(labels, torch.int64),
            "train": f(train, torch.bool)}


def attention_layer(L: Dict, q: Dict, h: torch.Tensor, heads: int, epoch: int, layer: int,
                    draws, cache: Dict, control: bool) -> torch.Tensor:
    """One GAT layer of every worker: the source rows each in-edge reads
    (this epoch's rows, a delayed stage's cached rows or a quantized
    stage's wire rows) in one table, then the attention over all in-edges
    of every node at once."""
    P, M = L["P"], L["M"]
    f = h.shape[-1]
    hf = h.reshape(P * M, f)
    tables, srcs, dsts = [hf], [L["fresh"][0]], [L["fresh"][1]]
    base = P * M
    for si, st in enumerate(L["stages"]):
        if st["kind"] == "fresh":
            continue
        key = (layer, si)
        if st["cd"] > 1 and epoch % st["cd"]:
            table = cache[key]
        elif st["kind"] == "exact":
            table = hf
        else:
            K = st["rows"]
            slot, row = st["send"]
            send = torch.zeros((P * K, f), dtype=h.dtype, device=h.device).index_add(
                0, slot, hf[row])
            noise = (lambda backward, shape, si=si: draws.quant_uniform(
                epoch, layer, si, backward, shape, h.device))
            table = S._exchange(L, st, send.reshape(P, K, f), noise).reshape(-1, f)
        if st["cd"] > 1:
            cache[key] = table.detach()
        tables.append(table)
        srcs.append(st["edges"][0] + base)
        dsts.append(st["edges"][1])
        base += table.shape[0]
    src, dst = torch.cat(srcs), torch.cat(dsts)

    whh = C.mm(torch.cat(tables), q["w"], control).reshape(base, heads, -1)
    e_src = (whh * q["a_src"]).sum(-1)
    e_dst = (whh[:P * M] * q["a_dst"]).sum(-1)
    e = F.leaky_relu(e_dst[dst] + e_src[src], 0.2)                   # [E, H]
    top = torch.full((P * M, heads), -torch.inf, device=h.device, dtype=e.dtype).scatter_reduce(
        0, dst[:, None].expand(-1, heads), e.detach(), "amax")
    ex = torch.exp(e - top[dst])
    den = torch.zeros((P * M, heads), device=h.device, dtype=ex.dtype).index_add(0, dst, ex)
    alpha = ex / den[dst]
    out = torch.zeros((P * M, *whh.shape[1:]), device=h.device, dtype=whh.dtype).index_add(
        0, dst, alpha[..., None] * whh[src])
    return out.reshape(P, M, -1) + q["b"]


def train(L: Dict, cfg: Dict, params0, draws, steps: int, control: bool = False,
          dtype=torch.float32) -> Dict:
    """Three steps (``steps``) of training from ``params0``; ``control``
    computes the dense products in TF32, ``dtype`` float64 gives a
    witness of what fp32 rounding alone moves."""
    m = cfg["model"]
    cache: Dict = {}
    x = L["x"].to(dtype)

    def step(p, epoch):
        sel = draws.lp_select(epoch, tuple(L["train"].shape), m["lp_rate"], L["x"].device)
        prop, loss_mask = L["train"] & sel, L["train"] & ~sel
        h = x + torch.where(prop[..., None], p["lp_embed"][L["labels"]], 0.0)
        for l, q in enumerate(p["layers"]):
            h = C.layer_norm(h, q["ln_scale"], q["ln_bias"])
            keep = draws.dropout_keep(epoch, l, tuple(h.shape), 1.0 - m["dropout"], h.device)
            h = attention_layer(L, q, C.dropout(h, keep, m["dropout"]), m["heads"], epoch, l,
                                draws, cache, control)
            if l < len(p["layers"]) - 1:
                h = F.relu(h)
        loss = C.masked_ce(h, L["labels"], loss_mask)
        # The workers' summed gradients: P times the global mean loss's.
        return loss.detach(), C.grads(L["P"] * loss, p)

    out = C.train(step, params0, cfg["optimizer"]["lr"], steps, dtype)
    out["checks"] = {"edges_off": L["edges_off"]}
    return out


def run(cfg: Dict, traffic: Dict, raw: Dict, params0, draws, seed: int, device,
        steps: int = 3, control: bool = False, placement: Dict = None) -> Dict:
    return train(prepare(cfg, traffic, raw, seed, device, placement), cfg, params0, draws,
                 steps, control)
