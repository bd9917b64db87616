"""Plain reference of distributed full-batch GraphSAGE training with the
paper's exchange (pre/post-aggregation halos, an optional two-level
hierarchy, stochastically rounded integer wires and delayed halos).

The P workers sit on a leading axis, as one device trains them. Every
aggregation is worked out here from the raw edges: each node's mean over
its in-edges and itself, with the weights 1/deg that this module counts.
From the program it takes, as data, only where rows sit (``placement``):
the node each stacked worker row holds (the session's ``owned`` table,
which places the random draws), and, for a stage whose wire quantizes,
which node or partial sum each wire row carries, in the wire's order,
since rows share a quantization group 4 at a time. Those plans are held
to the raw edges (``edges_off``: every node placed once, every in-edge
that crosses the stage carried exactly once); the weights on them are the
reference's own. The step is the paper's equations in plain PyTorch:
gathers and ``index_add`` for every aggregation, reshapes for the
collectives, the quantizer's formula ``floor((h - Z) * (1 / S) + u)`` per
4-row group.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from gnnbench.reference import common as C

ROW_GROUP = 4


def _stages(schedule: Dict, hierarchical: bool) -> List[Dict]:
    """The exchange stages the traffic file states, in the order of their
    random draws (intra then inter, or the flat one)."""
    if not hierarchical:
        return [{"level": "flat", "bits": schedule["bits"], "cd": schedule["cd"]}]
    return [{"level": "intra", "bits": schedule["intra_bits"], "cd": schedule["intra_cd"]},
            {"level": "inter", "bits": schedule["inter_bits"], "cd": schedule["inter_cd"]}]


def multiset_gap(a: np.ndarray, b: np.ndarray) -> int:
    """Entries by which two multisets of integers differ."""
    ka, ca = np.unique(a, return_counts=True)
    kb, cb = np.unique(b, return_counts=True)
    keys = np.union1d(ka, kb)
    na = np.zeros(len(keys), np.int64)
    nb = np.zeros(len(keys), np.int64)
    na[np.searchsorted(keys, ka)] = ca
    nb[np.searchsorted(keys, kb)] = cb
    return int(np.abs(na - nb).sum())


def _recv_slot(level: str, p: np.ndarray, i: np.ndarray, K: int, P: int, G: int,
               W: int) -> np.ndarray:
    """The sending slot of row ``i`` of worker ``p``'s receive buffer, as
    ``unit * K + k``: the unit is the sending worker, or on the grouped
    inter wire the sending group (its workers' buffers summed)."""
    if level == "flat":
        R = K // P
        return (i // R) * K + p * R + i % R
    if level == "intra":
        R = K // W
        return ((p // W) * W + i // R) * K + (p % W) * R + i % R
    r = K // G
    return (i // r) * K + (p // W) * r + i % r


def _wire(plan: Dict, level: str, owned: np.ndarray, inv: np.ndarray, edges: np.ndarray,
          n: int, G: int, W: int):
    """A quantized stage's send and receive maps with the reference's
    weights, and the edges its plan counts other than once.

    A slot either carries one node's row raw (its receivers weight it
    1/deg of theirs) or sums rows for the one node that receives it (each
    weighted 1/deg of that node, received with weight 1)."""
    P, M = owned.shape
    K = plan["gather"].shape[1]
    flat = owned.reshape(-1)
    rows = lambda a: np.broadcast_to(np.arange(P)[:, None], a.shape)
    unit = (lambda p: p // W) if level == "inter" else (lambda p: p)
    nslots = (G if level == "inter" else P) * K

    gm = plan["gather_mask"]
    raw_p = rows(gm)[gm]
    raw_row = raw_p * M + plan["gather"][gm]
    raw_slot = unit(raw_p) * K + np.nonzero(gm)[1]
    pm = plan["pre_mask"]
    pre_p = rows(pm)[pm]
    pre_row = pre_p * M + plan["pre_src"][pm]
    pre_pos = pre_p * K + plan["pre_slot"][pm]
    pre_slot = unit(pre_p) * K + plan["pre_slot"][pm]
    rm = plan["recv_mask"]
    recv_p = rows(rm)[rm]
    recv_i = plan["recv_row"][rm]
    recv_dst = recv_p * M + plan["recv_dst"][rm]
    recv_slot = _recv_slot(level, recv_p, recv_i, K, P, G, W)

    n_raw = np.bincount(raw_slot, minlength=nslots)
    n_pre = np.bincount(pre_slot, minlength=nslots)
    n_recv = np.bincount(recv_slot, minlength=nslots)
    u_of = np.full(nslots, -1, np.int64)
    u_of[raw_slot] = flat[raw_row]
    v_of = np.full(nslots, -1, np.int64)
    v_of[recv_slot] = flat[recv_dst]
    # Slots that mix raw rows, pre-aggregated slots read by other than one
    # node, and rows received from an empty slot.
    off = int(((n_raw > 1) | ((n_raw > 0) & (n_pre > 0))).sum()
              + ((n_pre > 0) & (n_recv != 1)).sum()
              + ((n_raw[recv_slot] == 0) & (n_pre[recv_slot] == 0)).sum())
    is_raw = n_raw[recv_slot] == 1
    pre_ok = n_recv[pre_slot] == 1
    carried = np.concatenate([u_of[recv_slot[is_raw]] * n + flat[recv_dst[is_raw]],
                              flat[pre_row[pre_ok]] * n + v_of[pre_slot[pre_ok]]])
    off += multiset_gap(carried, edges[0] * n + edges[1])

    pre_v = v_of[pre_slot]
    send = (np.concatenate([raw_p * K + np.nonzero(gm)[1], pre_pos]),
            np.concatenate([raw_row, pre_row]),
            np.concatenate([np.ones(len(raw_row), np.float32),
                            np.where(pre_v >= 0, inv[np.maximum(pre_v, 0)], 0.0)
                            .astype(np.float32)]))
    recv = (recv_p * K + recv_i, recv_dst,
            np.where(is_raw, inv[flat[recv_dst]], 1.0).astype(np.float32))
    return K, send, recv, off


def prepare(cfg: Dict, traffic: Dict, raw: Dict, seed: int, device, placement: Dict) -> Dict:
    """The stacked worker arrays on the device, and the aggregation maps
    from the raw edges placed by the program's ``placement``."""
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
    # The stage an edge crosses (-1: both ends on one worker).
    crossing = np.where(ws == wd, -1, 0 if not hier else np.where(ws // W == wd // W, 0, 1))

    t = lambda v, dt: torch.as_tensor(np.asarray(v), dtype=dt, device=device)
    coo = lambda sel: (t(pos[src[sel]], torch.int64), t(pos[dst[sel]], torch.int64),
                       t(inv[dst[sel]], torch.float32))
    fresh = crossing == -1
    stages = []
    for si, spec in enumerate(_stages(traffic["schedule"], hier)):
        sel = crossing == si
        if not spec["bits"]:
            if spec["cd"] == 1:
                fresh |= sel
                stages.append({**spec, "kind": "fresh"})
            else:
                stages.append({**spec, "kind": "exact", "edges": coo(sel)})
            continue
        plan = placement["stages"][si]
        if plan["level"] != spec["level"]:
            raise ValueError(f"stage {si} is {plan['level']!r} in the program, "
                             f"{spec['level']!r} in the traffic file")
        K, send, recv, wire_off = _wire(plan, spec["level"], owned, inv,
                                        np.stack([src[sel], dst[sel]]), n, G, W)
        off += wire_off
        stages.append({**spec, "kind": "wire", "rows": K,
                       "send": (t(send[0], torch.int64), t(send[1], torch.int64),
                                t(send[2], torch.float32)),
                       "recv": (t(recv[0], torch.int64), t(recv[1], torch.int64),
                                t(recv[2], torch.float32))})

    x = np.zeros((P, M, raw["x"].shape[1]), np.float32)
    x[real] = raw["x"][owned[real]]
    labels = np.zeros((P, M), np.int64)
    labels[real] = raw["labels"][owned[real]]
    train = np.zeros((P, M), bool)
    train[real] = raw["train_mask"][owned[real]]
    return {"P": P, "G": G, "W": W, "M": M, "stages": stages, "fresh": coo(fresh),
            "edges_off": off, "x": t(x, torch.float32), "labels": t(labels, torch.int64),
            "train": t(train, torch.bool)}


def _spmm(h: torch.Tensor, src, dst, w, rows: int) -> torch.Tensor:
    """out[d] = sum over entries of w * h[s], on flat row indices."""
    out = torch.zeros((rows, h.shape[-1]), dtype=h.dtype, device=h.device)
    return out.index_add(0, dst, w[:, None].to(h.dtype) * h[src])


def quant_dequant(x: torch.Tensor, u: torch.Tensor, bits: int) -> torch.Tensor:
    """Stochastic rounding to ``bits`` per 4-row group of each worker's
    rows, and back: q = clip(floor((x - Z) * (1 / S) + u), 0, 2^b - 1),
    x' = q * S + Z, with Z the group's minimum and S its range over
    2^b - 1 (a group of one value has S = 0 and reads back Z)."""
    P, rows, f = x.shape
    xg = x.reshape(P, rows // ROW_GROUP, ROW_GROUP * f)
    lo = xg.amin(-1, keepdim=True)
    hi = xg.amax(-1, keepdim=True)
    levels = (1 << bits) - 1
    scale = (hi - lo) / torch.full_like(lo, float(levels))
    inv = torch.where(scale > 0, torch.ones_like(scale) / torch.where(scale > 0, scale, 1.0),
                      torch.ones_like(scale))
    q = torch.clamp(torch.floor((xg - lo) * inv + u.reshape(xg.shape).to(x.dtype)), 0, levels)
    return (q * scale + lo).reshape(P, rows, f)


class _QuantizedA2A(torch.autograd.Function):
    """A quantized all_to_all: each sender's rows rounded, moved, read back.
    Its transpose moves the cotangent back the same way, rounded with the
    backward wire's own uniforms."""

    @staticmethod
    def forward(ctx, x, a2a, bits, noise):
        ctx.a2a, ctx.bits, ctx.noise = a2a, bits, noise
        return a2a(quant_dequant(x, noise(False, tuple(x.shape)), bits))

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        return ctx.a2a(quant_dequant(g, ctx.noise(True, tuple(g.shape)), ctx.bits)), None, None, None


def _exchange(L: Dict, st: Dict, send: torch.Tensor, noise) -> torch.Tensor:
    """One stage's collectives on [P, rows, F] send buffers: the receive
    buffers. ``flat``: an all_to_all over the P workers in P chunks.
    ``intra``: an all_to_all inside each group of W workers. ``inter``: the
    group's buffers summed over its W workers in rank order and split
    1/W a worker (psum_scatter), an all_to_all between the G groups (each
    worker with the same rank in the others), then every worker of a group
    gathers the W shards (all_gather)."""
    P, G, W = L["P"], L["G"], L["W"]
    f = send.shape[-1]
    if st["level"] == "flat":
        r = st["rows"] // P
        a2a = lambda v: v.reshape(P, P, r, f).transpose(0, 1).reshape(P, P * r, f)
    elif st["level"] == "intra":
        r = st["rows"] // W
        a2a = lambda v: v.reshape(G, W, W, r, f).transpose(1, 2).reshape(P, W * r, f)
    else:
        r = st["rows"] // G
        s = r // W
        y = send.reshape(G, W, G, r, f)
        acc = y[:, 0]
        for k in range(1, W):
            acc = acc + y[:, k]
        send = acc.reshape(G, G, W, s, f).transpose(1, 2).reshape(P, G * s, f)
        a2a = lambda v: v.reshape(G, W, G, s, f).transpose(0, 2).reshape(P, G * s, f)
    if st["bits"]:
        wire = _QuantizedA2A.apply(send, a2a, st["bits"], noise)
    else:
        wire = a2a(send)
    if st["level"] != "inter":
        return wire
    full = wire.reshape(G, W, G, s, f).transpose(1, 2)
    return full.unsqueeze(1).expand(G, W, G, W, s, f).reshape(P, G * W * s, f)


def _aggregate(L: Dict, h: torch.Tensor, epoch: int, layer: int, draws, cache: Dict):
    """Each node's mean over its in-edges and itself. Edges on one worker,
    and those of fp32 stages synchronised every epoch, are summed exactly
    from this epoch's rows; a delayed stage (``cd`` > 1) sends on refresh
    epochs (``epoch % cd == 0``) and keeps what it received, which the
    other epochs serve, detached; a quantized stage sends its plan's rows
    over the rounded wire."""
    P, M = L["P"], L["M"]
    f = h.shape[-1]
    hf = h.reshape(P * M, f)
    acc = _spmm(hf, *L["fresh"], P * M)
    for si, st in enumerate(L["stages"]):
        if st["kind"] == "fresh":
            continue
        key = (layer, si)
        if st["cd"] > 1 and epoch % st["cd"]:
            part = cache[key]
        elif st["kind"] == "exact":
            part = _spmm(hf, *st["edges"], P * M)
        else:
            K = st["rows"]
            pos, row, w = st["send"]
            send = torch.zeros((P * K, f), dtype=h.dtype, device=h.device).index_add(
                0, pos, w[:, None].to(h.dtype) * hf[row])
            noise = (lambda backward, shape, si=si: draws.quant_uniform(
                epoch, layer, si, backward, shape, h.device))
            part = _exchange(L, st, send.reshape(P, K, f), noise)
        if st["cd"] > 1:
            cache[key] = part.detach()
        if st["kind"] == "wire":
            src, dst, w = st["recv"]
            acc = acc.index_add(0, dst, w[:, None].to(h.dtype) * part.reshape(-1, f)[src])
        else:
            acc = acc + part
    return acc.reshape(P, M, f)


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
            h = C.dropout(h, keep, m["dropout"])
            z = _aggregate(L, h, epoch, l, draws, cache)
            h = C.mm(h, q["w_self"], control) + C.mm(z, q["w_neigh"], control) + q["b"]
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
