"""Mixture-of-Experts FFN: token-choice top-k routing with capacity.

The port of ``repro.models.moe``. Dispatch and combine use a static
per-expert capacity (over-capacity tokens drop to the shared/residual
path); experts run as one grouped product per projection (``torch.bmm``
over the expert axis). Supports DeepSeek-style shared experts
(always-on dense SwiGLU) and the switch-style load-balance auxiliary loss.

Two choices keep the reference's results, bit for bit where the
arithmetic allows:

- The top-k is a stable descending sort: ``lax.top_k`` puts the lower
  expert first when probabilities tie (router logits are bf16, so they
  do), and ``torch.topk`` does not promise that order.
- The dispatch is an indexed assignment, not an add: every kept
  (token, k) has a slot of its own, and only zeros go to the overflow
  row, so no atomics are needed and the card repeats bitwise.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as C


class MoEConfig(NamedTuple):
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0           # shared (always-active) experts
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01


def init_moe(gen, d_model: int, cfg: MoEConfig, lead=(), device=None):
    lead = tuple(lead)
    e, f = cfg.num_experts, cfg.d_ff_expert
    p = {
        "router": C.normal_init(gen, lead + (d_model, e), scale=0.006, device=device),
        "w_gate": C.normal_init(gen, lead + (e, d_model, f), device=device),
        "w_up": C.normal_init(gen, lead + (e, d_model, f), device=device),
        "w_down": C.normal_init(gen, lead + (e, f, d_model), device=device),
    }
    if cfg.num_shared:
        p["shared"] = C.init_swiglu(gen, d_model, cfg.num_shared * f, lead, device)
    return p


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    cap = int(tokens * cfg.top_k / cfg.num_experts * cfg.capacity_factor)
    return max(8, -(-cap // 8) * 8)  # round up to 8 (sublane alignment)


def route(p, xt: torch.Tensor, cfg: MoEConfig) -> Tuple[torch.Tensor, ...]:
    """Router of tokens ``xt`` [T, D]: (fp32 probs [T, E], renormalized gates
    [T, K], selected experts [T, K]), experts in ``lax.top_k``'s order."""
    logits = (xt @ p["router"].to(xt.dtype)).float()                 # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gate, sel = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, sel = gate[:, :cfg.top_k], sel[:, :cfg.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)  # renormalize
    return probs, gate, sel


def moe_ffn(p, x: torch.Tensor, cfg: MoEConfig):
    """x: [B, S, D] -> (out [B, S, D], aux_loss scalar)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e, k = cfg.num_experts, cfg.top_k
    cap = _capacity(t, cfg)
    probs, gate, sel = route(p, xt, cfg)

    # Position of each (token, k) within its expert's capacity buffer.
    experts = torch.arange(e, device=x.device)
    counts = torch.zeros((e,), dtype=torch.int64, device=x.device)
    pos_list = []
    for kk in range(k):  # K is small and static
        ek = sel[:, kk]
        oh = (ek[:, None] == experts[None, :]).long()                # [T, E]
        pos_in = torch.cumsum(oh, dim=0) - 1 + counts[None, :]
        pos_list.append(torch.gather(pos_in, 1, ek[:, None])[:, 0])
        counts = counts + oh.sum(dim=0)
    pos = torch.stack(pos_list, dim=1)                                # [T, K]
    valid = pos < cap

    # Dispatch: each kept (token, k) to its own row of [E*cap (+1 overflow), D].
    flat_dst = torch.where(valid, sel * cap + pos, e * cap).reshape(-1)
    src = xt[:, None, :].expand(t, k, d).reshape(t * k, d)
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=x.device)
    buf.index_put_((flat_dst,), torch.where(valid.reshape(-1, 1), src, 0))
    ex_in = buf[: e * cap].reshape(e, cap, d)

    # Grouped expert SwiGLU (one batched product per projection).
    h = F.silu(torch.bmm(ex_in, p["w_gate"].to(xt.dtype)))
    h = h * torch.bmm(ex_in, p["w_up"].to(xt.dtype))
    ex_out = torch.bmm(h, p["w_down"].to(xt.dtype))

    # Combine: gather expert outputs back and mix with renormalized gates.
    flat = torch.cat([ex_out.reshape(e * cap, d),
                      torch.zeros((1, d), dtype=xt.dtype, device=x.device)], dim=0)
    got = flat[flat_dst].reshape(t, k, d)
    out = torch.einsum("tk,tkd->td", gate.to(xt.dtype), got)

    if cfg.num_shared:
        sh = p["shared"]
        out = out + C.swiglu(xt, sh["w_gate"], sh["w_up"], sh["w_down"])

    # Switch-style load-balance loss: E * sum_e f_e * P_e.
    hits = ((sel[..., None] == experts) & valid[..., None]).sum((0, 1))
    f_e = hits.float() / max(t * k, 1)
    p_e = probs.mean(dim=0)
    aux = cfg.aux_loss_coef * e * (f_e * p_e).sum()
    return out.reshape(b, s, d), aux
