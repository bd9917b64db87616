"""Shared transformer building blocks (bf16 compute, fp32 params).

The port of ``repro.models.common``: the same functions with the same
cast order, so a bf16 run rounds where the reference rounds.
``COMPUTE_DTYPE`` is read at call time, as the reference reads
``C.COMPUTE_DTYPE``; setting it to ``torch.float32`` runs every model in
fp32 (the tests do so to hold the port to the reference at 1e-5).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16


def normal_init(gen: Optional[torch.Generator], shape, scale: float = 0.02,
                device=None) -> torch.Tensor:
    """fp32 draws of N(0, scale²) from ``gen`` on ``device`` (default: the
    generator's). ``device="meta"`` allocates nothing (``gen`` may be None)."""
    dev = gen.device if device is None else torch.device(device)
    return torch.randn(tuple(shape), generator=gen, device=dev).mul_(scale)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale.to(x.dtype) + bias.to(x.dtype)


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: [B, S, H, hd]; positions: [B, S] (absolute)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [hd/2]
    return _rotate(x, positions[..., None].float() * freqs)  # ang [B, S, hd/2]


def apply_mrope(
    x: torch.Tensor,
    positions_3d: torch.Tensor,   # [3, B, S] (temporal, height, width)
    sections: Sequence[int],      # half-dim split, e.g. (16, 24, 24)
    theta: float = 10000.0,
) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE: the half-dim frequency bands are split into
    (t, h, w) sections, each rotated by its own position stream. For pure
    text the three streams coincide and M-RoPE reduces to RoPE."""
    hd = x.shape[-1]
    if sum(sections) != hd // 2:
        raise ValueError(f"mrope sections {tuple(sections)} do not sum to {hd // 2}")
    freqs = rope_freqs(hd, theta, x.device)                  # [half]
    ang_parts = []
    off = 0
    for i, sec in enumerate(sections):
        ang_parts.append(positions_3d[i][..., None].float() * freqs[off:off + sec])
        off += sec
    return _rotate(x, torch.cat(ang_parts, dim=-1))          # ang [B, S, half]


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate.to(x.dtype)) * (x @ w_up.to(x.dtype))
    return h @ w_down.to(x.dtype)


def init_swiglu(gen, d_model: int, d_ff: int, lead=(), device=None):
    """SwiGLU weights; ``lead`` prepends axes (a stacked layer axis)."""
    lead = tuple(lead)
    return {
        "w_gate": normal_init(gen, lead + (d_model, d_ff), device=device),
        "w_up": normal_init(gen, lead + (d_model, d_ff), device=device),
        "w_down": normal_init(gen, lead + (d_ff, d_model), device=device),
    }


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    # jax.nn.gelu defaults to the tanh approximation.
    h = F.gelu(x @ w_in.to(x.dtype) + b_in.to(x.dtype), approximate="tanh")
    return h @ w_out.to(x.dtype) + b_out.to(x.dtype)


def init_gelu_mlp(gen, d_model: int, d_ff: int, lead=(), device=None):
    lead = tuple(lead)
    dev = gen.device if device is None else device
    return {
        "w_in": normal_init(gen, lead + (d_model, d_ff), device=device),
        "b_in": torch.zeros(lead + (d_ff,), device=dev),
        "w_out": normal_init(gen, lead + (d_ff, d_model), device=device),
        "b_out": torch.zeros(lead + (d_model,), device=dev),
    }


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid tokens. logits [..., V] (any float dtype), labels int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
