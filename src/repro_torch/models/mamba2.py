"""Mamba-2 (SSD) block — chunked parallel scan for training, O(1)-state decode.

The port of ``repro.models.mamba2``. Within a chunk the output is an
attention-like quadratic form with cumulative decay; across chunks a
small recurrent state [H, P, N] is carried (a plain loop over chunks
replaces ``lax.scan``). The decode state and conv state are fp32 whatever
the compute dtype, as in the reference: decode concatenates the fp32
conv state with the new (bf16) input, so its conv and SiLU run in fp32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as C

# Parameters the block reads in fp32 (never cast to the compute dtype).
FP32_PARAMS = ("A_log", "D", "dt_bias")


class MambaConfig(NamedTuple):
    d_inner: int        # expansion (usually 2 * d_model)
    head_dim: int       # P
    state_dim: int      # N (64 for zamba2)
    conv_width: int = 4
    chunk: int = 128

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_mamba(gen, d_model: int, cfg: MambaConfig, lead=(), device=None):
    """Block weights; ``lead`` prepends axes (a stacked layer axis)."""
    lead = tuple(lead)
    dev = gen.device if device is None else torch.device(device)
    h = cfg.num_heads
    d_in_proj = 2 * cfg.d_inner + 2 * cfg.state_dim + h
    return {
        "w_in": C.normal_init(gen, lead + (d_model, d_in_proj), device=dev),
        "conv_w": C.normal_init(gen, lead + (cfg.conv_width,
                                             cfg.d_inner + 2 * cfg.state_dim), device=dev),
        "A_log": torch.zeros(lead + (h,), device=dev),        # A = -exp(A_log)
        "D": torch.ones(lead + (h,), device=dev),
        "dt_bias": torch.zeros(lead + (h,), device=dev),
        "norm_scale": torch.ones(lead + (cfg.d_inner,), device=dev),
        "w_out": C.normal_init(gen, lead + (cfg.d_inner, d_model), device=dev),
    }


def _split_proj(p, x, cfg: MambaConfig):
    zxbcdt = x @ p["w_in"].to(x.dtype)
    return torch.split(zxbcdt, [cfg.d_inner, cfg.d_inner + 2 * cfg.state_dim,
                                cfg.num_heads], dim=-1)


def _causal_conv(xbc, conv_w, conv_state=None):
    """Depthwise causal conv along time, then SiLU. xbc [B, S, C]; conv_w
    [W, C]. An fp32 ``conv_state`` [B, W-1, C] promotes the conv to fp32."""
    w = conv_w.shape[0]
    if conv_state is None:
        pad = xbc.new_zeros(xbc.shape[:1] + (w - 1,) + xbc.shape[2:])
    else:
        pad = conv_state
    xp = torch.cat([pad, xbc], dim=1)                          # [B, S+W-1, C]
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s] * conv_w[i].to(xbc.dtype) for i in range(w))
    new_state = xp[:, -(w - 1):] if w > 1 else None
    return F.silu(out), new_state


def _ssd_chunked(xh, dt, A, B, Cc, cfg: MambaConfig):
    """SSD over the full sequence, chunk by chunk.

    xh [B, S, H, P]; dt [B, S, H] (softplus'd); A [H] (negative);
    B, Cc [B, S, N] (single group). Returns y [B, S, H, P].
    """
    b, s, h, p = xh.shape
    n = B.shape[-1]
    q = min(cfg.chunk, s)
    while s % q:  # shrink until it divides (shapes here are powers of two)
        q -= 1
    dtA = dt * A[None, None, :]                                # [B, S, H] (<= 0)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xh.device))
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xh.device)
    ys = []
    for c0 in range(0, s, q):
        xc, dtc, dtac, bc, cc = (t[:, c0:c0 + q] for t in (xh, dt, dtA, B, Cc))
        # Cumulative decay within chunk: L[t, s_] = exp(sum_{r=s_+1..t} dtA_r)
        cum = torch.cumsum(dtac, dim=1)                        # [B, Q, H]
        # Intra-chunk (attention-like with decay), strictly causal + diagonal.
        rel = cum[:, :, None, :] - cum[:, None, :, :]          # [B, T, S_, H]
        # Masked before the exp: above the diagonal ``rel`` is a positive sum
        # that overflows fp32 at long chunks, and where(mask, inf, 0) has a
        # NaN gradient. exp(-inf) = 0 gives the same forward.
        decay = torch.exp(torch.where(causal[None, :, :, None], rel, -torch.inf))
        scores = torch.einsum("btn,bsn->bts", cc, bc)          # [B, T, S_]
        m = scores[:, :, :, None] * decay                      # [B, T, S_, H]
        y_intra = torch.einsum("btsh,bsh,bshp->bthp", m, dtc, xc)
        # Contribution of the incoming state.
        y_state = torch.einsum("btn,bhpn,bth->bthp", cc, state, torch.exp(cum))
        # New state: decayed old + chunk contribution.
        chunk_decay = torch.exp(cum[:, -1, :])                 # [B, H]
        rem = torch.exp(cum[:, -1:, :] - cum)                  # [B, Q, H]
        state = state * chunk_decay[:, :, None, None] + torch.einsum(
            "bsh,bsh,bshp,bsn->bhpn", rem, dtc, xc, bc)
        ys.append(y_intra + y_state)
    return torch.cat(ys, dim=1)


def mamba_train(p, x, cfg: MambaConfig):
    """Full-sequence Mamba-2 mixing. x [B, S, D] -> [B, S, D]."""
    b, s, _ = x.shape
    h = cfg.num_heads
    z, xbc, dt = _split_proj(p, x, cfg)
    xbc, _ = _causal_conv(xbc, p["conv_w"])
    xh, B, Cc = torch.split(xbc, [cfg.d_inner, cfg.state_dim, cfg.state_dim], dim=-1)
    xh = xh.reshape(b, s, h, cfg.head_dim).float()
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y = _ssd_chunked(xh, dt, A, B.float(), Cc.float(), cfg)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(b, s, cfg.d_inner).to(x.dtype)
    y = C.rms_norm(y * F.silu(z), p["norm_scale"])             # gated norm
    return y @ p["w_out"].to(x.dtype)


class MambaCache(NamedTuple):
    state: torch.Tensor       # [B, H, P, N]
    conv_state: torch.Tensor  # [B, W-1, d_inner + 2N]


def init_mamba_cache(batch: int, cfg: MambaConfig, dtype=torch.float32,
                     device=None) -> MambaCache:
    return MambaCache(
        state=torch.zeros((batch, cfg.num_heads, cfg.head_dim, cfg.state_dim),
                          dtype=torch.float32, device=device),
        conv_state=torch.zeros((batch, cfg.conv_width - 1,
                                cfg.d_inner + 2 * cfg.state_dim), dtype=dtype, device=device),
    )


def mamba_decode(p, x, cache: MambaCache, cfg: MambaConfig):
    """One-token recurrent step: h' = exp(dt*A) h + dt * B xᵀ; y = C·h + D x.
    Returns the output and a new cache (fresh tensors)."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode processes one new token, got {s}")
    h = cfg.num_heads
    z, xbc, dt = _split_proj(p, x, cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], cache.conv_state)
    xh, B, Cc = torch.split(xbc, [cfg.d_inner, cfg.state_dim, cfg.state_dim], dim=-1)
    xh = xh.reshape(b, h, cfg.head_dim).float()                        # [B, H, P]
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])                   # [B, H]
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A[None, :])                                 # [B, H]
    Bv = B[:, 0].float()                                               # [B, N]
    Cv = Cc[:, 0].float()
    state = cache.state * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xh, Bv)
    y = torch.einsum("bn,bhpn->bhp", Cv, state) + xh * p["D"][None, :, None]
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
    y = C.rms_norm(y * F.silu(z), p["norm_scale"])
    return y @ p["w_out"].to(x.dtype), MambaCache(state=state, conv_state=conv_state)
