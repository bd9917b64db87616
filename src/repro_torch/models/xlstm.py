"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallel train
form) and sLSTM (scalar memory, true recurrence).

The port of ``repro.models.xlstm``.

* mLSTM trains with the chunk-parallel attention-like formulation
  (exponential-gate decay matrix D, stabilized), mathematically equivalent
  to the recurrent form used for decode — O(1) state per token.
* sLSTM has a recurrent connection R (block-diagonal per head), so it is
  inherently sequential: a plain loop over time steps (the reference's
  two-level ``lax.scan`` under ``jax.checkpoint`` computes the same
  forward values and only bounds the training memory).

The decode states and conv states are fp32 whatever the compute dtype,
as in the reference, so decode's conv runs in fp32 and its products with
the (compute-dtype) weights are fp32 too: JAX promotes ``f32 @ bf16`` to
fp32, which ``_proj`` does by widening the rounded weight.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models.attention import inv_sqrt_f32
from repro_torch.models.mamba2 import _causal_conv

# The reference's ``_conv_silu`` is a copy of Mamba-2's causal conv + SiLU.
_conv_silu = _causal_conv

# Parameters the blocks read in fp32 (never cast to the compute dtype).
FP32_PARAMS = ("r_gates",)


class XLSTMConfig(NamedTuple):
    d_model: int
    num_heads: int
    conv_width: int = 4
    q_chunk: int = 256
    slstm_chunk: int = 64

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


def _proj(a, w, dtype):
    """``a @ w.astype(dtype)`` with JAX's promotion: an fp32 ``a`` (decode's
    conv output) takes the weight rounded to ``dtype``, widened to fp32."""
    return a @ w.to(dtype).to(torch.promote_types(a.dtype, dtype))


def _gelu(x):
    return F.gelu(x, approximate="tanh")       # jax.nn.gelu's default


# ----------------------------------------------------------------- mLSTM --


def init_mlstm_block(gen, cfg: XLSTMConfig, lead=(), device=None):
    lead = tuple(lead)
    dev = gen.device if device is None else torch.device(device)
    d = cfg.d_model
    dm = 2 * d  # up-projection factor 2
    h = cfg.num_heads

    def w(*shape):
        return C.normal_init(gen, lead + shape, device=dev)

    return {
        "ln_scale": torch.ones(lead + (d,), device=dev),
        "w_up": w(d, 2 * dm),                     # [u | gate]
        "conv_w": w(cfg.conv_width, dm),
        "w_q": w(dm, dm),
        "w_k": w(dm, dm),
        "w_v": w(dm, dm),
        "w_if": w(dm, 2 * h),                     # i/f gate pre-acts
        "gn_scale": torch.ones(lead + (dm,), device=dev),
        "w_down": w(dm, d),
    }


def _mlstm_parallel(q, k, v, ilog, flog, q_chunk: int):
    """Stabilized parallel mLSTM. q,k,v [B,S,H,P]; ilog,flog [B,S,H]."""
    b, s, h, p = q.shape
    scale = inv_sqrt_f32(p)
    Fc = torch.cumsum(flog, dim=1)                     # [B, S, H]
    # D_ts = exp(F_t - F_s + i_s - m_t), s <= t
    src = ilog - Fc                                    # [B, S, H] (log i_s - F_s)
    kf, vf = k.float(), v.float()
    spos = torch.arange(s, device=q.device)

    def block(qc, tpos):
        logd = Fc[:, tpos][:, :, None, :] + src[:, None, :, :]   # [B, C, S, H]
        causal = tpos[:, None] >= spos[None, :]
        logd = torch.where(causal[None, :, :, None], logd, -torch.inf)
        m = torch.clamp(logd.amax(dim=2, keepdim=True), min=-30.0)   # [B, C, 1, H]
        d_mat = torch.exp(logd - m)
        scores = torch.einsum("bchp,bshp->bcsh", qc.float(), kf) * scale
        cmat = scores * d_mat
        denom = torch.maximum(cmat.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :]))
        out = torch.einsum("bcsh,bshp->bchp", cmat, vf)
        return (out / denom[..., None]).to(q.dtype)

    if s <= q_chunk:
        return block(q, spos)
    if s % q_chunk:
        raise ValueError(f"sequence {s} is not a multiple of q_chunk {q_chunk}")
    ar = torch.arange(q_chunk, device=q.device)
    return torch.cat([block(q[:, c:c + q_chunk], c + ar) for c in range(0, s, q_chunk)],
                     dim=1)


def mlstm_block_train(p, x, cfg: XLSTMConfig):
    b, s, d = x.shape
    h = cfg.num_heads
    res = x
    xn = C.rms_norm(x, p["ln_scale"])
    up = xn @ p["w_up"].to(x.dtype)
    u, gate = up.chunk(2, dim=-1)                      # [B, S, 2d] each
    cu, _ = _conv_silu(u, p["conv_w"])
    q = (cu @ p["w_q"].to(x.dtype)).reshape(b, s, h, -1)
    k = (cu @ p["w_k"].to(x.dtype)).reshape(b, s, h, -1)
    v = (u @ p["w_v"].to(x.dtype)).reshape(b, s, h, -1)
    if_pre = (cu @ p["w_if"].to(x.dtype)).float()
    ilog, fpre = if_pre[..., :h], if_pre[..., h:]
    flog = F.logsigmoid(fpre)
    y = _mlstm_parallel(q, k, v, ilog, flog, cfg.q_chunk)
    y = y.reshape(b, s, -1)
    y = C.rms_norm(y, p["gn_scale"]) * F.silu(gate)
    return res + y @ p["w_down"].to(x.dtype)


class MLSTMCache(NamedTuple):
    Cm: torch.Tensor   # [B, H, P, P] matrix memory
    n: torch.Tensor    # [B, H, P]
    m: torch.Tensor    # [B, H]
    conv: torch.Tensor


def init_mlstm_cache(batch: int, cfg: XLSTMConfig, dtype=torch.float32,
                     device=None) -> MLSTMCache:
    h, pdim = cfg.num_heads, cfg.head_dim * 2
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(
        Cm=torch.zeros((batch, h, pdim, pdim), **f32),
        n=torch.zeros((batch, h, pdim), **f32),
        m=torch.full((batch, h), -30.0, **f32),
        conv=torch.zeros((batch, cfg.conv_width - 1, 2 * cfg.d_model), dtype=dtype,
                         device=device),
    )


def mlstm_block_decode(p, x, cache: MLSTMCache, cfg: XLSTMConfig):
    b, s, d = x.shape
    if s != 1:
        raise ValueError(f"decode processes one new token, got {s}")
    h = cfg.num_heads
    res = x
    xn = C.rms_norm(x, p["ln_scale"])
    up = xn @ p["w_up"].to(x.dtype)
    u, gate = up.chunk(2, dim=-1)
    cu, conv = _conv_silu(u, p["conv_w"], cache.conv)
    q = _proj(cu, p["w_q"], x.dtype).reshape(b, h, -1).float()
    k = _proj(cu, p["w_k"], x.dtype).reshape(b, h, -1).float()
    v = (u @ p["w_v"].to(x.dtype)).reshape(b, h, -1).float()
    if_pre = _proj(cu, p["w_if"], x.dtype).float()[:, 0]
    ilog, fpre = if_pre[:, :h], if_pre[:, h:]
    flog = F.logsigmoid(fpre)
    qs = q * inv_sqrt_f32(q.shape[-1])
    m_new = torch.maximum(flog + cache.m, ilog)
    fdec = torch.exp(flog + cache.m - m_new)
    iexp = torch.exp(ilog - m_new)
    Cm = cache.Cm * fdec[..., None, None] + iexp[..., None, None] * (
        v[:, :, :, None] * k[:, :, None, :])
    n = cache.n * fdec[..., None] + iexp[..., None] * k
    num = torch.einsum("bhvp,bhp->bhv", Cm, qs)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", n, qs).abs(), torch.exp(-m_new))
    y = (num / den[..., None]).reshape(b, 1, -1).to(x.dtype)
    y = C.rms_norm(y, p["gn_scale"]) * F.silu(gate)
    out = res + y @ p["w_down"].to(x.dtype)
    return out, MLSTMCache(Cm=Cm, n=n, m=m_new, conv=conv)


# ----------------------------------------------------------------- sLSTM --


def init_slstm_block(gen, cfg: XLSTMConfig, lead=(), device=None):
    lead = tuple(lead)
    dev = gen.device if device is None else torch.device(device)
    d = cfg.d_model
    h = cfg.num_heads
    ph = d // h

    def w(*shape, scale=0.02):
        return C.normal_init(gen, lead + shape, scale, device=dev)

    return {
        "ln_scale": torch.ones(lead + (d,), device=dev),
        "conv_w": w(cfg.conv_width, d),
        "w_gates": w(d, 4 * d),                   # z i f o pre-acts
        "r_gates": w(h, ph, 4 * ph, scale=0.01),
        "gn_scale": torch.ones(lead + (d,), device=dev),
        # gated MLP, projection factor 4/3
        "w_mlp_up": w(d, 2 * (4 * d // 3)),
        "w_mlp_down": w(4 * d // 3, d),
    }


class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, D]
    n: torch.Tensor
    hs: torch.Tensor
    m: torch.Tensor


def init_slstm_state(batch: int, d: int, device=None) -> SLSTMState:
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMState(c=torch.zeros((batch, d), **f32), n=torch.zeros((batch, d), **f32),
                      hs=torch.zeros((batch, d), **f32),
                      m=torch.full((batch, d), -30.0, **f32))


def _slstm_step(p, cfg: XLSTMConfig, state: SLSTMState, gx):
    """gx: [B, 4D] input gate pre-activations for one step."""
    b = gx.shape[0]
    h, ph, d = cfg.num_heads, cfg.head_dim, cfg.d_model
    hr = state.hs.reshape(b, h, ph)
    rec = torch.einsum("bhp,hpq->bhq", hr, p["r_gates"]).reshape(b, 4 * d)
    zi, ii, fi, oi = (gx.float() + rec).chunk(4, dim=-1)
    flog = F.logsigmoid(fi)
    m_new = torch.maximum(flog + state.m, ii)
    f = torch.exp(flog + state.m - m_new)
    i = torch.exp(ii - m_new)
    c = f * state.c + i * torch.tanh(zi)
    n = f * state.n + i
    hs = torch.sigmoid(oi) * c / torch.clamp(n, min=1e-6)
    return SLSTMState(c=c, n=n, hs=hs, m=m_new)


def slstm_scan(p, cfg: XLSTMConfig, gx_seq, state: SLSTMState):
    """gx_seq [B, S, 4D] -> (hs_seq [B, S, D], final state), one step at a time."""
    hs = []
    for t in range(gx_seq.shape[1]):
        state = _slstm_step(p, cfg, state, gx_seq[:, t])
        hs.append(state.hs)
    return torch.stack(hs, dim=1), state


def _slstm_mlp(p, hs, dtype):
    hs = C.rms_norm(hs.to(dtype), p["gn_scale"])
    a, g = (hs @ p["w_mlp_up"].to(dtype)).chunk(2, dim=-1)
    return (_gelu(a) * g) @ p["w_mlp_down"].to(dtype)


def slstm_block_train(p, x, cfg: XLSTMConfig):
    xn = C.rms_norm(x, p["ln_scale"])
    cu, _ = _conv_silu(xn, p["conv_w"])
    gx = cu @ p["w_gates"].to(x.dtype)
    hs, _ = slstm_scan(p, cfg, gx, init_slstm_state(x.shape[0], cfg.d_model, x.device))
    return x + _slstm_mlp(p, hs, x.dtype)


class SLSTMCache(NamedTuple):
    state: SLSTMState
    conv: torch.Tensor


def init_slstm_cache(batch: int, cfg: XLSTMConfig, dtype=torch.float32,
                     device=None) -> SLSTMCache:
    return SLSTMCache(
        state=init_slstm_state(batch, cfg.d_model, device),
        conv=torch.zeros((batch, cfg.conv_width - 1, cfg.d_model), dtype=dtype,
                         device=device),
    )


def slstm_block_decode(p, x, cache: SLSTMCache, cfg: XLSTMConfig):
    xn = C.rms_norm(x, p["ln_scale"])
    cu, conv = _conv_silu(xn, p["conv_w"], cache.conv)
    gx = _proj(cu, p["w_gates"], x.dtype)[:, 0]
    st = _slstm_step(p, cfg, cache.state, gx)
    return x + _slstm_mlp(p, st.hs[:, None, :], x.dtype), SLSTMCache(state=st, conv=conv)
