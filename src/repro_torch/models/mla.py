"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

The port of ``repro.models.mla``. K/V are compressed into a shared latent
``c_kv`` (rank ``kv_lora``) plus a decoupled RoPE key; the KV cache
stores only ``[c_kv | k_pe]`` per token. Decode uses the *absorbed*
formulation (queries projected into latent space, attention output
up-projected once), so the cache is never re-expanded.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import common as C
from repro_torch.models.attention import inv_sqrt_f32, sdpa_chunked


class MLAConfig(NamedTuple):
    num_heads: int
    head_dim: int          # nope (content) head dim
    rope_dim: int          # decoupled rope dim (shared across heads)
    kv_lora: int           # latent rank (512 for v2-lite)
    v_head_dim: int
    rope_theta: float = 10000.0


def init_mla(gen, d_model: int, cfg: MLAConfig, lead=(), device=None):
    lead = tuple(lead)
    h = cfg.num_heads

    def w(*shape):
        return C.normal_init(gen, lead + shape, device=device)

    return {
        "w_q": w(d_model, h * (cfg.head_dim + cfg.rope_dim)),
        "w_dkv": w(d_model, cfg.kv_lora),      # down-proj
        "w_kpe": w(d_model, cfg.rope_dim),     # decoupled key
        "w_uk": w(cfg.kv_lora, h * cfg.head_dim),
        "w_uv": w(cfg.kv_lora, h * cfg.v_head_dim),
        "w_o": w(h * cfg.v_head_dim, d_model),
    }


def _split_q(p, x, cfg: MLAConfig):
    b, s, _ = x.shape
    q = (x @ p["w_q"].to(x.dtype)).reshape(b, s, cfg.num_heads,
                                           cfg.head_dim + cfg.rope_dim)
    return q[..., :cfg.head_dim], q[..., cfg.head_dim:]


def mla_train(p, x, positions, cfg: MLAConfig, q_chunk: int = 512):
    """Training path: expand latent to per-head K/V, chunked causal SDPA."""
    b, s, _ = x.shape
    q_nope, q_pe = _split_q(p, x, cfg)
    c_kv = x @ p["w_dkv"].to(x.dtype)                        # [B, S, L]
    k_pe = (x @ p["w_kpe"].to(x.dtype))[:, :, None, :]       # [B, S, 1, r]
    q_pe = C.apply_rope(q_pe, positions, cfg.rope_theta)
    k_pe = C.apply_rope(k_pe, positions, cfg.rope_theta)
    k_nope = (c_kv @ p["w_uk"].to(x.dtype)).reshape(b, s, cfg.num_heads, cfg.head_dim)
    v = (c_kv @ p["w_uv"].to(x.dtype)).reshape(b, s, cfg.num_heads, cfg.v_head_dim)
    # Concatenate content + rope parts; the rope key is shared across heads.
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(b, s, cfg.num_heads, cfg.rope_dim)], dim=-1)
    out = sdpa_chunked(q, k, v, causal=True, q_chunk=q_chunk)
    return out.reshape(b, s, -1) @ p["w_o"].to(x.dtype)


class MLACache(NamedTuple):
    c_kv: torch.Tensor   # [B, S, kv_lora]
    k_pe: torch.Tensor   # [B, S, rope_dim]
    pos: torch.Tensor


def init_mla_cache(batch: int, cache_len: int, cfg: MLAConfig, dtype=None,
                   device=None) -> MLACache:
    dtype = C.COMPUTE_DTYPE if dtype is None else dtype
    return MLACache(
        c_kv=torch.zeros((batch, cache_len, cfg.kv_lora), dtype=dtype, device=device),
        k_pe=torch.zeros((batch, cache_len, cfg.rope_dim), dtype=dtype, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def mla_decode(p, x, cache: MLACache, cfg: MLAConfig):
    """Absorbed decode: attend in the latent space (cache never expanded).
    The new latent and rope key are written into the cache in place."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode processes one new token, got {s}")
    h = cfg.num_heads
    q_nope, q_pe = _split_q(p, x, cfg)                      # [B,1,H,hd],[B,1,H,r]
    pos = cache.pos
    posb = pos.reshape(1, 1).expand(b, 1)
    q_pe = C.apply_rope(q_pe, posb, cfg.rope_theta)
    c_new = x @ p["w_dkv"].to(x.dtype)                      # [B, 1, L]
    k_pe_new = C.apply_rope((x @ p["w_kpe"].to(x.dtype))[:, :, None, :],
                            posb, cfg.rope_theta)[:, :, 0, :]
    cache_len = cache.c_kv.shape[1]
    slot = (pos % cache_len).reshape(1).long()
    cache.c_kv.index_copy_(1, slot, c_new.to(cache.c_kv.dtype))
    cache.k_pe.index_copy_(1, slot, k_pe_new.to(cache.k_pe.dtype))
    c_kv, k_pe = cache.c_kv.float(), cache.k_pe.float()
    # Absorb W_uk into the query: q_lat[h] = W_uk[h]^T q_nope[h]  in R^L.
    w_uk = p["w_uk"].to(x.dtype).reshape(cfg.kv_lora, h, cfg.head_dim)
    q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, w_uk)    # [B,1,H,L]
    scale = inv_sqrt_f32(cfg.head_dim + cfg.rope_dim)
    s_lat = torch.einsum("bqhl,bsl->bhqs", q_lat.float(), c_kv)
    s_pe = torch.einsum("bqhr,bsr->bhqs", q_pe.float(), k_pe)
    scores = (s_lat + s_pe) * scale
    valid = torch.arange(cache_len, device=x.device) < torch.clamp(pos + 1, max=cache_len)
    scores = torch.where(valid, scores, -1e30)
    a = torch.softmax(scores, dim=-1)
    # Attend in latent space, then up-project through W_uv once.
    ctx = torch.einsum("bhqs,bsl->bqhl", a, c_kv)           # [B,1,H,L]
    w_uv = p["w_uv"].to(x.dtype).reshape(cfg.kv_lora, h, cfg.v_head_dim)
    out = torch.einsum("bqhl,lhd->bqhd", ctx.to(x.dtype), w_uv)
    out = out.reshape(b, 1, -1) @ p["w_o"].to(x.dtype)
    return out, MLACache(c_kv=cache.c_kv, k_pe=cache.k_pe, pos=pos + 1)
