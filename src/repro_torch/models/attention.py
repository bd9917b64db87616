"""GQA attention: train (chunked causal), prefill, and single-token decode.

The port of ``repro.models.attention``. Scores and softmax are fp32 and
masked with -1e30, as in the reference; queries are taken in chunks of
``q_chunk`` so the [Sq, Sk] score matrix never fully materializes.
Supports optional QKV bias (qwen2.5), sliding-window masks and M-RoPE.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.models import common as C


class AttnConfig(NamedTuple):
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None       # sliding window (tokens), None = full
    mrope_sections: Optional[Tuple[int, ...]] = None


def init_attention(gen, d_model: int, cfg: AttnConfig, lead=(), device=None):
    lead = tuple(lead)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "w_q": C.normal_init(gen, lead + (d_model, h * hd), device=device),
        "w_k": C.normal_init(gen, lead + (d_model, kv * hd), device=device),
        "w_v": C.normal_init(gen, lead + (d_model, kv * hd), device=device),
        "w_o": C.normal_init(gen, lead + (h * hd, d_model), device=device),
    }
    if cfg.qkv_bias:
        dev = p["w_q"].device
        p["b_q"] = torch.zeros(lead + (h * hd,), device=dev)
        p["b_k"] = torch.zeros(lead + (kv * hd,), device=dev)
        p["b_v"] = torch.zeros(lead + (kv * hd,), device=dev)
    return p


def _project_qkv(p, x, cfg: AttnConfig):
    b, s, _ = x.shape
    q = x @ p["w_q"].to(x.dtype)
    k = x @ p["w_k"].to(x.dtype)
    v = x @ p["w_v"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["b_q"].to(x.dtype)
        k = k + p["b_k"].to(x.dtype)
        v = v + p["b_v"].to(x.dtype)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _rope(q, k, positions, cfg: AttnConfig):
    if cfg.mrope_sections is not None:
        if positions.dim() == 2:  # text-only: t = h = w = pos
            positions = positions[None].expand((3,) + tuple(positions.shape))
        q = C.apply_mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = C.apply_mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = C.apply_rope(q, positions, cfg.rope_theta)
        k = C.apply_rope(k, positions, cfg.rope_theta)
    return q, k


def inv_sqrt_f32(n: int) -> float:
    """1 / sqrt(n) rounded as the reference's fp32 ``1.0 / jnp.sqrt(n)``."""
    return float(1.0 / torch.tensor(float(n), dtype=torch.float32).sqrt())


def sdpa_chunked(
    q: torch.Tensor,           # [B, Sq, H, hd]
    k: torch.Tensor,           # [B, Sk, KV, hd]
    v: torch.Tensor,           # [B, Sk, KV, hd_v]
    *,
    causal: bool,
    q_offset: Union[int, torch.Tensor] = 0,  # absolute position of q[0] vs k[0]
    window: Optional[int] = None,
    kv_valid_len: Optional[torch.Tensor] = None,  # mask the cache tail in decode
    q_chunk: int = 512,
) -> torch.Tensor:
    """Scaled dot-product attention over query chunks, fp32 scores."""
    b, sq, h, hd = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = inv_sqrt_f32(hd)
    kx = k.repeat_interleave(rep, dim=2).float()   # [B, Sk, H, hd]
    vx = v.repeat_interleave(rep, dim=2).float()
    kpos = torch.arange(sk, device=q.device)

    def block(qc, qpos):
        # qc: [B, C, H, hd]; qpos: [C] absolute positions (relative to k[0]).
        s = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kx) * scale
        mask = torch.ones((qc.shape[1], sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        if kv_valid_len is not None:
            mask &= kpos[None, :] < kv_valid_len
        s = torch.where(mask[None, None], s, -1e30)
        a = torch.softmax(s, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", a, vx).to(q.dtype)

    ar = torch.arange(min(sq, q_chunk), device=q.device)
    if sq <= q_chunk:
        return block(q, q_offset + ar)

    pad = (-sq) % q_chunk
    if pad:  # e.g. whisper's 1500 encoder frames: pad, compute, slice back
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    outs = [block(q[:, i:i + q_chunk], q_offset + i + ar)
            for i in range(0, sq + pad, q_chunk)]
    out = torch.cat(outs, dim=1)
    return out[:, :sq] if pad else out


def attention_train(p, x, positions, cfg: AttnConfig, q_chunk: int = 512):
    """Full causal self-attention over a training sequence."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope(q, k, positions, cfg)
    out = sdpa_chunked(q, k, v, causal=True, window=cfg.window, q_chunk=q_chunk)
    b, s, _, _ = out.shape
    return out.reshape(b, s, -1) @ p["w_o"].to(x.dtype)


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, S_cache, KV, hd]
    v: torch.Tensor
    pos: torch.Tensor        # [] int32: tokens decoded so far (absolute)


def init_kv_cache(batch: int, cache_len: int, cfg: AttnConfig, dtype=None,
                  device=None) -> KVCache:
    dtype = C.COMPUTE_DTYPE if dtype is None else dtype
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((), dtype=torch.int32, device=device))


def attention_decode(p, x, cache: KVCache, cfg: AttnConfig):
    """One-token decode: append to the KV cache, attend over it.

    With a sliding window the cache is a rolling buffer of ``window`` slots
    (slot = pos % window): memory and compute O(window) per token. The new
    K/V are written into ``cache.k``/``cache.v`` in place (the reference
    selects them into fresh arrays; the values are the same), and the
    returned cache shares those buffers.
    """
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode processes one new token, got {s}")
    q, k, v = _project_qkv(p, x, cfg)
    pos = cache.pos
    q, k = _rope(q, k, pos.reshape(1, 1).expand(b, 1), cfg)
    cache_len = cache.k.shape[1]
    # Rolling slot: for full-attention caches pos < cache_len so this is pos
    # itself; for sliding-window caches the buffer wraps (slot = pos % W).
    slot = (pos % cache_len).reshape(1).long()
    cache.k.index_copy_(1, slot, k.to(cache.k.dtype))
    cache.v.index_copy_(1, slot, v.to(cache.v.dtype))
    valid = torch.clamp(pos + 1, max=cache_len)
    out = sdpa_chunked(q, cache.k, cache.v, causal=False, kv_valid_len=valid,
                       q_offset=pos)
    new_cache = KVCache(k=cache.k, v=cache.v, pos=pos + 1)
    return out.reshape(b, 1, -1) @ p["w_o"].to(x.dtype), new_cache


def attention_encoder(p, x, cfg: AttnConfig, q_chunk: int = 512):
    """Bidirectional self-attention (whisper encoder)."""
    q, k, v = _project_qkv(p, x, cfg)
    pos = torch.arange(x.shape[1], device=x.device)[None].expand(x.shape[:2])
    q, k = _rope(q, k, pos, cfg)
    out = sdpa_chunked(q, k, v, causal=False, q_chunk=q_chunk)
    b, s, _, _ = out.shape
    return out.reshape(b, s, -1) @ p["w_o"].to(x.dtype)


def cross_attention(p, x, enc_k, enc_v, cfg: AttnConfig):
    """Decoder cross-attention over precomputed encoder K/V."""
    b, s, _ = x.shape
    q = (x @ p["w_q"].to(x.dtype)).reshape(b, s, cfg.num_heads, cfg.head_dim)
    out = sdpa_chunked(q, enc_k, enc_v, causal=False)
    return out.reshape(b, s, -1) @ p["w_o"].to(x.dtype)
