"""Architecture-generic LM: config, init, forward and serve_step.

The port of ``repro.models.transformer`` for the attention families
(``dense``, ``moe``, ``vlm``; MoE with MLA for deepseek). Per-layer
parameters and caches are stacked on a leading layer axis under the
reference's key strings, as ``jax.vmap`` init leaves them, and a plain
loop over layers replaces ``lax.scan``. ``hybrid`` (Mamba2), ``ssm``
(xLSTM) and ``audio`` (Whisper) raise ``NotImplementedError``, as do
``compute_loss`` and ``train_step`` (LM training).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.utils.trees import tree_leaves, tree_map

ATTENTION_FAMILIES = ("dense", "moe", "vlm")
NOT_PORTED = {
    "hybrid": "ROADMAP A8(b) ports its serving (models/mamba2.py and zamba2's "
              "shared attention)",
    "ssm": "ROADMAP A8(b) ports its serving (models/xlstm.py)",
    "audio": "ROADMAP A8(b) ports its serving (whisper's encoder, "
             "cross-attention and gelu_mlp)",
}


def not_ported(family: str) -> NotImplementedError:
    return NotImplementedError(
        f"family {family!r} is not ported to the PyTorch port yet: "
        f"{NOT_PORTED[family]}")


def _check_family(cfg) -> None:
    if cfg.family in NOT_PORTED:
        raise not_ported(cfg.family)
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(cfg.family)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    window: Optional[int] = None   # sliding-window attention (long_500k variant)
    mrope_sections: Optional[Tuple[int, ...]] = None   # vlm
    vision_patches: int = 256      # vlm stub: prefix patch embeddings
    # moe
    moe: Optional[MOE.MoEConfig] = None
    # mla (deepseek)
    mla: Optional[MLA.MLAConfig] = None
    # ssm / hybrid (their modules are not ported: ROADMAP A8(b))
    mamba: Optional[Any] = None
    attn_every: int = 0            # hybrid: shared attn block every k layers
    # xlstm: layers grouped as (group_size-1) mLSTM + 1 sLSTM
    xlstm: Optional[Any] = None
    xlstm_group: int = 4
    # audio (whisper)
    enc_layers: int = 0
    enc_frames: int = 1500
    # runtime knobs
    q_chunk: int = 512
    source: str = ""               # citation for the config

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def attn_cfg(self, window: Optional[int] = None) -> A.AttnConfig:
        return A.AttnConfig(
            num_heads=self.num_heads, num_kv_heads=self.num_kv_heads,
            head_dim=self.hd, qkv_bias=self.qkv_bias, rope_theta=self.rope_theta,
            window=window if window is not None else self.window,
            mrope_sections=self.mrope_sections,
        )

    def param_count(self) -> int:
        """Parameters of ``init_params``, counted on the meta device
        (nothing is allocated)."""
        return sum(t.numel() for t in tree_leaves(init_params(None, self, "meta")))


# ------------------------------------------------------------------ blocks


def _init_dense_block(gen, cfg: ArchConfig, lead=(), device=None):
    lead = tuple(lead)
    dev = gen.device if device is None else torch.device(device)
    p = {
        "attn_norm": torch.ones(lead + (cfg.d_model,), device=dev),
        "mlp_norm": torch.ones(lead + (cfg.d_model,), device=dev),
    }
    if cfg.mla is not None:
        p["attn"] = MLA.init_mla(gen, cfg.d_model, cfg.mla, lead, dev)
    else:
        p["attn"] = A.init_attention(gen, cfg.d_model, cfg.attn_cfg(), lead, dev)
    if cfg.moe is not None:
        p["moe"] = MOE.init_moe(gen, cfg.d_model, cfg.moe, lead, dev)
    else:
        p["mlp"] = C.init_swiglu(gen, cfg.d_model, cfg.d_ff, lead, dev)
    return p


def _ffn(p, hn, cfg: ArchConfig):
    if cfg.moe is not None:
        return MOE.moe_ffn(p["moe"], hn, cfg.moe)
    mlp = p["mlp"]
    return C.swiglu(hn, mlp["w_gate"], mlp["w_up"], mlp["w_down"]), None


def _dense_block_train(p, h, positions, cfg: ArchConfig, window=None):
    hn = C.rms_norm(h, p["attn_norm"], cfg.norm_eps)
    if cfg.mla is not None:
        h = h + MLA.mla_train(p["attn"], hn, positions, cfg.mla, cfg.q_chunk)
    else:
        h = h + A.attention_train(p["attn"], hn, positions,
                                  cfg.attn_cfg(window), cfg.q_chunk)
    hn = C.rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    out, aux = _ffn(p, hn, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + out, aux


def _dense_block_decode(p, h, cache, cfg: ArchConfig, window=None):
    hn = C.rms_norm(h, p["attn_norm"], cfg.norm_eps)
    if cfg.mla is not None:
        out, cache = MLA.mla_decode(p["attn"], hn, cache, cfg.mla)
    else:
        out, cache = A.attention_decode(p["attn"], hn, cache, cfg.attn_cfg(window))
    h = h + out
    hn = C.rms_norm(h, p["mlp_norm"], cfg.norm_eps)
    out, _ = _ffn(p, hn, cfg)
    return h + out, cache


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter or cache tree (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


# ------------------------------------------------------------------ params


def init_params(gen: Optional[torch.Generator], cfg: ArchConfig,
                device=None) -> Dict[str, Any]:
    """fp32 parameters drawn from ``gen`` on ``device`` (default: the
    generator's; ``"meta"`` allocates nothing and needs no generator)."""
    _check_family(cfg)
    dev = gen.device if device is None else torch.device(device)
    p: Dict[str, Any] = {
        "embed": C.normal_init(gen, (cfg.vocab_size, cfg.d_model), device=dev),
        "final_norm": torch.ones((cfg.d_model,), device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = C.normal_init(gen, (cfg.d_model, cfg.vocab_size), device=dev)
    p["blocks"] = _init_dense_block(gen, cfg, (cfg.num_layers,), dev)
    return p


# ----------------------------------------------------------------- forward


def _vlm_positions(batch: int, seq: int, n_patches: int, grid: int = 16,
                   device=None) -> torch.Tensor:
    """M-RoPE 3D positions: patch prefix gets a (t=0, h, w) grid, text
    continues temporally after the vision span."""
    idx = torch.arange(seq, device=device)
    is_patch = idx < n_patches
    text = idx - n_patches + 1
    t = torch.where(is_patch, 0, text)
    h = torch.where(is_patch, idx // grid, text)
    w = torch.where(is_patch, idx % grid, text)
    pos = torch.stack([t, h, w])                       # [3, S]
    return pos[:, None, :].expand(3, batch, seq)


def _head(params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def forward_train(params, cfg: ArchConfig, tokens: torch.Tensor,
                  extra: Optional[Dict[str, torch.Tensor]] = None,
                  window: Optional[int] = None):
    """tokens [B, S] -> logits [B, S, V] (bf16 compute), plus moe aux loss.
    Forward only: the prefill counterpart of ``serve_step``."""
    _check_family(cfg)
    b, s = tokens.shape
    dev = tokens.device
    h = params["embed"][tokens].to(C.COMPUTE_DTYPE)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)

    if cfg.family == "vlm" and extra is not None and "patches" in extra:
        npatch = extra["patches"].shape[1]
        h = torch.cat([extra["patches"].to(h.dtype), h[:, npatch:]], dim=1)
        positions = _vlm_positions(b, s, npatch, device=dev)
    elif cfg.mrope_sections is not None:
        positions = _vlm_positions(b, s, 0, device=dev)
    else:
        positions = torch.arange(s, device=dev)[None].expand(b, s)

    for i in range(cfg.num_layers):
        h, a = _dense_block_train(_layer(params["blocks"], i), h, positions, cfg, window)
        aux_total = aux_total + a

    h = C.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h @ _head(params, cfg).to(h.dtype), aux_total


def compute_loss(*args, **kwargs):
    raise NotImplementedError(
        "LM training is not ported to the PyTorch port yet: ROADMAP A8(c)")


def train_step(*args, **kwargs):
    raise NotImplementedError(
        "LM training is not ported to the PyTorch port yet: ROADMAP A8(c)")


# -------------------------------------------------------------- serve step


class ServeCache(NamedTuple):
    layers: Any          # family-specific stacked cache (leading layer axis)
    extra: Any           # e.g. hybrid shared-attn caches, audio cross K/V


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               window: Optional[int] = None, device=None) -> ServeCache:
    """Cache for one-token decode with ``cache_len`` context on ``device``."""
    _check_family(cfg)
    eff_len = min(cache_len, window) if window else cache_len
    if cfg.mla is not None:
        one = MLA.init_mla_cache(batch, cache_len, cfg.mla, device=device)
    else:
        one = A.init_kv_cache(batch, eff_len, cfg.attn_cfg(window), device=device)
    layers = tree_map(
        lambda x: x.expand((cfg.num_layers,) + tuple(x.shape)).clone(), one)
    return ServeCache(layers=layers, extra=None)


def serve_step(params, cache: ServeCache, tokens: torch.Tensor, cfg: ArchConfig,
               window: Optional[int] = None):
    """Decode ONE token. tokens [B, 1] -> (logits [B, 1, V], new cache).

    Each layer writes its new K/V (or latent) into ``cache``'s buffers in
    place; the returned cache shares them and carries the advanced ``pos``.
    """
    _check_family(cfg)
    h = params["embed"][tokens].to(C.COMPUTE_DTYPE)
    new_pos = []
    for i in range(cfg.num_layers):
        h, c_l = _dense_block_decode(_layer(params["blocks"], i), h,
                                     _layer(cache.layers, i), cfg, window)
        new_pos.append(c_l.pos)
    cache = ServeCache(layers=cache.layers._replace(pos=torch.stack(new_pos)),
                       extra=None)
    h = C.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h @ _head(params, cfg).to(h.dtype), cache
