"""Architecture-generic LM: config, init, forward, training and serve_step.

The port of ``repro.models.transformer`` for all six families: ``dense``,
``moe`` (with MLA for deepseek) and ``vlm``; ``hybrid`` (Mamba2 with a
shared attention block every ``attn_every`` layers), ``ssm`` (xLSTM
groups) and ``audio`` (Whisper's encoder and decoder). Per-layer
parameters and caches are stacked on a leading layer axis under the
reference's key strings, as ``jax.vmap`` init leaves them, and a plain
loop over layers replaces ``lax.scan`` (a Python ``if`` replaces
``lax.cond``). While autograd records, each block the reference wraps in
``jax.checkpoint`` runs under ``torch.utils.checkpoint`` (its
activations are recomputed in the backward), and ``train_step`` is the
reference's: micro-batches of consecutive rows, fp32 gradient
accumulation, AdamW with a gradient clip of 1.0.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import mamba2 as MB
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as XL
from repro_torch.optim.adamw import adamw_update
from repro_torch.utils.trees import tree_leaves, tree_map

FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")
# Parameters the models read in fp32 whatever the compute dtype.
FP32_PARAMS = MB.FP32_PARAMS + XL.FP32_PARAMS


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    if cfg.family == "hybrid" and cfg.attn_every < 1:
        raise ValueError(f"{cfg.name}: hybrid needs attn_every >= 1")
    if cfg.family == "ssm" and cfg.num_layers % cfg.xlstm_group:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not whole groups "
                         f"of {cfg.xlstm_group}")


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
    # ssm / hybrid
    mamba: Optional[MB.MambaConfig] = None
    attn_every: int = 0            # hybrid: shared attn block every k layers
    # xlstm: layers grouped as (group_size-1) mLSTM + 1 sLSTM
    xlstm: Optional[XL.XLSTMConfig] = None
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


def _unbind(tree) -> list:
    """The layers of a stacked parameter tree, each leaf unbound once: its
    backward is one ``stack``, where ``_layer`` per layer would back each
    select into a zero-filled tensor the size of the whole stack."""
    if not isinstance(tree, dict):
        return list(tree.unbind(0))
    per = {k: _unbind(v) for k, v in tree.items()}
    n = len(next(iter(per.values())))
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def _recompute(fn, *args):
    """``fn(*args)``; while autograd records, its activations are dropped
    and recomputed in the backward (the reference's ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _write(dst, src) -> None:
    """Copy a layer's new recurrent state into its views of the stacked cache."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src)):
        d.copy_(s)


def _init_mamba_block(gen, cfg: ArchConfig, lead, device):
    return {
        "norm": torch.ones(lead + (cfg.d_model,), device=device),
        "mamba": MB.init_mamba(gen, cfg.d_model, cfg.mamba, lead, device),
    }


def _init_xlstm_group(gen, cfg: ArchConfig, lead, device):
    return {
        "mlstm": XL.init_mlstm_block(gen, cfg.xlstm, lead + (cfg.xlstm_group - 1,), device),
        "slstm": XL.init_slstm_block(gen, cfg.xlstm, lead, device),
    }


def _norms(names, lead, d: int, device):
    out = {}
    for n in names:
        out[f"{n}_norm_scale"] = torch.ones(lead + (d,), device=device)
        out[f"{n}_norm_bias"] = torch.zeros(lead + (d,), device=device)
    return out


def _init_whisper_enc_block(gen, cfg: ArchConfig, lead, device):
    return {
        **_norms(("attn", "mlp"), lead, cfg.d_model, device),
        "attn": A.init_attention(gen, cfg.d_model, cfg.attn_cfg(), lead, device),
        "mlp": C.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, lead, device),
    }


def _init_whisper_dec_block(gen, cfg: ArchConfig, lead, device):
    return {
        **_norms(("self", "cross", "mlp"), lead, cfg.d_model, device),
        "self_attn": A.init_attention(gen, cfg.d_model, cfg.attn_cfg(), lead, device),
        "cross_attn": A.init_attention(gen, cfg.d_model, cfg.attn_cfg(), lead, device),
        "mlp": C.init_gelu_mlp(gen, cfg.d_model, cfg.d_ff, lead, device),
    }


def _ln(x, p, name: str):
    """Whisper's LayerNorm ``name`` (with a bias) of block ``p``."""
    return C.layer_norm(x, p[f"{name}_norm_scale"], p[f"{name}_norm_bias"])


def _whisper_enc_block(p, x, cfg: ArchConfig):
    x = x + A.attention_encoder(p["attn"], _ln(x, p, "attn"), cfg.attn_cfg(), cfg.q_chunk)
    return x + C.gelu_mlp(_ln(x, p, "mlp"), **p["mlp"])


def _whisper_dec_block(p, h, k, v, positions, cfg: ArchConfig):
    acfg = cfg.attn_cfg()
    h = h + A.attention_train(p["self_attn"], _ln(h, p, "self"), positions, acfg,
                              cfg.q_chunk)
    h = h + A.cross_attention(p["cross_attn"], _ln(h, p, "cross"), k, v, acfg)
    return h + C.gelu_mlp(_ln(h, p, "mlp"), **p["mlp"])


def _mamba_block(p, h, cfg: ArchConfig):
    return MB.mamba_train(p["mamba"], C.rms_norm(h, p["norm"], cfg.norm_eps), cfg.mamba)


def _xlstm_group(p, h, cfg: ArchConfig):
    for p_m in _unbind(p["mlstm"]):
        h = XL.mlstm_block_train(p_m, h, cfg.xlstm)
    return XL.slstm_block_train(p["slstm"], h, cfg.xlstm)


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
    layers = (cfg.num_layers,)
    if cfg.family in ("dense", "moe", "vlm"):
        p["blocks"] = _init_dense_block(gen, cfg, layers, dev)
    elif cfg.family == "hybrid":
        p["blocks"] = _init_mamba_block(gen, cfg, layers, dev)
        p["shared_attn"] = _init_dense_block(gen, dataclasses.replace(cfg, moe=None),
                                             (), dev)
    elif cfg.family == "ssm":
        p["blocks"] = _init_xlstm_group(gen, cfg, (cfg.num_layers // cfg.xlstm_group,), dev)
    else:  # audio
        p["blocks"] = _init_whisper_dec_block(gen, cfg, layers, dev)
        p["enc_blocks"] = _init_whisper_enc_block(gen, cfg, (cfg.enc_layers,), dev)
        p["enc_pos"] = C.normal_init(gen, (cfg.enc_frames, cfg.d_model), device=dev)
        p["enc_norm"] = torch.ones((cfg.d_model,), device=dev)
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
    Differentiable (``compute_loss``); under ``no_grad`` it is the prefill
    counterpart of ``serve_step``."""
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

    blocks = _unbind(params["blocks"])
    if cfg.family in ("dense", "moe", "vlm"):
        def block(p, x):
            return _dense_block_train(p, x, positions, cfg, window)

        for p_l in blocks:
            h, a = _recompute(block, p_l, h)
            aux_total = aux_total + a
    elif cfg.family == "hybrid":
        k_every = cfg.attn_every
        for i, p_l in enumerate(blocks):
            h = h + _recompute(_mamba_block, p_l, h, cfg)
            if i % k_every == k_every - 1:   # the shared block is not recomputed
                h, _ = _dense_block_train(params["shared_attn"], h, positions, cfg, window)
    elif cfg.family == "ssm":
        for p_g in blocks:
            h = _recompute(_xlstm_group, p_g, h, cfg)
    else:  # audio
        if extra is None or "frames" not in extra:
            raise ValueError(f"{cfg.name}: the forward needs extra['frames'] "
                             f"[B, {cfg.enc_frames}, {cfg.d_model}]")
        cross_k, cross_v = encode_cross_kv(params, cfg, extra["frames"])
        for p_l, k_l, v_l in zip(blocks, cross_k.unbind(0), cross_v.unbind(0)):
            h = _recompute(_whisper_dec_block, p_l, h, k_l, v_l, positions, cfg)

    h = C.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h @ _head(params, cfg).to(h.dtype), aux_total


def encode_cross_kv(params, cfg: ArchConfig, frames: torch.Tensor):
    """Whisper's encoder over ``frames`` [B, F, D] (precomputed frame
    embeddings), then every decoder layer's cross-attention K and V of its
    output: (k, v), each [L, B, F, KV, hd] in the compute dtype. The
    reference computes them inside ``forward_train``; ``forward_train``
    attends to these, and a serving cache's ``extra`` takes them (the
    reference's ``init_cache`` leaves it zero)."""
    b = frames.shape[0]
    enc = frames.to(C.COMPUTE_DTYPE) + params["enc_pos"][None].to(C.COMPUTE_DTYPE)
    for p_l in _unbind(params["enc_blocks"]):
        enc = _recompute(_whisper_enc_block, p_l, enc, cfg)
    enc = C.rms_norm(enc, params["enc_norm"], cfg.norm_eps)
    cross = params["blocks"]["cross_attn"]
    k, v = (torch.stack([(enc @ w_l.to(enc.dtype)).reshape(b, -1, cfg.num_kv_heads, cfg.hd)
                         for w_l in w.unbind(0)])
            for w in (cross["w_k"], cross["w_v"]))
    return k, v


# -------------------------------------------------------------- train step


def compute_loss(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
                 window: Optional[int] = None) -> torch.Tensor:
    """Next-token cross entropy over ``batch["tokens"]`` [B, S] (masked by
    ``batch["loss_mask"]`` where given, never at the last position) plus
    the MoE aux loss; every other key of ``batch`` goes to the forward."""
    tokens = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "loss_mask")}
    logits, aux = forward_train(params, cfg, tokens, extra or None, window)
    labels = torch.roll(tokens, -1, dims=1)
    mask = batch.get("loss_mask")
    mask = (torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
            if mask is None else mask.clone())
    mask[:, -1] = 0  # no target for the final position
    return C.cross_entropy(logits, labels, mask) + aux


def loss_and_grads(params, cfg: ArchConfig, batch: Dict[str, torch.Tensor], *,
                   num_microbatches: int = 1, window: Optional[int] = None):
    """(loss, grads) of ``compute_loss``, as ``train_step`` takes them: with
    ``nm = num_microbatches > 1``, micro-batch ``i`` is the rows
    ``[i*B/nm, (i+1)*B/nm)`` of every batch entry, and the loss and the fp32
    gradients are the micro-batches' summed in order, each divided by nm.
    ``params`` are left as they are (the gradients are returned)."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = tree_leaves(live)

    def grads_of(mb):
        loss = compute_loss(live, cfg, mb, window)
        return loss.detach(), torch.autograd.grad(loss, leaves, materialize_grads=True)

    nm = num_microbatches
    if nm <= 1:
        loss, grads = grads_of(batch)
    else:
        rows = batch["tokens"].shape[0]
        if rows % nm:
            raise ValueError(f"batch of {rows} rows does not split into {nm} micro-batches")
        m = rows // nm
        loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        grads = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
        for i in range(nm):
            l_i, g_i = grads_of({k: v[i * m:(i + 1) * m] for k, v in batch.items()})
            for acc, g in zip(grads, g_i):
                acc.add_(g.float() / nm)
            loss = loss + l_i / nm
            del g_i                  # before the next micro-batch's backward
    by_leaf = {id(t): g for t, g in zip(leaves, grads)}
    return loss, tree_map(lambda t: by_leaf[id(t)], live)


def train_step(params, opt_state, batch, cfg: ArchConfig, *,
               lr: float = 3e-4, num_microbatches: int = 1,
               window: Optional[int] = None):
    """One optimizer step with optional gradient accumulation:
    (new_params, new_opt_state, loss)."""
    loss, grads = loss_and_grads(params, cfg, batch, num_microbatches=num_microbatches,
                                 window=window)
    new_params, new_opt = adamw_update(grads, opt_state, params, lr, grad_clip=1.0)
    return new_params, new_opt, loss


# -------------------------------------------------------------- serve step


class ServeCache(NamedTuple):
    layers: Any          # family-specific stacked cache (leading layer axis)
    extra: Any           # e.g. hybrid shared-attn caches, audio cross K/V


def _stack(one, lead):
    """``one`` cache repeated on the leading axes ``lead`` (own buffers)."""
    return tree_map(lambda x: x.expand(tuple(lead) + tuple(x.shape)).clone(), one)


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               window: Optional[int] = None, device=None) -> ServeCache:
    """Cache for one-token decode with ``cache_len`` context on ``device``.
    K/V caches are in the compute dtype, recurrent states fp32 (as the
    reference's); whisper's cross K/V start at zero (``encode_cross_kv``
    fills them)."""
    _check_family(cfg)
    eff_len = min(cache_len, window) if window else cache_len
    acfg = cfg.attn_cfg(window)
    layers = (cfg.num_layers,)
    if cfg.family in ("dense", "moe", "vlm"):
        if cfg.mla is not None:
            one = MLA.init_mla_cache(batch, cache_len, cfg.mla, device=device)
        else:
            one = A.init_kv_cache(batch, eff_len, acfg, device=device)
        return ServeCache(layers=_stack(one, layers), extra=None)
    if cfg.family == "hybrid":
        n_apps = cfg.num_layers // cfg.attn_every
        return ServeCache(
            layers=_stack(MB.init_mamba_cache(batch, cfg.mamba, device=device), layers),
            extra=_stack(A.init_kv_cache(batch, eff_len, acfg, device=device), (n_apps,)))
    if cfg.family == "ssm":
        groups = cfg.num_layers // cfg.xlstm_group
        return ServeCache(layers={
            "mlstm": _stack(XL.init_mlstm_cache(batch, cfg.xlstm, device=device),
                            (groups, cfg.xlstm_group - 1)),
            "slstm": _stack(XL.init_slstm_cache(batch, cfg.xlstm, device=device), (groups,)),
        }, extra=None)
    cross = (cfg.num_layers, batch, cfg.enc_frames, cfg.num_kv_heads, cfg.hd)
    return ServeCache(
        layers=_stack(A.init_kv_cache(batch, eff_len, acfg, device=device), layers),
        extra={k: torch.zeros(cross, dtype=C.COMPUTE_DTYPE, device=device)
               for k in ("k", "v")})


def serve_step(params, cache: ServeCache, tokens: torch.Tensor, cfg: ArchConfig,
               window: Optional[int] = None):
    """Decode ONE token. tokens [B, 1] -> (logits [B, 1, V], new cache).

    Each layer writes its new K/V (or latent, or recurrent state) into
    ``cache``'s buffers in place; the returned cache shares them and
    carries the advanced ``pos``.
    """
    _check_family(cfg)
    h = params["embed"][tokens].to(C.COMPUTE_DTYPE)
    blocks, extra = params["blocks"], cache.extra
    if cfg.family in ("dense", "moe", "vlm"):
        new_pos = []
        for i in range(cfg.num_layers):
            h, c_l = _dense_block_decode(_layer(blocks, i), h, _layer(cache.layers, i),
                                         cfg, window)
            new_pos.append(c_l.pos)
        layers = cache.layers._replace(pos=torch.stack(new_pos))
    elif cfg.family == "hybrid":
        k_every = cfg.attn_every
        app_pos = list(extra.pos)
        for i in range(cfg.num_layers):
            p_l, c_l = _layer(blocks, i), _layer(cache.layers, i)
            out, new = MB.mamba_decode(p_l["mamba"], C.rms_norm(h, p_l["norm"], cfg.norm_eps),
                                       c_l, cfg.mamba)
            _write(c_l, new)
            h = h + out
            if i % k_every == k_every - 1:
                app = i // k_every
                h, c_app = _dense_block_decode(params["shared_attn"], h, _layer(extra, app),
                                               cfg, window)
                app_pos[app] = c_app.pos
        layers, extra = cache.layers, extra._replace(pos=torch.stack(app_pos))
    elif cfg.family == "ssm":
        for g in range(cfg.num_layers // cfg.xlstm_group):
            p_g = _layer(blocks, g)
            for j in range(cfg.xlstm_group - 1):
                c_j = _layer(cache.layers["mlstm"], (g, j))
                h, new = XL.mlstm_block_decode(_layer(p_g["mlstm"], j), h, c_j, cfg.xlstm)
                _write(c_j, new)
            c_g = _layer(cache.layers["slstm"], g)
            h, new = XL.slstm_block_decode(p_g["slstm"], h, c_g, cfg.xlstm)
            _write(c_g, new)
        layers = cache.layers
    else:  # audio
        acfg = cfg.attn_cfg(window)
        new_pos = []
        for i in range(cfg.num_layers):
            p_l = _layer(blocks, i)
            out, c_l = A.attention_decode(p_l["self_attn"], _ln(h, p_l, "self"),
                                          _layer(cache.layers, i), acfg)
            h = h + out
            h = h + A.cross_attention(p_l["cross_attn"], _ln(h, p_l, "cross"),
                                      extra["k"][i], extra["v"][i], acfg)
            h = h + C.gelu_mlp(_ln(h, p_l, "mlp"), **p_l["mlp"])
            new_pos.append(c_l.pos)
        layers = cache.layers._replace(pos=torch.stack(new_pos))
    h = C.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h @ _head(params, cfg).to(h.dtype), ServeCache(layers=layers, extra=extra)
