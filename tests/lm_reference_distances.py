"""The JAX package's own distances between two of its LM runs: the numbers
behind the port's bf16 bars (``repro_torch.launch.serve_llm.BF16_BARS``).

For an architecture's smoke widths (or, with ``--full-width``, its full
config's) at a chosen depth (its full config's layer schedule: zamba2's
shared block every 6th layer, xLSTM's groups of 4, whisper's encoder as
deep as its decoder), the reference's
``forward_train`` and teacher-forced ``serve_step`` logits at fp32 and at
bf16, from ``init_params`` at a seed, on 4 sequences of 12 tokens (the
port's phase-15 prompt; whisper decodes against the cross K/V of frame
normals, which the reference computes only inside ``forward_train``:
``jax_cross_kv`` does so the same way). Prints, × max|logit|, decode
against forward at fp32 and at bf16, and bf16 against fp32 (forward and
decode). Imports nothing of the port; runs on the CPU in seconds to a
minute a depth (keep full widths to a few layers there):

    PYTHONPATH=src python tests/lm_reference_distances.py zamba2-2.7b 6 18 54
    PYTHONPATH=src python tests/lm_reference_distances.py xlstm-350m 4 24
    PYTHONPATH=src python tests/lm_reference_distances.py whisper-small 2 12
    PYTHONPATH=src python tests/lm_reference_distances.py --full-width xlstm-350m 4
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs as JCFG
from repro import models as JM
from repro.models import attention as JA
from repro.models import common as JC


def jax_cross_kv(p, cfg, frames):
    """The reference's encoder and per-layer cross K/V, as its
    ``forward_train`` computes them: (k, v) each [L, B, F, KV, hd]."""
    b = frames.shape[0]
    enc = frames.astype(JC.COMPUTE_DTYPE) + p["enc_pos"][None].astype(JC.COMPUTE_DTYPE)

    def block(hh, pp):
        xn = JC.layer_norm(hh, pp["attn_norm_scale"], pp["attn_norm_bias"])
        hh = hh + JA.attention_encoder(pp["attn"], xn, cfg.attn_cfg(), cfg.q_chunk)
        xn = JC.layer_norm(hh, pp["mlp_norm_scale"], pp["mlp_norm_bias"])
        return hh + JC.gelu_mlp(xn, **pp["mlp"]), None

    enc, _ = jax.lax.scan(block, enc, p["enc_blocks"])
    enc = JC.rms_norm(enc, p["enc_norm"], cfg.norm_eps)

    def proj(w):
        return (enc @ w.astype(enc.dtype)).reshape(b, -1, cfg.num_kv_heads, cfg.hd)

    cross = p["blocks"]["cross_attn"]
    return jax.vmap(proj)(cross["w_k"]), jax.vmap(proj)(cross["w_v"])


def reference_logits(cfg, dtype, seed: int, batch: int = 4, seq: int = 12):
    """(forward, teacher-forced decode) logits [B, S, V] as fp32 numpy, the
    reference run at ``dtype`` (jnp.float32 or jnp.bfloat16)."""
    saved, JC.COMPUTE_DTYPE = JC.COMPUTE_DTYPE, dtype
    try:
        params = jax.jit(lambda k: JM.init_params(k, cfg))(jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
        extra = None
        if cfg.family == "audio":
            extra = {"frames": rng.normal(size=(batch, cfg.enc_frames, cfg.d_model))
                     .astype(np.float32)}
        fwd = jax.jit(lambda p, t, e: JM.forward_train(p, cfg, t, e)[0])(params, toks, extra)
        step = jax.jit(lambda p, c, t: JM.serve_step(p, c, t, cfg))
        cache = jax.tree_util.tree_map(      # its K/V caches bind bf16 at import
            lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16 else a,
            JM.init_cache(cfg, batch, seq))
        if extra is not None:
            k, v = jax.jit(lambda p, f: jax_cross_kv(p, cfg, f))(params, extra["frames"])
            cache = cache._replace(extra={"k": k, "v": v})
        out = []
        for i in range(seq):
            logits, cache = step(params, cache, toks[:, i:i + 1])
            out.append(np.asarray(logits, np.float32))
        return np.asarray(fwd, np.float32), np.concatenate(out, 1)
    finally:
        JC.COMPUTE_DTYPE = saved


def distances(cfg, seed: int) -> dict:
    def rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    f32_fwd, f32_dec = reference_logits(cfg, jnp.float32, seed)
    bf_fwd, bf_dec = reference_logits(cfg, jnp.bfloat16, seed)
    return {"decode vs forward f32": rel(f32_dec, f32_fwd),
            "decode vs forward bf16": rel(bf_dec, bf_fwd),
            "bf16 vs f32 forward": rel(bf_fwd, f32_fwd),
            "bf16 vs f32 decode": rel(bf_dec, f32_dec)}


def at_depth(name: str, layers: int, full_width: bool = False):
    """``name``'s smoke widths (or its full config's) with ``layers`` layers
    in its full config's schedule."""
    full, smoke = JCFG.get_arch(name), JCFG.get_smoke_arch(name)
    base = full if full_width else smoke
    kw = {"num_layers": layers}
    if full.family == "hybrid":
        kw["attn_every"] = full.attn_every
    elif full.family == "ssm":
        kw["xlstm_group"] = full.xlstm_group
    elif full.family == "audio":
        kw["enc_layers"] = layers
    return dataclasses.replace(base, **kw)


def main(argv) -> int:
    full_width = argv[:1] == ["--full-width"]
    argv = argv[1:] if full_width else argv
    name, depths = argv[0], [int(a) for a in argv[1:]]
    widths = "full widths" if full_width else "smoke widths"
    for layers in depths:
        for seed in (0, 1):
            d = distances(at_depth(name, layers, full_width), seed)
            print(f"{name} {widths}, {layers} layers, seed {seed}: "
                  + "; ".join(f"{k} {v:.4e}" for k, v in d.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
