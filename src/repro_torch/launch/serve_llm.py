"""Serve an LM with batched requests on the card: prefill, then greedy decode.

The port of ``examples/serve_llm.py``, for all ten architectures (dense,
vlm, moe, MLA; hybrid Mamba2, xLSTM, Whisper): a batch of random prompts
is prefilled token by token through ``serve_step`` (filling the KV,
latent or recurrent cache), then decoded greedily, one ``serve_step`` a
token. Whisper decodes against the cross K/V of frame embeddings
(``encode_cross_kv``): the launcher draws them from ``--seed``, as
``[B, enc_frames, d_model]`` normals (the reference's training draws
them so); a caller that passes no frames serves with the reference's
zero cross cache. ``--smoke`` takes the reduced config, as the JAX
launcher's ``--arch --smoke`` does; without it, the full config. Weights
are drawn from ``--seed`` in fp32 and cast once to the compute dtype
(bf16) when the model is built, except the few the models read in fp32
(``FP32_PARAMS``): the models cast every other weight to the activations'
dtype at each product, so the cast copy gives the same bits. ``--device``
is the card by default; it raises if there is none. Both copies must fit
the card: at full width qwen2.5-32b (131 GB in fp32) and
deepseek-v2-lite-16b (64.8 GB in fp32, 32.4 GB more for the copy) do not
fit one 80 GB card.

Examples:
  python -m repro_torch.launch.serve_llm
  python -m repro_torch.launch.serve_llm --arch granite-moe-1b-a400m --gen 32
  python -m repro_torch.launch.serve_llm --arch whisper-small
  python -m repro_torch.launch.serve_llm --smoke --arch xlstm-350m --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch.models import common as C
from repro_torch.models.transformer import (FP32_PARAMS, ArchConfig, encode_cross_kv,
                                            forward_train, init_cache, init_params,
                                            serve_step)


# Bars on two runs' logits, × max|logit|. bf16: two runs that round
# differently (the card and the CPU, the port and the reference, decode and
# the full forward). The reference's own bf16 logits are 0.62-0.84% of
# max|logit| from its fp32 logits on the attention families' smoke configs,
# and 2e-2 sits above them. Where the reference's own distance (bf16 vs
# fp32, or its bf16 decode vs its bf16 forward) is larger, a family's bar
# is about twice it at the depth compared, as (layers up to, bar) pairs:
# the first that covers the run's depth applies. Measured with
# tests/lm_reference_distances.py (2 seeds; the smoke configs' depths at
# smoke width, the deeper ones at full width where the CPU holds them):
# zamba2 2.136e-2 at its smoke 4 layers, 2.281e-2 at 6 (full width),
# 7.39e-2 at 54 (smoke width); xLSTM 1.82e-2 at 4 layers and 2.33e-2 at 8
# (full width), growing 1.9x from 4 to 24 layers at smoke width, so about
# 3.5e-2 at 24; whisper 9.5e-3 at 2 + 2 (full width), 1.52e-2 at 12 + 12
# (smoke width). fp32: decode against the full forward; the reference's own
# distance is at most 4.3e-6 (zamba2, 54 layers), 2.1e-6 on the others.
BF16_BAR = 2e-2
BF16_BARS = {"hybrid": ((6, 5e-2), (54, 1.5e-1)),
             "ssm": ((2, 2e-2), (4, 4e-2), (24, 8e-2)),
             "audio": ((2, 2e-2), (12, 3e-2))}
FP32_BAR = 1e-5


def bf16_bar(cfg: ArchConfig) -> float:
    for layers, bar in BF16_BARS.get(cfg.family, ()):
        if cfg.num_layers <= layers:
            return bar
    return BF16_BAR


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device without a
    card. On the card the products keep XLA's arithmetic: no TF32 (the
    fp32 score products) and no bf16 reduction of split-K partial sums."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r}: no CUDA card is available (pass "
                "--device cpu to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


class LM(NamedTuple):
    cfg: ArchConfig
    params: dict             # fp32, as init_params draws them
    served: dict             # the same, cast once to the compute dtype (compute_params)
    device: torch.device


def compute_params(params):
    """Every parameter cast once to the compute dtype, but for those the
    models read in fp32 (``FP32_PARAMS``), which are kept."""
    return {k: compute_params(v) if isinstance(v, dict)
            else v if k in FP32_PARAMS else v.to(C.COMPUTE_DTYPE)
            for k, v in params.items()}


def build_lm(cfg: ArchConfig, seed: int = 0, device="cuda") -> LM:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(gen, cfg)
    return LM(cfg, params, compute_params(params), dev)


class Generation(NamedTuple):
    tokens: torch.Tensor     # [B, gen] greedy tokens
    logits: torch.Tensor     # [B, prompt_len + gen - 1, V], every step's logits
    prefill_s: float         # host seconds, synchronized on the card
    decode_s: float
    decode_steps: int        # gen - 1 (the first token comes from the prefill)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def with_frames(served, cfg: ArchConfig, cache, frames):
    """``cache`` with whisper's cross K/V of ``frames`` [B, enc_frames,
    d_model] (``encode_cross_kv``); without frames, ``cache`` as it is."""
    if frames is None:
        return cache
    if cfg.family != "audio":
        raise ValueError(f"{cfg.name} ({cfg.family}) takes no frames")
    k, v = encode_cross_kv(served, cfg, frames.to(cache.layers.k.device))
    return cache._replace(extra={"k": k, "v": v})


def draw_frames(cfg: ArchConfig, batch: int, seed: int) -> torch.Tensor:
    """Whisper's stand-in frame embeddings [B, enc_frames, d_model]: fp32
    normals from ``seed`` on the CPU."""
    return torch.randn((batch, cfg.enc_frames, cfg.d_model),
                       generator=torch.Generator().manual_seed(seed))


def generate(lm: LM, prompts: torch.Tensor, gen: int, frames=None) -> Generation:
    """Prefill ``prompts`` [B, P] token by token, then decode ``gen`` tokens
    greedily, all through ``serve_step``. Whisper's ``frames`` are encoded
    into the cache's cross K/V first, inside the prefill's time."""
    cfg, dev = lm.cfg, lm.device
    b, plen = prompts.shape
    if plen < 1 or gen < 1:
        raise ValueError(f"need a prompt and a token to generate, got {plen}, {gen}")
    prompts = prompts.to(dev)
    cache = init_cache(cfg, b, plen + gen, device=dev)
    logits = []
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        cache = with_frames(lm.served, cfg, cache, frames)
        for i in range(plen):
            out, cache = serve_step(lm.served, cache, prompts[:, i:i + 1], cfg)
            logits.append(out)
        _sync(dev)
        prefill_s = time.perf_counter() - t0

        tok = out[:, -1:].argmax(-1)
        generated = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            out, cache = serve_step(lm.served, cache, tok, cfg)
            logits.append(out)
            tok = out[:, -1:].argmax(-1)
            generated.append(tok)
        _sync(dev)
        decode_s = time.perf_counter() - t0
    return Generation(torch.cat(generated, 1), torch.cat(logits, 1), prefill_s,
                      decode_s, gen - 1)


def teacher_forced(served, cfg: ArchConfig, tokens: torch.Tensor,
                   frames=None) -> torch.Tensor:
    """Logits [B, S, V] of ``serve_step`` fed ``tokens`` [B, S] one by one
    (on ``tokens``' device; whisper's cross K/V from ``frames``, if given)."""
    b, s = tokens.shape
    cache = init_cache(cfg, b, s, device=tokens.device)
    out = []
    with torch.inference_mode():
        cache = with_frames(served, cfg, cache, frames)
        for i in range(s):
            logits, cache = serve_step(served, cache, tokens[:, i:i + 1], cfg)
            out.append(logits)
    return torch.cat(out, 1)


def full_forward(served, cfg: ArchConfig, tokens: torch.Tensor,
                 frames=None) -> torch.Tensor:
    """Logits [B, S, V] of ``forward_train`` over ``tokens`` at once
    (whisper: over ``frames`` too)."""
    extra = None if frames is None else {"frames": frames.to(tokens.device)}
    with torch.inference_mode():
        return forward_train(served, cfg, tokens, extra)[0]


class RecordRoutes:
    """While open, every MoE FFN of the port also records its router's
    choice (``moe.route`` on the call's own input: fp32 probs [T, E] and
    selected experts [T, K]); the model's outputs are untouched. Two bf16
    runs that round differently (card and CPU, decode and forward) can
    flip a near-tie between experts; ``router_flips`` finds those tokens."""

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._orig = [], moe.moe_ffn

        def moe_ffn(p, x, cfg):
            probs, _, sel = moe.route(p, x.reshape(-1, x.shape[-1]), cfg)
            self.calls.append((probs, sel))
            return self._orig(p, x, cfg)

        moe.moe_ffn = moe_ffn
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.moe_ffn = self._orig

    def by_token(self, cfg: ArchConfig, batch: int, seq: int):
        """(probs [L, B, S, E], sel [L, B, S, K]) on the host, from either
        one ``forward_train`` (L calls of B*S tokens) or ``seq`` steps of
        ``serve_step`` (seq * L calls of B tokens)."""
        n, lay = len(self.calls), cfg.num_layers
        probs = torch.stack([p for p, _ in self.calls]).float().cpu()
        sel = torch.stack([s for _, s in self.calls]).cpu()
        if n == lay:
            return (probs.reshape(lay, batch, seq, -1), sel.reshape(lay, batch, seq, -1))
        if n != seq * lay:
            raise ValueError(f"{n} MoE calls for {lay} layers and {seq} positions")
        return (probs.reshape(seq, lay, batch, -1).permute(1, 2, 0, 3),
                sel.reshape(seq, lay, batch, -1).permute(1, 2, 0, 3))


def router_flips(got: RecordRoutes, want: RecordRoutes, cfg: ArchConfig,
                 batch: int, seq: int, tie: float = 2e-2):
    """Where two runs' routers disagree: (flipped, affected, not_ties).
    ``flipped`` holds the tokens (b, s) whose selected experts differ in
    some layer. A flip below the last layer changes that token's keys and
    values above it, which every later position of its sequence attends
    to, so ``affected`` holds those positions too. A flip that no flip of
    a lower layer at the same or an earlier position explains must be a
    near-tie: ``not_ties`` lists those where ``want``'s probabilities of
    the experts only it selected and of those only ``got`` selected differ
    by more than ``tie`` of the former's smallest."""
    flipped, affected, not_ties = set(), set(), []
    if cfg.moe is None:
        return flipped, affected, not_ties
    _, gsel = got.by_token(cfg, batch, seq)
    wprobs, wsel = want.by_token(cfg, batch, seq)
    gs, ws = gsel.sort(-1).values, wsel.sort(-1).values
    first = {}                       # b -> earliest flipped position in lower layers
    for lay in range(cfg.num_layers):
        here = (gs[lay] != ws[lay]).any(-1).nonzero().tolist()
        for b, s in here:
            flipped.add((b, s))
            affected.update((b, t) for t in range(s, s + 1 if lay == cfg.num_layers - 1
                                                  else seq))
            if first.get(b, seq) <= s:
                continue             # explained by a flip below it
            g, w = set(gsel[lay, b, s].tolist()), set(wsel[lay, b, s].tolist())
            p = wprobs[lay, b, s]
            only_w, only_g = p[sorted(w - g)].min(), p[sorted(g - w)].max()
            if abs(float(only_w - only_g)) > tie * float(only_w):
                not_ties.append((lay, b, s, sorted(w - g), sorted(g - w)))
        for b, s in here:
            first[b] = min(first.get(b, seq), s)
    return flipped, affected, not_ties


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve an LM: batched prefill, then greedy decode")
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the prompts")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (2 layers, narrow) in place of the full one")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch, get_smoke_arch

    dev = resolve_device(args.device)
    cfg = get_smoke_arch(args.arch) if args.smoke else get_arch(args.arch)
    lm = build_lm(cfg, args.seed, dev)
    print(f"arch {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"({'reduced' if args.smoke else 'full'} config) on {dev}")
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator().manual_seed(args.seed))
    frames = draw_frames(cfg, args.batch, args.seed) if cfg.family == "audio" else None
    res = generate(lm, prompts, args.gen, frames)
    print(f"prefill {args.prompt_len} tok x {args.batch} reqs: {res.prefill_s:.2f}s")
    print(f"decoded {args.gen} tok x {args.batch} reqs in {res.decode_s:.2f}s "
          f"({res.decode_s / max(res.decode_steps, 1) * 1e3:.0f} ms/step)")
    for b in range(args.batch):
        print(f"req {b}: {res.tokens[b, :12].tolist()} ...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
