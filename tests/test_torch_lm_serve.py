"""LM serving in the port against ``repro.models``, whole model, smoke configs.

For each of the 7 attention-family smoke configs, the same parameters
(``repro_torch.parity.lm_params_from_jax``) and the same tokens (a numpy
seed) go through ``forward_train`` and 8 teacher-forced ``serve_step``s of
both packages:

- fp32 (both packages' ``COMPUTE_DTYPE`` patched to float32 inside the
  test, the JAX cache cast to match): logits within 1e-5 × max|logit|;
- bf16, as shipped: within 2e-2 × max|logit|. The JAX package's own bf16
  decode differs from its fp32 decode by 0.7–0.84% of max|logit| here.

``pos`` matches exactly. The router's choices are recorded in both
packages: at fp32 they agree everywhere. At bf16 a token whose experts
differ in some layer is counted and printed (``router_mismatch_tokens``);
its logits, and those of the later positions of its sequence that attend
to it, are left out of the bar; and a flip that no lower flip explains
must be between experts the reference itself rates within 2e-2 of each
other (a near-tie that bf16 rounding flips, not a routing fault).

Then widths without allocating (``param_count``, ``init_cache`` shapes)
and the registry for all ten architectures, the rolling window buffer, and
the entry point. The hybrid, ssm and audio families are held to the
reference in ``test_torch_lm_families.py``.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro import models as JM
from repro.models import common as JC
from repro.models import moe as JMOE

from repro_torch import configs as TCFG
from repro_torch import models as TM
from repro_torch.launch import serve_llm
from repro_torch.models import common as TC
from repro_torch.models.transformer import ArchConfig
from repro_torch.parity import lm_params_from_jax
from repro_torch.utils.trees import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["tinyllama-1.1b", "llama3.2-3b", "qwen2.5-32b", "starcoder2-3b",
         "qwen2-vl-2b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b"]
BAR = {"f32": 1e-5, "bf16": 2e-2}       # × max|logit|
B, S = 2, 8

_JAX_ROUTES = []                       # (probs [T, E], sel [T, K]) per MoE call
_JITS = {}


def _record_jax_moe(orig):
    def moe_ffn(p, x, cfg):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax((xt @ p["router"].astype(xt.dtype)).astype(jnp.float32), -1)
        sel = jax.lax.top_k(probs, cfg.top_k)[1]
        jax.debug.callback(lambda a, b: _JAX_ROUTES.append((np.asarray(a), np.asarray(b))),
                           probs, sel, ordered=True)
        return orig(p, x, cfg)
    return moe_ffn


@pytest.fixture(scope="module", autouse=True)
def record_jax_routes():
    """The JAX package's MoE FFN records its routing for this module,
    through an ordered debug callback, so inside ``jit``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMOE, "moe_ffn", _record_jax_moe(JMOE.moe_ffn))
        yield


@pytest.fixture(scope="module")
def models():
    """name -> (JAX cfg, port cfg, JAX params as numpy, port params, tokens)."""
    out = {}
    for name in ARCHS:
        jcfg, tcfg = JCFG.get_smoke_arch(name), TCFG.get_smoke_arch(name)
        jp = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k, c=jcfg: JM.init_params(k, c))(jax.random.PRNGKey(1)))
        toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        out[name] = (jcfg, tcfg, jp, lm_params_from_jax(jp), toks)
    return out


@pytest.fixture(params=["f32", "bf16"])
def dtype(request, monkeypatch):
    if request.param == "f32":
        monkeypatch.setattr(JC, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(TC, "COMPUTE_DTYPE", torch.float32)
    return request.param


def _jit(name, dtype, jcfg, window=None):
    """One jitted JAX forward and serve_step per (config, dtype, window):
    ``COMPUTE_DTYPE`` is read while tracing, so it is part of the key."""
    key = (name, dtype, window)
    if key not in _JITS:
        _JITS[key] = (jax.jit(lambda p, t: JM.forward_train(p, jcfg, t)[0]),
                      jax.jit(lambda p, c, t: JM.serve_step(p, c, t, jcfg, window)))
    return _JITS[key]


def _jax_cache(jcfg, cache_len, window=None):
    c = JM.init_cache(jcfg, B, cache_len, window)
    return jax.tree_util.tree_map(
        lambda a: a if a.dtype == jnp.int32 else a.astype(JC.COMPUTE_DTYPE), c)


def _take_jax_routes() -> serve_llm.RecordRoutes:
    """The JAX calls recorded since the last take, as the port records them."""
    jax.effects_barrier()
    rec = serve_llm.RecordRoutes()
    rec.calls = [(torch.from_numpy(np.array(p)), torch.from_numpy(np.array(s)).long())
                 for p, s in _JAX_ROUTES]
    _JAX_ROUTES.clear()
    return rec


def _flips(dtype, name, what, jcfg, port_routes) -> set:
    """The tokens left out of the bar: router flips against the reference
    and the later positions that attend to them (``router_flips``). Each
    flip no lower flip explains must be a near-tie; at fp32 none is
    allowed. The count is printed."""
    flipped, affected, not_ties = serve_llm.router_flips(
        port_routes, _take_jax_routes(), jcfg, B, S)
    assert not not_ties, not_ties
    if dtype == "f32":
        assert not flipped, f"fp32 routing differs from the reference at {sorted(flipped)}"
    if jcfg.moe:
        print(f"router_mismatch_tokens {name} {dtype} {what}: {len(flipped)} of {B * S} "
              f"(left out with later positions: {len(affected)})")
    return affected


def _assert_logits(got, want, bar, skip=()):
    """Logits [B, S, V] within bar × max|logit|, tokens (b, s) in ``skip``
    left out."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    keep = np.ones(want.shape[:2], bool)
    for b, s in skip:
        keep[b, s] = False
    err = np.abs(got[keep] - want[keep]).max()
    assert err <= bar * np.abs(want).max(), (err, np.abs(want).max())
    return err / np.abs(want).max()


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_jax(models, dtype, name):
    jcfg, tcfg, jp, tp, toks = models[name]
    _take_jax_routes()
    fwd, _ = _jit(name, dtype, jcfg)
    want = fwd(jp, toks)
    with serve_llm.RecordRoutes() as routes:
        got, aux = TM.forward_train(tp, tcfg, torch.from_numpy(toks).long())
    assert got.dtype == TC.COMPUTE_DTYPE and tuple(got.shape) == (B, S, jcfg.vocab_size)
    rel = _assert_logits(got, want, BAR[dtype], _flips(dtype, name, "forward", jcfg, routes))
    print(f"distance {name} {dtype} forward: {rel:.4e} of max|logit|")
    if not jcfg.moe:
        assert float(aux) == 0.0


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_jax(models, dtype, name):
    """8 teacher-forced serve_steps: logits, cache and pos every step."""
    jcfg, tcfg, jp, tp, toks = models[name]
    _take_jax_routes()
    _, step = _jit(name, dtype, jcfg)
    jc, tc = _jax_cache(jcfg, S), TM.init_cache(tcfg, B, S)
    wants, gots = [], []
    with serve_llm.RecordRoutes() as routes:
        for i in range(S):
            want, jc = step(jp, jc, toks[:, i:i + 1])
            got, tc = TM.serve_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]).long(), tcfg)
            wants.append(np.asarray(want, np.float32))
            gots.append(got)
            np.testing.assert_array_equal(tc.layers.pos.numpy(), np.asarray(jc.layers.pos))
            assert tc.layers.pos.dtype == torch.int32
    rel = _assert_logits(torch.cat(gots, 1), np.concatenate(wants, 1), BAR[dtype],
                         _flips(dtype, name, "decode", jcfg, routes))
    print(f"distance {name} {dtype} decode: {rel:.4e} of max|logit|")
    np.testing.assert_array_equal(tc.layers.pos.numpy(), np.full(jcfg.num_layers, S))
    if dtype == "f32":
        for a, b in zip(tree_leaves(tc.layers._asdict()),
                        jax.tree_util.tree_leaves(jc.layers._asdict())):
            b = np.asarray(b, np.float32)
            np.testing.assert_allclose(a.float().numpy(), b, rtol=0,
                                       atol=1e-5 * max(np.abs(b).max(), 1.0))


def _jax_decode(name, dtype, jcfg, jp, toks):
    """8 teacher-forced steps of the JAX package at ``dtype``: logits [B, S, V]."""
    _, step = _jit(name, dtype, jcfg)
    jc, out = _jax_cache(jcfg, S), []
    for i in range(S):
        logits, jc = step(jp, jc, toks[:, i:i + 1])
        out.append(np.asarray(logits, np.float32))
    return np.concatenate(out, 1)


@pytest.mark.parametrize("name", ARCHS)
def test_reference_bf16_distance_is_under_the_bar(models, monkeypatch, name):
    """The bf16 bar (2e-2 × max|logit|) sits above the JAX package's own
    bf16 rounding: its bf16 decode against its fp32 decode, same weights
    and tokens, printed (flips of near-ties left out, as against the port)."""
    jcfg, _, jp, _, toks = models[name]
    _take_jax_routes()
    bf16 = _jax_decode(name, "bf16", jcfg, jp, toks)
    bf16_routes = _take_jax_routes()
    with monkeypatch.context() as mp:
        mp.setattr(JC, "COMPUTE_DTYPE", jnp.float32)
        f32 = _jax_decode(name, "f32", jcfg, jp, toks)
    flipped, affected, not_ties = serve_llm.router_flips(
        bf16_routes, _take_jax_routes(), jcfg, B, S)
    assert not not_ties
    rel = _assert_logits(torch.from_numpy(bf16), f32, BAR["bf16"], affected)
    print(f"reference bf16 vs fp32 {name} decode: {rel:.4e} of max|logit|, "
          f"{len(flipped)} router flips")


def test_vlm_forward_with_patches(models, monkeypatch):
    """qwen2-vl with precomputed patch embeddings in front: M-RoPE's (t, h, w)
    grid for the patches, text after them (fp32)."""
    monkeypatch.setattr(JC, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TC, "COMPUTE_DTYPE", torch.float32)
    jcfg, tcfg, jp, tp, _ = models["qwen2-vl-2b"]
    rng = np.random.default_rng(7)
    s = jcfg.vision_patches + 6
    toks = rng.integers(0, jcfg.vocab_size, (B, s)).astype(np.int32)
    patches = rng.normal(size=(B, jcfg.vision_patches, jcfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, t, x: JM.forward_train(p, jcfg, t, {"patches": x}))(
        jp, toks, patches)
    got, _ = TM.forward_train(tp, tcfg, torch.from_numpy(toks).long(),
                              {"patches": torch.from_numpy(patches)})
    _assert_logits(got, want, BAR["f32"])


def test_rolling_window_cache_matches_jax(models, monkeypatch):
    """starcoder2 smoke with window=4 given to init_cache: 8 tokens wrap the
    4-slot buffer twice; logits and the buffer match the reference (fp32)."""
    monkeypatch.setattr(JC, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TC, "COMPUTE_DTYPE", torch.float32)
    jcfg, tcfg, jp, tp, toks = models["starcoder2-3b"]
    _, step = _jit("starcoder2-3b", "f32", jcfg, window=4)
    jc, tc = _jax_cache(jcfg, S, window=4), TM.init_cache(tcfg, B, S, window=4)
    assert tuple(tc.layers.k.shape) == tuple(jc.layers.k.shape) == (2, B, 4, 2, 32)
    for i in range(S):
        want, jc = step(jp, jc, toks[:, i:i + 1])
        got, tc = TM.serve_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]).long(),
                                tcfg, window=4)
        _assert_logits(got, want, BAR["f32"])
    for a, b in ((tc.layers.k, jc.layers.k), (tc.layers.v, jc.layers.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", JCFG.ARCH_NAMES)
def test_widths_without_allocating(name):
    """Full configs, all ten: the parameter count from the meta device
    equals the reference's (jax.eval_shape); init_cache's shapes and dtypes
    (its layers and its extra caches) equal the reference's at batch 1,
    length 16, and MLA's cache is latent-sized."""
    jcfg, tcfg = JCFG.get_arch(name), TCFG.get_arch(name)
    assert tcfg == ArchConfig(**{f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__})
    assert tcfg.param_count() == jcfg.param_count()
    jc = jax.eval_shape(lambda: JM.init_cache(jcfg, 1, 16))
    tc = TM.init_cache(tcfg, 1, 16, device="meta")
    jl, tl = jax.tree_util.tree_leaves(jc), tree_leaves(tc)
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    assert [str(t.dtype).split(".")[-1] for t in tl] == [str(j.dtype) for j in jl]
    if tcfg.mla is not None:
        assert tuple(tc.layers.c_kv.shape) == (tcfg.num_layers, 1, 16, tcfg.mla.kv_lora)
        assert tuple(tc.layers.k_pe.shape) == (tcfg.num_layers, 1, 16, tcfg.mla.rope_dim)


def test_configs_copied_verbatim():
    """All ten architectures, full and smoke, field for field (the module
    configs of MoE, MLA, Mamba2 and xLSTM as tuples)."""
    nested = ("moe", "mla", "mamba", "xlstm")
    for name in JCFG.ARCH_NAMES:
        for get in ("get_arch", "get_smoke_arch"):
            j, t = getattr(JCFG, get)(name), getattr(TCFG, get)(name)
            assert set(j.__dataclass_fields__) == set(t.__dataclass_fields__)
            for f in j.__dataclass_fields__:
                jv, tv = getattr(j, f), getattr(t, f)
                assert (tuple(jv) if f in nested and jv else jv) == \
                    (tuple(tv) if f in nested and tv else tv), (name, f)
    assert TCFG.ARCH_NAMES == JCFG.ARCH_NAMES
    assert TCFG.INPUT_SHAPES == {k: TCFG.InputShape(*v.__dict__.values())
                                 for k, v in JCFG.INPUT_SHAPES.items()}


def test_decode_matches_own_forward():
    """Every position's serve_step logits against forward_train, the port
    alone: bitwise-close at fp32, within the bf16 bar as shipped."""
    for name in ("tinyllama-1.1b", "deepseek-v2-lite-16b"):
        cfg = TCFG.get_smoke_arch(name)
        lm = serve_llm.build_lm(cfg, 3, "cpu")
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(3))
        dec = serve_llm.teacher_forced(lm.served, cfg, toks)
        full = serve_llm.full_forward(lm.served, cfg, toks)
        assert (dec - full).abs().max() <= BAR["bf16"] * full.abs().max()


def test_generate_repeats_and_cast_copy_is_exact():
    """The entry point's loop on the CPU: greedy tokens are the argmax of
    the step's logits, a second run is bitwise equal, and serving from the
    fp32 parameters (cast at every product) gives the same bits as the
    copy cast once."""
    cfg = TCFG.get_smoke_arch("granite-moe-1b-a400m")
    lm = serve_llm.build_lm(cfg, 1, "cpu")
    assert all(t.dtype == torch.float32 for t in tree_leaves(lm.params))
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(lm.served))
    prompts = torch.randint(0, cfg.vocab_size, (3, 5), generator=torch.Generator().manual_seed(1))
    a = serve_llm.generate(lm, prompts, 6)
    b = serve_llm.generate(lm, prompts, 6)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logits, b.logits)
    assert tuple(a.tokens.shape) == (3, 6) and tuple(a.logits.shape) == (3, 10, cfg.vocab_size)
    assert torch.equal(a.tokens[:, 1:], a.logits[:, 5:].argmax(-1))
    assert torch.equal(a.tokens[:, :1], a.logits[:, 4:5].argmax(-1))
    forced = torch.cat([prompts, a.tokens[:, :-1]], 1)
    assert torch.equal(serve_llm.teacher_forced(lm.params, cfg, forced), a.logits)


def test_entry_point_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_llm", "--smoke",
                        "--device", "cpu", "--gen", "6"],
                       capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("arch tinyllama-1.1b-smoke: 2L d=256 (reduced config)")
    assert lines[1].startswith("prefill 12 tok x 4 reqs")
    assert lines[2].startswith("decoded 6 tok x 4 reqs")
    assert [ln.split(":")[0] for ln in lines[3:]] == [f"req {b}" for b in range(4)]


def test_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve_llm.main(["--smoke"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve_llm.build_lm(TCFG.get_smoke_arch("tinyllama-1.1b"), 0, "cuda")


def test_router_flips_rules():
    """Synthetic routing, 3 layers, 1 sequence of 4 decode steps, top-2 of 4:
    a near-tie flip at layer 0, position 1 leaves out positions 1-3; a
    far-from-tie flip above it at layer 2, position 2 is explained by it;
    the same far flip with nothing below it is reported as no near-tie;
    a flip in the last layer leaves out only its own token."""
    cfg = TCFG.get_smoke_arch("granite-moe-1b-a400m")
    cfg = ArchConfig(**{**cfg.__dict__, "num_layers": 3})
    probs = torch.tensor([0.40, 0.30, 0.299, 0.001])        # 1 and 2 nearly tie

    def rec(flips):
        r = serve_llm.RecordRoutes()
        r.calls = []
        for s in range(4):                                  # decode: step-major
            for lay in range(3):
                r.calls.append((probs[None], torch.tensor([flips.get((lay, s), [0, 1])])))
        return r

    want = rec({})
    flipped, affected, bad = serve_llm.router_flips(rec({(0, 1): [0, 2], (2, 2): [0, 3]}),
                                                    want, cfg, 1, 4)
    assert flipped == {(0, 1), (0, 2)} and affected == {(0, 1), (0, 2), (0, 3)} and not bad
    _, _, bad = serve_llm.router_flips(rec({(2, 2): [0, 3]}), want, cfg, 1, 4)
    assert bad == [(2, 0, 2, [1], [3])]
    flipped, affected, _ = serve_llm.router_flips(rec({(2, 0): [0, 2]}), want, cfg, 1, 4)
    assert flipped == affected == {(0, 0)}
