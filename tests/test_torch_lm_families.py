"""LM serving of the hybrid, ssm and audio families in the port against
``repro.models``, whole model, smoke configs.

zamba2 (Mamba2 blocks and a shared attention block every ``attn_every``
layers), xLSTM (groups of mLSTM blocks and one sLSTM block) and Whisper
(encoder, decoder with cross-attention): the same parameters
(``repro_torch.parity.lm_params_from_jax``) and the same tokens (a numpy
seed) go through ``forward_train`` and 8 teacher-forced ``serve_step``s
of both packages:

- fp32 (both packages' ``COMPUTE_DTYPE`` patched to float32): logits
  within 1e-5 × max|logit|, every cache leaf within 1e-5 × its max;
- bf16, as shipped: within ``serve_llm.bf16_bar`` × max|logit| (2e-2;
  zamba2's smoke config 5e-2, about twice the reference's own bf16-vs-fp32
  distance, which ``test_reference_distances_are_under_the_bars``
  measures and prints).

The reference's K/V caches are bf16 whatever ``COMPUTE_DTYPE`` (its
``init_kv_cache`` binds the dtype at import), so at fp32 the JAX cache's
bf16 leaves are cast; its recurrent states are fp32 in both dtypes, as the
port's. Whisper is served with the reference's zero cross K/V, and again
with the cross K/V of frames (the port's ``encode_cross_kv``; the
reference's are computed the way its ``forward_train`` does, by
``lm_reference_distances.jax_cross_kv``, the script that measures the
reference's own distances at deeper configs). Then the
layouts (caches, parameter trees, full configs on the meta device), the
cast copy, and the entry point.
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

from repro_torch import configs as TCFG
from repro_torch import models as TM
from repro_torch.launch import serve_llm
from repro_torch.models import common as TC
from repro_torch.parity import lm_params_from_jax
from repro_torch.utils.trees import tree_leaves

from lm_reference_distances import jax_cross_kv

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["zamba2-2.7b", "xlstm-350m", "whisper-small"]
B, S = 2, 8
_JITS = {}


@pytest.fixture(scope="module")
def models():
    """name -> (JAX cfg, port cfg, JAX params as numpy, port params, tokens,
    frames or None)."""
    out = {}
    for name in ARCHS:
        jcfg, tcfg = JCFG.get_smoke_arch(name), TCFG.get_smoke_arch(name)
        jp = jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda k, c=jcfg: JM.init_params(k, c))(jax.random.PRNGKey(1)))
        rng = np.random.default_rng(0)
        toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        frames = (rng.normal(size=(B, jcfg.enc_frames, jcfg.d_model)).astype(np.float32)
                  if jcfg.family == "audio" else None)
        out[name] = (jcfg, tcfg, jp, lm_params_from_jax(jp), toks, frames)
    return out


def _f32(monkeypatch):
    monkeypatch.setattr(JC, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TC, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture(params=["f32", "bf16"])
def dtype(request, monkeypatch):
    if request.param == "f32":
        _f32(monkeypatch)
    return request.param


def _bar(dtype, cfg) -> float:
    return serve_llm.FP32_BAR if dtype == "f32" else serve_llm.bf16_bar(cfg)


def _jit(name, dtype, jcfg):
    """One jitted JAX forward, serve_step and cross K/V per (config, dtype):
    ``COMPUTE_DTYPE`` is read while tracing, so it is part of the key."""
    key = (name, dtype)
    if key not in _JITS:
        _JITS[key] = (jax.jit(lambda p, t, e: JM.forward_train(p, jcfg, t, e)[0]),
                      jax.jit(lambda p, c, t: JM.serve_step(p, c, t, jcfg)),
                      jax.jit(lambda p, f: jax_cross_kv(p, jcfg, f)))
    return _JITS[key]


def _extra(frames):
    return None if frames is None else {"frames": frames}


def _jax_decode(name, dtype, jcfg, jp, toks, frames=None):
    """8 teacher-forced JAX steps: (logits [B, S, V], final cache); the
    cross K/V of ``frames`` if given."""
    _, step, cross = _jit(name, dtype, jcfg)
    jc = jax.tree_util.tree_map(
        lambda a: a.astype(JC.COMPUTE_DTYPE) if a.dtype == jnp.bfloat16 else a,
        JM.init_cache(jcfg, B, S))
    if frames is not None:
        k, v = cross(jp, frames)
        jc = jc._replace(extra={"k": k, "v": v})
    out = []
    for i in range(S):
        logits, jc = step(jp, jc, toks[:, i:i + 1])
        out.append(np.asarray(logits, np.float32))
    return np.concatenate(out, 1), jc


def _port_decode(tcfg, tp, toks, frames=None):
    tc = serve_llm.with_frames(tp, tcfg, TM.init_cache(tcfg, B, S),
                               None if frames is None else torch.from_numpy(frames))
    out = []
    for i in range(S):
        logits, tc = TM.serve_step(tp, tc, torch.from_numpy(toks[:, i:i + 1]).long(), tcfg)
        out.append(logits)
    return torch.cat(out, 1), tc


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_cache(tc, jc, bar):
    """Leaf for leaf: the same dtype, and (unless ``bar`` is None) within
    ``bar`` × the leaf's max (``pos`` exactly)."""
    tl, jl = tree_leaves(tc), jax.tree_util.tree_leaves(jc)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        if bar is None:
            continue
        b = np.asarray(b.astype(jnp.float32) if b.dtype == jnp.bfloat16 else b)
        if b.dtype == np.int32:
            np.testing.assert_array_equal(a.numpy(), b)
            continue
        err = np.abs(a.float().numpy() - b).max()
        assert err <= bar * np.abs(b).max(), (err, np.abs(b).max())


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_jax(models, dtype, name):
    jcfg, tcfg, jp, tp, toks, frames = models[name]
    want = _jit(name, dtype, jcfg)[0](jp, toks, _extra(frames))
    got, aux = TM.forward_train(tp, tcfg, torch.from_numpy(toks).long(),
                                _extra(None if frames is None else torch.from_numpy(frames)))
    assert got.dtype == TC.COMPUTE_DTYPE and tuple(got.shape) == (B, S, jcfg.vocab_size)
    assert float(aux) == 0.0
    rel = _rel(got, want)
    print(f"distance {name} {dtype} forward: {rel:.4e} of max|logit|")
    assert rel <= _bar(dtype, tcfg)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_jax(models, dtype, name):
    """8 teacher-forced serve_steps from the reference's cache (whisper's
    cross K/V zero): logits; the whole cache at fp32, its dtypes always."""
    jcfg, tcfg, jp, tp, toks, _ = models[name]
    want, jc = _jax_decode(name, dtype, jcfg, jp, toks)
    got, tc = _port_decode(tcfg, tp, toks)
    rel = _rel(got, want)
    print(f"distance {name} {dtype} decode: {rel:.4e} of max|logit|")
    assert rel <= _bar(dtype, tcfg)
    _assert_cache(tc, jc, serve_llm.FP32_BAR if dtype == "f32" else None)


def test_whisper_decode_with_encoded_frames(models, dtype):
    """The cross K/V of frames: the port's ``encode_cross_kv`` against the
    reference's forward arithmetic, 8 steps served from them against the
    reference served from its own, and against the reference's forward
    over the same frames (which attends to the same K/V)."""
    name = "whisper-small"
    jcfg, tcfg, jp, tp, toks, frames = models[name]
    bar = _bar(dtype, tcfg)
    fwd, _, cross = _jit(name, dtype, jcfg)
    for got, want in zip(TM.encode_cross_kv(tp, tcfg, torch.from_numpy(frames)),
                         cross(jp, frames)):
        assert got.dtype == TC.COMPUTE_DTYPE and tuple(got.shape) == want.shape
        assert _rel(got, np.asarray(want.astype(jnp.float32))) <= bar
    want, jc = _jax_decode(name, dtype, jcfg, jp, toks, frames)
    got, tc = _port_decode(tcfg, tp, toks, frames)
    rel = _rel(got, want)
    rel_fwd = _rel(got, fwd(jp, toks, {"frames": frames}))
    print(f"distance {name} {dtype} decode with frames: {rel:.4e} of max|logit|; "
          f"against the reference's forward: {rel_fwd:.4e}")
    assert rel <= bar and rel_fwd <= bar
    _assert_cache(tc, jc, serve_llm.FP32_BAR if dtype == "f32" else None)


@pytest.mark.parametrize("name", ARCHS)
def test_reference_distances_are_under_the_bars(models, monkeypatch, name):
    """The bars of the bf16 comparisons, measured on the reference: its
    decode against its forward at fp32 (under 1e-5) and at bf16, and its
    bf16 logits against its fp32 logits (forward and decode), each under
    the family's bf16 bar; printed. Whisper decodes from frames here."""
    jcfg, tcfg, jp, _, toks, frames = models[name]
    out = {}
    for dt in ("bf16", "f32"):
        if dt == "f32":
            _f32(monkeypatch)
        fwd = np.asarray(_jit(name, dt, jcfg)[0](jp, toks, _extra(frames)), np.float32)
        out[dt] = fwd, _jax_decode(name, dt, jcfg, jp, toks, frames)[0]
    d = {"decode vs forward f32": _rel(out["f32"][1], out["f32"][0]),
         "decode vs forward bf16": _rel(out["bf16"][1], out["bf16"][0]),
         "bf16 vs f32 forward": _rel(out["bf16"][0], out["f32"][0]),
         "bf16 vs f32 decode": _rel(out["bf16"][1], out["f32"][1])}
    print(f"reference {name}: " + "; ".join(f"{k} {v:.4e}" for k, v in d.items()))
    assert d.pop("decode vs forward f32") <= serve_llm.FP32_BAR
    assert max(d.values()) <= serve_llm.bf16_bar(tcfg)


@pytest.mark.parametrize("name", ARCHS)
def test_cache_layout_matches_reference(name):
    """The smoke config's fresh cache, as shipped (bf16): every leaf's
    shape, dtype and value (zeros, the stabilizers' -30) equal the
    reference's ``init_cache``."""
    jc = JM.init_cache(JCFG.get_smoke_arch(name), B, S)
    tc = TM.init_cache(TCFG.get_smoke_arch(name), B, S)
    tl, jl = tree_leaves(tc), jax.tree_util.tree_leaves(jc)
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in tl] == \
        [(j.shape, str(j.dtype)) for j in jl]
    for t, j in zip(tl, jl):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))


@pytest.mark.parametrize("name", ARCHS)
def test_full_config_layout_without_allocating(name):
    """Full configs on the meta device: every parameter leaf's path and
    shape and ``init_cache``'s leaves (batch 1, length 16) equal the
    reference's under ``jax.eval_shape``."""
    jcfg, tcfg = JCFG.get_arch(name), TCFG.get_arch(name)
    jp = jax.eval_shape(lambda k: JM.init_params(k, jcfg), jax.random.PRNGKey(0))
    tp = TM.init_params(None, tcfg, "meta")
    assert _paths(tp) == {p: s.shape for p, s in _jax_paths(jp).items()}
    assert tcfg.param_count() == jcfg.param_count()
    jc = jax.eval_shape(lambda: JM.init_cache(jcfg, 1, 16))
    tc = TM.init_cache(tcfg, 1, 16, device="meta")
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in tree_leaves(tc)] == \
        [(j.shape, str(j.dtype)) for j in jax.tree_util.tree_leaves(jc)]


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items() for p, s in _paths(v, prefix + (k,)).items()}
    return {prefix: tuple(tree.shape)}


def _jax_paths(tree):
    return {tuple(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_lm_params_from_jax_carries_the_nested_trees(models):
    """zamba2's ``shared_attn``, xLSTM's ``blocks["mlstm"]`` [G, g-1, ...]
    (a nested ``vmap``) and ``blocks["slstm"]`` [G, ...], Whisper's
    ``enc_blocks``, ``enc_pos`` and ``enc_norm``: every leaf carried under
    its path, bitwise, in the layout the port's ``init_params`` builds."""
    for name in ARCHS:
        jcfg, tcfg, jp, tp, _, _ = models[name]
        jl = _jax_paths(jp)
        tl = {p: t for p, t in _leaves_by_path(tp).items()}
        assert set(tl) == set(jl)
        for p, t in tl.items():
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), jl[p])
        assert _paths(TM.init_params(None, tcfg, "meta")) == \
            {p: tuple(t.shape) for p, t in tl.items()}
    g = JCFG.get_smoke_arch("xlstm-350m")
    mlstm = models["xlstm-350m"][3]["blocks"]["mlstm"]["w_q"]
    assert tuple(mlstm.shape)[:2] == (g.num_layers // g.xlstm_group, g.xlstm_group - 1)
    assert "shared_attn" in models["zamba2-2.7b"][3]
    assert {"enc_blocks", "enc_pos", "enc_norm"} <= set(models["whisper-small"][3])


def _leaves_by_path(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: t for k, v in tree.items()
                for p, t in _leaves_by_path(v, prefix + (k,)).items()}
    return {prefix: tree}


@pytest.mark.parametrize("name", ARCHS)
def test_generate_repeats_and_cast_copy_is_exact(name):
    """The entry point's loop on the CPU: a second run is bitwise equal, and
    serving from the fp32 parameters (cast at every product) gives the same
    bits as the copy cast once, whose ``FP32_PARAMS`` stay fp32. Whisper
    decodes against frames."""
    cfg = TCFG.get_smoke_arch(name)
    lm = serve_llm.build_lm(cfg, 1, "cpu")
    for path, t in _leaves_by_path(lm.served).items():
        keep = path[-1] in serve_llm.FP32_PARAMS
        assert t.dtype == (torch.float32 if keep else torch.bfloat16), path
    prompts = torch.randint(0, cfg.vocab_size, (3, 5), generator=torch.Generator().manual_seed(1))
    frames = serve_llm.draw_frames(cfg, 3, 1) if cfg.family == "audio" else None
    a = serve_llm.generate(lm, prompts, 4, frames)
    b = serve_llm.generate(lm, prompts, 4, frames)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logits, b.logits)
    assert torch.equal(a.tokens[:, 1:], a.logits[:, 5:].argmax(-1))
    forced = torch.cat([prompts, a.tokens[:, :-1]], 1)
    assert torch.equal(serve_llm.teacher_forced(lm.params, cfg, forced, frames), a.logits)


def test_frames_are_required():
    cfg = TCFG.get_smoke_arch("whisper-small")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="frames"):
        TM.forward_train(params, cfg, torch.zeros((1, 2), dtype=torch.long))
    with pytest.raises(ValueError, match="takes no frames"):
        xcfg = TCFG.get_smoke_arch("xlstm-350m")
        serve_llm.with_frames({}, xcfg, TM.init_cache(xcfg, 1, 2), torch.zeros(1))


def test_entry_point_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve_llm", "--smoke",
                        "--arch", "xlstm-350m", "--device", "cpu", "--gen", "6"],
                       capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("arch xlstm-350m-smoke: 2L d=256 (reduced config)")
    assert lines[1].startswith("prefill 12 tok x 4 reqs")
    assert lines[2].startswith("decoded 6 tok x 4 reqs")
    assert [ln.split(":")[0] for ln in lines[3:]] == [f"req {b}" for b in range(4)]
