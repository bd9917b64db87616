"""The port's LM building blocks against ``repro.models``' at fp32.

Each function of ``repro_torch.models.{common,attention,moe,mla}`` gets
the same fp32 inputs, drawn from a numpy seed, as its counterpart in the
JAX package (every reference function keeps its input dtype, so the
whole computation is fp32), and the outputs agree within rtol = atol =
1e-5: the two frameworks take their fp32 sums in other orders. The
router's selections agree exactly, ties included: ``lax.top_k`` puts the
lower expert first, and the port's stable sort must too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import common as JC
from repro.models import mla as JMLA
from repro.models import moe as JMOE

from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import mla as TMLA
from repro_torch.models import moe as TMOE
from repro_torch.utils.trees import param_count, tree_allclose, tree_bytes

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32), **(tol or TOL))


def _tparams(p):
    return {k: _tparams(v) if isinstance(v, dict) else _t(v) for k, v in p.items()}


def _jparams(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _jit(fn, *static):
    """The reference function compiled once: faster here than op by op."""
    return jax.jit(fn, static_argnums=static)


# ------------------------------------------------------------------ common


def test_rms_and_layer_norm():
    rng = _rng(0)
    x, s, b = _f32(rng, 3, 5, 64), _f32(rng, 64), _f32(rng, 64)
    _close(TC.rms_norm(_t(x), _t(s), 1e-6), JC.rms_norm(x, s, 1e-6))
    _close(TC.layer_norm(_t(x), _t(s), _t(b)), JC.layer_norm(x, s, b))


def test_rope_and_mrope():
    rng = _rng(1)
    x = _f32(rng, 2, 7, 4, 64)
    pos = rng.integers(0, 300, (2, 7)).astype(np.int32)
    _close(TC.apply_rope(_t(x), _t(pos), 500_000.0), JC.apply_rope(x, pos, 500_000.0))
    pos3 = rng.integers(0, 300, (3, 2, 7)).astype(np.int32)
    _close(TC.apply_mrope(_t(x), _t(pos3), (8, 12, 12), 1e6),
           JC.apply_mrope(x, pos3, (8, 12, 12), 1e6))
    # Text only: the three streams coincide and M-RoPE is RoPE.
    same = np.broadcast_to(pos, (3, 2, 7))
    _close(TC.apply_mrope(_t(x), _t(same), (8, 12, 12)), JC.apply_rope(x, pos))


def test_swiglu_gelu_mlp():
    rng = _rng(2)
    x = _f32(rng, 2, 3, 32)
    wg, wu, wd = _f32(rng, 32, 48, scale=0.2), _f32(rng, 32, 48, scale=0.2), \
        _f32(rng, 48, 32, scale=0.2)
    _close(TC.swiglu(_t(x), _t(wg), _t(wu), _t(wd)), JC.swiglu(x, wg, wu, wd))
    bi, bo = _f32(rng, 48), _f32(rng, 32)
    _close(TC.gelu_mlp(_t(x), _t(wg), _t(bi), _t(wd), _t(bo)),
           JC.gelu_mlp(x, wg, bi, wd, bo))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy(masked):
    rng = _rng(3)
    logits = _f32(rng, 2, 6, 50, scale=3.0)
    labels = rng.integers(0, 50, (2, 6)).astype(np.int32)
    mask = (rng.uniform(size=(2, 6)) < 0.6).astype(np.float32) if masked else None
    got = TC.cross_entropy(_t(logits), _t(labels), None if mask is None else _t(mask))
    _close(got, JC.cross_entropy(logits, labels, mask))


def test_init_shapes_and_trees():
    gen = torch.Generator().manual_seed(0)
    p = TC.init_swiglu(gen, 16, 24, lead=(3,))
    j = jax.eval_shape(lambda k: JC.init_swiglu(k, 16, 24), jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: (3,) + v.shape for k, v in j.items()}
    assert param_count(p) == 3 * 3 * 16 * 24 and tree_bytes(p) == 4 * param_count(p)
    assert tree_allclose(p, {k: v.clone() for k, v in p.items()})
    assert abs(float(p["w_up"].std()) - 0.02) < 2e-3
    meta = TC.init_gelu_mlp(None, 16, 24, device="meta")
    assert all(t.device.type == "meta" for t in meta.values())


# --------------------------------------------------------------- attention


@pytest.mark.parametrize("case", ["causal", "window", "kv_valid_len", "chunked_pad",
                                  "chunked_window"])
def test_sdpa_chunked(case):
    rng = _rng(4)
    sq = 21 if case.startswith("chunked") else 9
    q = _f32(rng, 2, sq, 4, 16)
    k, v = _f32(rng, 2, sq, 2, 16), _f32(rng, 2, sq, 2, 16)
    kw = dict(causal=case != "kv_valid_len")
    if "window" in case:
        kw["window"] = 5
    if case.startswith("chunked"):
        kw["q_chunk"] = 8                     # 21 = 2 * 8 + 5: padded to 24
    if case == "kv_valid_len":
        kw["kv_valid_len"] = 6
        kw["q_offset"] = 3
    tkw = dict(kw)
    if "kv_valid_len" in tkw:
        tkw["kv_valid_len"] = torch.tensor(kw["kv_valid_len"])
    got = TA.sdpa_chunked(_t(q), _t(k), _t(v), **tkw)
    _close(got, JA.sdpa_chunked(q, k, v, **kw))


def _attn_params(seed, d, cfg):
    return _jparams(_jit(JA.init_attention, 1, 2)(jax.random.PRNGKey(seed), d, cfg))


@pytest.mark.parametrize("bias,mrope", [(False, None), (True, (4, 6, 6))])
def test_attention_train_encoder_cross(bias, mrope):
    cfg = JA.AttnConfig(num_heads=4, num_kv_heads=2, head_dim=32, qkv_bias=bias,
                        mrope_sections=mrope)
    tcfg = TA.AttnConfig(*cfg)
    jp = _attn_params(5, 64, cfg)
    if bias:   # non-zero biases, so the bias path is checked
        rng = _rng(50)
        jp = {k: (_f32(rng, *v.shape) if k.startswith("b_") else v) for k, v in jp.items()}
    tp = _tparams(jp)
    rng = _rng(5)
    x = _f32(rng, 2, 6, 64)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    _close(TA.attention_train(tp, _t(x), _t(pos), tcfg),
           _jit(JA.attention_train, 3)(jp, x, pos, cfg))
    _close(TA.attention_encoder(tp, _t(x), tcfg), _jit(JA.attention_encoder, 2)(jp, x, cfg))
    ek, ev = _f32(rng, 2, 10, 2, 32), _f32(rng, 2, 10, 2, 32)
    _close(TA.cross_attention(tp, _t(x), _t(ek), _t(ev), tcfg),
           _jit(JA.cross_attention, 4)(jp, x, ek, ev, cfg))


def test_attention_decode_rolling_window_wrap():
    """A 4-slot rolling cache over 11 tokens wraps twice: outputs, K/V and
    pos agree at every step (fp32 cache)."""
    cfg = JA.AttnConfig(num_heads=4, num_kv_heads=2, head_dim=16, qkv_bias=True,
                        window=4)
    tcfg = TA.AttnConfig(*cfg)
    jp = _attn_params(6, 32, cfg)
    tp = _tparams(jp)
    jc = JA.init_kv_cache(2, 4, cfg, dtype=jnp.float32)
    tc = TA.init_kv_cache(2, 4, tcfg, dtype=torch.float32)
    rng = _rng(6)
    decode = _jit(JA.attention_decode, 3)
    for step in range(11):
        x = _f32(rng, 2, 1, 32)
        jo, jc = decode(jp, x, jc, cfg)
        to, tc = TA.attention_decode(tp, _t(x), tc, tcfg)
        _close(to, jo)
        _close(tc.k, jc.k)
        _close(tc.v, jc.v)
        assert int(tc.pos) == int(jc.pos) == step + 1
        assert tc.pos.dtype == torch.int32


# --------------------------------------------------------------------- moe


def _moe(cfg_kw, seed, d=32):
    cfg = JMOE.MoEConfig(**cfg_kw)
    jp = _jparams(_jit(JMOE.init_moe, 1, 2)(jax.random.PRNGKey(seed), d, cfg))
    return cfg, TMOE.MoEConfig(*cfg), jp


def _jax_route(jp, xt, cfg):
    probs = jax.nn.softmax((xt @ jp["router"]).astype(jnp.float32), axis=-1)
    return np.asarray(probs), np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])


def _check_moe(jp, x, cfg, tcfg):
    tp = _tparams(jp)
    jo, jaux = _jit(JMOE.moe_ffn, 2)(jp, x, cfg)
    to, taux = TMOE.moe_ffn(tp, _t(x), tcfg)
    _close(to, jo)
    _close(taux, jaux)
    xt = x.reshape(-1, x.shape[-1])
    probs, sel = _jax_route(jp, xt, cfg)
    tprobs, _, tsel = TMOE.route(tp, _t(xt), tcfg)
    np.testing.assert_array_equal(tsel.numpy(), sel)
    return probs, sel


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_ffn(shared):
    cfg, tcfg, jp = _moe(dict(num_experts=4, top_k=2, d_ff_expert=24,
                              num_shared=shared), 7)
    jp["router"] = _f32(_rng(70), 32, 4)        # a router that spreads tokens
    _check_moe(jp, _f32(_rng(7), 2, 5, 32), cfg, tcfg)


@pytest.mark.parametrize("k", [2, 3])
def test_moe_router_ties_keep_lax_top_k_order(k):
    """Experts 1, 2 and 4 have the same router column, so every token's
    probabilities tie exactly among them: ``lax.top_k`` takes them lowest
    index first (``[1, 2]``, ``[1, 2, 4]``), and so must the port."""
    cfg, tcfg, jp = _moe(dict(num_experts=6, top_k=k, d_ff_expert=16), 8)
    rng = _rng(8)
    x = np.abs(_f32(rng, 1, 6, 32)) + 0.1
    col = np.abs(_f32(rng, 32)) + 0.5
    router = -np.abs(_f32(rng, 32, 6))
    router[:, [1, 2, 4]] = col[:, None]
    jp["router"] = router
    probs, sel = _check_moe(jp, x, cfg, tcfg)
    assert (probs[:, 1] == probs[:, 2]).all() and (probs[:, 2] == probs[:, 4]).all()
    np.testing.assert_array_equal(sel, np.tile([1, 2, 4][:k], (6, 1)))
    tprobs = TMOE.route(_tparams(jp), _t(x.reshape(6, 32)), tcfg)[0]
    assert (tprobs[:, 1] == tprobs[:, 2]).all() and (tprobs[:, 2] == tprobs[:, 4]).all()


def test_moe_capacity_overflow():
    """64 tokens, all routed to expert 0 first (capacity 16): 48 of their
    top-1 assignments overflow and drop, as in the reference."""
    cfg, tcfg, jp = _moe(dict(num_experts=4, top_k=2, d_ff_expert=16,
                              capacity_factor=0.5, num_shared=1), 9)
    rng = _rng(9)
    x = np.abs(_f32(rng, 4, 16, 32)) + 0.1
    router = -np.abs(_f32(rng, 32, 4))
    router[:, 0] = 1.0
    jp["router"] = router
    probs, sel = _check_moe(jp, x, cfg, tcfg)
    assert JMOE._capacity(64, cfg) == TMOE._capacity(64, tcfg) == 16
    assert (sel[:, 0] == 0).all()


# --------------------------------------------------------------------- mla


def _mla():
    cfg = JMLA.MLAConfig(num_heads=4, head_dim=16, rope_dim=8, kv_lora=24,
                         v_head_dim=12)
    jp = _jparams(_jit(JMLA.init_mla, 1, 2)(jax.random.PRNGKey(10), 48, cfg))
    return cfg, TMLA.MLAConfig(*cfg), jp


@pytest.mark.parametrize("q_chunk", [512, 4])
def test_mla_train(q_chunk):
    cfg, tcfg, jp = _mla()
    x = _f32(_rng(10), 2, 7, 48)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    _close(TMLA.mla_train(_tparams(jp), _t(x), _t(pos), tcfg, q_chunk),
           _jit(JMLA.mla_train, 3, 4)(jp, x, pos, cfg, q_chunk))


def test_mla_decode():
    """Absorbed decode over a latent cache of 6 slots, 6 steps; the cache
    holds kv_lora + rope_dim per token, nothing per head."""
    cfg, tcfg, jp = _mla()
    tp = _tparams(jp)
    jc = JMLA.init_mla_cache(2, 6, cfg, dtype=jnp.float32)
    tc = TMLA.init_mla_cache(2, 6, tcfg, dtype=torch.float32)
    assert tuple(tc.c_kv.shape) == (2, 6, 24) and tuple(tc.k_pe.shape) == (2, 6, 8)
    rng = _rng(11)
    decode = _jit(JMLA.mla_decode, 3)
    for step in range(6):
        x = _f32(rng, 2, 1, 48)
        jo, jc = decode(jp, x, jc, cfg)
        to, tc = TMLA.mla_decode(tp, _t(x), tc, tcfg)
        _close(to, jo)
        _close(tc.c_kv, jc.c_kv)
        _close(tc.k_pe, jc.k_pe)
        assert int(tc.pos) == int(jc.pos) == step + 1
