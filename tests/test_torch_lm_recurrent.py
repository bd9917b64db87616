"""The port's recurrent LM blocks against ``repro.models``' at fp32.

``repro_torch.models.mamba2`` (Mamba-2: the chunked SSD forward, the
one-token recurrence) and ``repro_torch.models.xlstm`` (mLSTM in its
parallel and recurrent forms, sLSTM as a loop over time steps) get the
same fp32 inputs, drawn from a numpy seed, and the same parameters as
their counterparts in the JAX package. Outputs (for the residual xLSTM blocks,
their update: the output less the input) and every cache leaf agree
within 1e-5 × max|reference| (the two frameworks take their fp32 sums in
other orders). The reference's init sets ``A_log``, ``D`` and
``dt_bias`` to 0, 1 and 0; the tests draw them, so their use is checked.

The decode caches are fp32 whatever the activations' dtype: with bf16
activations the conv runs in fp32 on the concatenated state, and the
products that follow it are fp32 (JAX promotes ``f32 @ bf16``). Those
tests hold the dtypes exactly and the values within 2e-2 × max (bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as JMB
from repro.models import xlstm as JXL

from repro_torch.models import mamba2 as TMB
from repro_torch.models import xlstm as TXL
from repro_torch.utils.trees import tree_leaves

TOL = 1e-5       # × max|reference|, fp32
BF16 = 2e-2      # × max|reference|, bf16 activations

MCFG = JMB.MambaConfig(d_inner=64, head_dim=16, state_dim=8, chunk=16)
XCFG = JXL.XLSTMConfig(d_model=32, num_heads=4, q_chunk=8, slstm_chunk=4)
D_MODEL = 32
_JITS = {}


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, bar=TOL):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= bar * max(np.abs(want).max(), 1e-30), (err, np.abs(want).max())


def _close_tree(got, want, bar=TOL):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        _close(g, w, bar)


def _tparams(p):
    return {k: _t(v) for k, v in p.items()}


def _jit(fn, *static):
    """The reference function compiled once per test process."""
    key = (fn, static)
    if key not in _JITS:
        _JITS[key] = jax.jit(fn, static_argnums=static)
    return _JITS[key]


def _mamba_params():
    jp = jax.tree_util.tree_map(np.asarray, _jit(JMB.init_mamba, 1, 2)(
        jax.random.PRNGKey(0), D_MODEL, MCFG))
    rng = _rng(100)
    h = MCFG.num_heads
    jp.update(A_log=_f32(rng, h, scale=0.5), D=_f32(rng, h),
              dt_bias=_f32(rng, h, scale=0.5), norm_scale=1 + _f32(rng, 64, scale=0.1))
    return jp


# ------------------------------------------------------------------ mamba2


def test_causal_conv_fp32_state_under_bf16_input():
    """Without a state the conv keeps the input's dtype; a fp32 state
    concatenated with bf16 input promotes the conv, its SiLU and the new
    state to fp32, as JAX does."""
    rng = _rng(1)
    w = _f32(rng, 4, 24, scale=0.5)
    x = _f32(rng, 2, 7, 24)
    got, gs = TMB._causal_conv(_t(x), _t(w))
    want, ws = JMB._causal_conv(x, w)
    _close(got, want)
    _close(gs, ws)
    xb = jnp.asarray(x[:, :1], jnp.bfloat16)
    state = _f32(rng, 2, 3, 24)
    want, ws = JMB._causal_conv(xb, w, state)
    got, gs = TMB._causal_conv(_t(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                               _t(w), _t(state))
    assert want.dtype == ws.dtype == jnp.float32
    assert got.dtype == gs.dtype == torch.float32
    _close(got, want)
    _close(gs, ws)


@pytest.mark.parametrize("seq", [24, 9])
def test_mamba_train(seq):
    """24 tokens at chunk 16 shrink the chunk to 12 (two chunks carry the
    state); 9 tokens are one chunk of 9."""
    jp = _mamba_params()
    x = _f32(_rng(2), 2, seq, D_MODEL)
    _close(TMB.mamba_train(_tparams(jp), _t(x), MCFG),
           _jit(JMB.mamba_train, 2)(jp, x, MCFG))


def test_mamba_decode_over_a_sequence():
    """8 one-token steps from the empty cache: outputs, state and conv state
    every step."""
    jp = _mamba_params()
    tp = _tparams(jp)
    jc, tc = JMB.init_mamba_cache(2, MCFG), TMB.init_mamba_cache(2, MCFG)
    _close_tree(tc, jc)
    rng = _rng(3)
    step = _jit(JMB.mamba_decode, 3)
    for _ in range(8):
        x = _f32(rng, 2, 1, D_MODEL)
        jo, jc = step(jp, x, jc, MCFG)
        to, tc = TMB.mamba_decode(tp, _t(x), tc, MCFG)
        _close(to, jo)
        _close_tree(tc, jc)


# ------------------------------------------------------------------- mlstm


def _mlstm_params(strong_gates=False):
    """The init's parameters; ``strong_gates`` scales the conv by 50 and the
    gate weights by 3000, which drives the log gates to tens and hundreds."""
    jp = jax.tree_util.tree_map(np.asarray, _jit(JXL.init_mlstm_block, 1)(
        jax.random.PRNGKey(4), XCFG))
    if strong_gates:
        jp["conv_w"] = jp["conv_w"] * np.float32(50.0)
        jp["w_if"] = jp["w_if"] * np.float32(3000.0)
    return jp


@pytest.mark.parametrize("seq,strong", [(24, False), (6, False), (24, True)])
def test_mlstm_train(seq, strong):
    """24 tokens take the chunked branch (3 query chunks of 8), 6 the
    unchunked one. With strong gates some rows' stabilizer sits on the -30
    floor: the first position's is its own input gate, below -30."""
    jp = _mlstm_params(strong)
    x = _f32(_rng(4), 2, seq, D_MODEL)
    if strong:
        u = (JXL.C.rms_norm(x, jp["ln_scale"]) @ jp["w_up"])[..., :2 * D_MODEL]
        ilog = np.asarray(JXL._conv_silu(u, jp["conv_w"])[0] @ jp["w_if"])
        assert (ilog[:, 0, :XCFG.num_heads] < -30).any()
    _close(TXL.mlstm_block_train(_tparams(jp), _t(x), XCFG) - _t(x),
           _jit(JXL.mlstm_block_train, 2)(jp, x, XCFG) - x)


def test_mlstm_decode_over_a_sequence():
    """8 steps from the empty cache (stabilizer m at -30): outputs and the
    matrix memory, normalizer, stabilizer and conv state every step."""
    jp = _mlstm_params()
    tp = _tparams(jp)
    jc, tc = JXL.init_mlstm_cache(2, XCFG), TXL.init_mlstm_cache(2, XCFG)
    _close_tree(tc, jc)
    rng = _rng(5)
    step = _jit(JXL.mlstm_block_decode, 3)
    for _ in range(8):
        x = _f32(rng, 2, 1, D_MODEL)
        jo, jc = step(jp, x, jc, XCFG)
        to, tc = TXL.mlstm_block_decode(tp, _t(x), tc, XCFG)
        _close(to - _t(x), jo - x)        # the block's update
        _close_tree(tc, jc)


# ------------------------------------------------------------------- slstm


def _slstm_params():
    """The init's parameters, the MLP's up-projection 25 times larger, so
    its GELU sees inputs of order 1 (where tanh's approximation shows)."""
    jp = jax.tree_util.tree_map(np.asarray, _jit(JXL.init_slstm_block, 1)(
        jax.random.PRNGKey(6), XCFG))
    jp["w_mlp_up"] = jp["w_mlp_up"] * np.float32(25.0)
    return jp


def test_slstm_train_and_scan():
    """12 tokens: the reference's two-level scan (3 chunks of 4 steps under
    ``jax.checkpoint``) against the port's plain loop, the block and the
    scan's final state."""
    jp = _slstm_params()
    tp = _tparams(jp)
    rng = _rng(6)
    x = _f32(rng, 2, 12, D_MODEL)
    _close(TXL.slstm_block_train(tp, _t(x), XCFG) - _t(x),
           _jit(JXL.slstm_block_train, 2)(jp, x, XCFG) - x)
    gx = _f32(rng, 2, 12, 4 * D_MODEL)
    jh, js = _jit(JXL.slstm_scan, 1)(jp, XCFG, gx, JXL.init_slstm_state(2, D_MODEL))
    th, ts = TXL.slstm_scan(tp, XCFG, _t(gx), TXL.init_slstm_state(2, D_MODEL))
    _close(th, jh)
    _close_tree(ts, js)


def test_slstm_decode_over_a_sequence():
    jp = _slstm_params()
    tp = _tparams(jp)
    jc, tc = JXL.init_slstm_cache(2, XCFG), TXL.init_slstm_cache(2, XCFG)
    _close_tree(tc, jc)
    rng = _rng(7)
    step = _jit(JXL.slstm_block_decode, 3)
    for _ in range(8):
        x = _f32(rng, 2, 1, D_MODEL)
        jo, jc = step(jp, x, jc, XCFG)
        to, tc = TXL.slstm_block_decode(tp, _t(x), tc, XCFG)
        _close(to - _t(x), jo - x)        # the block's update
        _close_tree(tc, jc)


# -------------------------------------------- bf16 activations, fp32 caches


def test_decode_products_promote_as_jax():
    """An fp32 activation (decode's conv output) times a weight cast to
    bf16: JAX promotes the product to fp32, which ``_proj`` does by
    widening the rounded weight, not by rounding the activation."""
    rng = _rng(9)
    a, w = _f32(rng, 2, 1, 48), _f32(rng, 48, 40)
    want = a @ jnp.asarray(w).astype(jnp.bfloat16)
    got = TXL._proj(_t(a), _t(w), torch.bfloat16)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want)
    ab = torch.from_numpy(a).bfloat16()
    assert TXL._proj(ab, _t(w), torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("block", ["mamba", "mlstm", "slstm"])
def test_bf16_decode_keeps_fp32_caches(block):
    """4 decode steps with bf16 activations (bf16 weights where the
    reference casts them; ``A_log``, ``D``, ``dt_bias`` and ``r_gates``
    stay fp32, as the reference reads them): the output is bf16, every
    cache leaf stays fp32 in both packages, and the values agree within
    the bf16 bar."""
    jp, init, jstep, tstep, cfg = {
        "mamba": (_mamba_params(), JMB.init_mamba_cache, JMB.mamba_decode,
                  TMB.mamba_decode, MCFG),
        "mlstm": (_mlstm_params(), JXL.init_mlstm_cache, JXL.mlstm_block_decode,
                  TXL.mlstm_block_decode, XCFG),
        "slstm": (_slstm_params(), JXL.init_slstm_cache, JXL.slstm_block_decode,
                  TXL.slstm_block_decode, XCFG),
    }[block]
    tinit = {"mamba": TMB.init_mamba_cache, "mlstm": TXL.init_mlstm_cache,
             "slstm": TXL.init_slstm_cache}[block]
    tp = _tparams(jp)
    jc, tc = init(2, cfg), tinit(2, cfg)
    rng = _rng(8)
    step = _jit(jstep, 3)
    for _ in range(4):
        x = jnp.asarray(_f32(rng, 2, 1, D_MODEL), jnp.bfloat16)
        jo, jc = step(jp, x, jc, cfg)
        to, tc = tstep(tp, _t(np.asarray(x.astype(jnp.float32))).bfloat16(), tc, cfg)
        assert jo.dtype == jnp.bfloat16 and to.dtype == torch.bfloat16
        assert all(a.dtype == jnp.float32 for a in jax.tree_util.tree_leaves(jc))
        _close(to, np.asarray(jo.astype(jnp.float32)), BF16)
        _close_tree(tc, jc, BF16)
