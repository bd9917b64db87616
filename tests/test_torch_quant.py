"""The port's quantization against the JAX package: ``quant.stochastic`` with
replayed uniforms (bitwise), the plain ``quant_pack_ref`` /
``dequant_unpack_ref`` against the JAX oracles (bitwise) and the Pallas pair
in interpret mode (within the last bit of the scale, ROADMAP C-ref2), and
the ragged feature widths the port packs that the JAX package refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import quant_pack as jqp
from repro.kernels import ref as jref
from repro.quant import stochastic as jst

from repro_torch.kernels import quant_pack as tqp
from repro_torch.kernels import ref as tref
from repro_torch.quant import stochastic as tst

BITS = (2, 4, 8)


def _inputs(rows, feat, seed):
    """Gaussian rows with one constant 4-row group (an empty range)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, feat)).astype(np.float32)
    x[4:8] = 0.5
    return x


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("feat", [100, 256, 47, 16])
def test_quantize_matches_reference_bitwise(bits, feat):
    x = _inputs(64, feat, bits * 1000 + feat)
    key = jax.random.PRNGKey(bits * 7 + feat)
    qj, pj = jst.quantize(jnp.asarray(x), bits, key)
    u = np.asarray(jax.random.uniform(key, (16, 4, feat), dtype=jnp.float32))
    qt, pt = tst.quantize(_t(x), bits, _t(u))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(pt.zero.numpy(), np.asarray(pj.zero))
    np.testing.assert_array_equal(pt.scale.numpy(), np.asarray(pj.scale))
    np.testing.assert_array_equal(tst.dequantize(qt, pt).numpy(),
                                  np.asarray(jst.dequantize(qj, pj)))
    if feat % (32 // bits) == 0:
        np.testing.assert_array_equal(tst.pack_bits(qt, bits).numpy(),
                                      np.asarray(jst.pack_bits(qj, bits)))
    packed, params = tst.quantize_packed(_t(x), bits, _t(u))
    np.testing.assert_array_equal(
        tst.dequantize_packed(packed, params, bits, feat).numpy(),
        np.asarray(jst.dequantize(qj, pj)))
    assert tst.wire_bytes(64, feat, bits) == jst.wire_bytes(64, feat, bits)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("feat", [256, 32])
def test_plain_pair_matches_jax_oracle_bitwise(bits, feat):
    x = _inputs(128, feat, feat + bits)
    u = np.random.default_rng(bits).uniform(size=x.shape).astype(np.float32)
    pj, zj, sj = jref.quant_pack_ref(jnp.asarray(x), jnp.asarray(u), bits)
    pt, zt, st = tref.quant_pack_ref(_t(x), _t(u), bits)
    for a, b in ((pt, pj), (zt, zj), (st, sj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tref.dequant_unpack_ref(pt, zt, st, bits, feat).numpy(),
        np.asarray(jref.dequant_unpack_ref(pj, zj, sj, bits, feat)))


@pytest.mark.parametrize("bits", BITS)
def test_plain_pair_vs_pallas_interpret_within_c_ref2(bits):
    """The Pallas kernel multiplies by 1/levels where the port divides: the
    scales may differ in the last bit, which can move a rare value across
    floor() by one level. Its interpreted dequantization rounds ``q *
    scale + zero`` once (a fused multiply-add), the plain version twice:
    the values agree to a few ulps of the largest."""
    feat = 64
    x = _inputs(256, feat, 11 * bits)
    u = np.random.default_rng(5).uniform(size=x.shape).astype(np.float32)
    pj, zj, sj = jqp.quant_pack(jnp.asarray(x), jnp.asarray(u), bits=bits,
                                interpret=True)
    pt, zt, st = tref.quant_pack_ref(_t(x), _t(u), bits)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_max_ulp(st.numpy(), np.asarray(sj), maxulp=1)
    qj = tst.unpack_bits(_t(np.asarray(pj)), bits, feat).numpy()
    qt = tst.unpack_bits(pt, bits, feat).numpy()
    assert np.abs(qj.astype(np.int64) - qt).max() <= 1
    assert np.mean(qj != qt) < 0.01
    dj = np.asarray(jqp.dequant_unpack(pj, zj, sj, bits=bits, feat=feat, interpret=True))
    dt = tref.dequant_unpack_ref(_t(np.asarray(pj)), _t(np.asarray(zj)),
                                 _t(np.asarray(sj)), bits, feat).numpy()
    np.testing.assert_allclose(dt, dj, rtol=0,
                               atol=4 * np.finfo(np.float32).eps * np.abs(dj).max())


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("feat", [100, 47])
def test_ragged_features_pack_losslessly(bits, feat):
    """F = 100 (layer 0 of the paper's model) is no multiple of 32/bits: the
    last word of a row carries zero upper fields, and unpacking returns
    exactly what ``quantize`` produced."""
    x = _inputs(32, feat, feat)
    u = np.random.default_rng(feat).uniform(size=x.shape).astype(np.float32)
    packed, zero, scale = tref.quant_pack_ref(_t(x), _t(u), bits)
    per_word = 32 // bits
    assert packed.shape == (32, -(-feat // per_word))
    q, params = tst.quantize(_t(x), bits, _t(u))
    np.testing.assert_array_equal(tst.unpack_bits(packed, bits, feat).numpy(), q.numpy())
    tail = feat % per_word
    if tail:
        last = packed[:, -1].numpy().astype(np.int64) & 0xFFFFFFFF
        assert np.all(last >> (tail * bits) == 0)
    np.testing.assert_array_equal(
        tref.dequant_unpack_ref(packed, zero, scale, bits, feat).numpy(),
        tst.dequantize(q, params).numpy())


def test_wrappers_take_plain_versions_on_cpu_and_check_inputs():
    x = _t(_inputs(16, 100, 0))
    u = torch.rand(16, 100)
    before = (tqp.pack_launches, tqp.unpack_launches)
    packed, zero, scale = tqp.quant_pack(x, u, 2)
    out = tqp.dequant_unpack(packed, zero, scale, 2, 100)
    assert (tqp.pack_launches, tqp.unpack_launches) == before
    want = tref.quant_pack_ref(x, u, 2)
    for a, b in zip((packed, zero, scale), want):
        assert torch.equal(a, b)
    assert torch.equal(out, tref.dequant_unpack_ref(*want, 2, 100))
    with pytest.raises(ValueError):
        tqp.quant_pack(x[:6], u[:6], 2)              # rows not a multiple of 4
    with pytest.raises(ValueError):
        tqp.quant_pack(x, u, 3)                       # unsupported width
    with pytest.raises(TypeError):
        tqp.quant_pack(x.double(), u.double(), 2)
    with pytest.raises(ValueError):
        tqp.dequant_unpack(packed, zero, scale, 2, feat=64)   # words for another F
