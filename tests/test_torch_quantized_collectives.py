"""The port's quantized collectives (``repro_torch.sharding.quantized_collectives``)
against the JAX package's, after ``tests/test_quantized_collectives.py``.

The JAX package runs each worker under ``jax.vmap(axis_name="w")`` and
draws its stochastic-rounding uniforms from ``jax.random`` keys folded with
the worker's index. Here those draws are replayed (the same keys, folds and
splits, the same shapes) and passed to the port, which stacks the workers
on a leading axis. With the same uniforms the codes, zeros and scales are
bitwise the JAX package's, and so are the results: the port sums each
shard over its sources one addition at a time, in source order, which is
XLA's order for ``deq.sum(axis=0)`` on the CPU. The JAX package runs
op by op here, as its own tests run it: under ``jax.jit`` XLA fuses the
dequantization into the sum and every value moves by up to a few ulps
(3.8e-06 at a sum of magnitude 8), so jitted results are not the bar.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant.stochastic import pack_bits as jpack_bits
from repro.quant.stochastic import quantize as jquantize
from repro.sharding.quantized_collectives import (
    quantized_all_to_all as jq_all_to_all,
    quantized_psum as jq_psum,
    quantized_psum_tree as jq_psum_tree,
)
from repro_torch.sharding import quantized_collectives as QC
from repro_torch.sharding import (quantized_all_to_all, quantized_psum,
                                  quantized_psum_tree)

LANES = 128


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _rows(n: int, p: int) -> int:
    chunk = p * 4 * LANES
    return (n + (-n) % chunk) // LANES


def _psum_draws(key, p: int, n: int):
    """The JAX package's (u1, u2) of ``quantized_psum`` on every worker:
    fold_in(key, w), split -> k1, k2; u1 [rows/4, 4, 128], u2 [rows/(4P), 4, 128]."""
    rows = _rows(n, p)
    u1, u2 = [], []
    for w in range(p):
        k1, k2 = jax.random.split(jax.random.fold_in(key, w))
        u1.append(np.asarray(jax.random.uniform(k1, (rows // 4, 4, LANES))))
        u2.append(np.asarray(jax.random.uniform(k2, (rows // p // 4, 4, LANES))))
    return _t(np.stack(u1)), _t(np.stack(u2))


def _a2a_draws(key, p: int, rows: int, feat: int) -> torch.Tensor:
    return _t(np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, w),
                                                      (rows // 4, 4, feat)))
                        for w in range(p)]))


def _jax_psum(g, bits, key=None):
    return np.asarray(jax.vmap(lambda gi: jq_psum(gi, "w", bits=bits, key=key),
                               axis_name="w")(g))


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("bits", [4, 8])
def test_codes_zero_and_scale_are_the_jax_packages(p, bits):
    """The reduce-scatter half's words, zeros and scales, worker by worker,
    bitwise equal to the JAX package's ``quantize`` + ``pack_bits`` under
    the replayed k1 draws; the same for the all-to-all's payload."""
    n = 1000
    g = jax.random.normal(jax.random.PRNGKey(0), (p, n)) * 2
    rows = _rows(n, p)
    x = np.zeros((p, rows * LANES), np.float32)
    x[:, :n] = np.asarray(g)
    x = x.reshape(p, rows, LANES)
    u1, _ = _psum_draws(jax.random.PRNGKey(1), p, n)
    packed, zero, scale = QC._quantize(_t(x), u1.reshape(p, rows, LANES), bits)
    for w in range(p):
        k1, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), w))
        q, params = jquantize(jnp.asarray(x[w]), bits, k1)
        np.testing.assert_array_equal(packed[w].numpy(), np.asarray(jpack_bits(q, bits)))
        np.testing.assert_array_equal(zero[w].numpy(), np.asarray(params.zero))
        np.testing.assert_array_equal(scale[w].numpy(), np.asarray(params.scale))

    feat = 64
    xa = jax.random.normal(jax.random.PRNGKey(3), (p, p * 8, feat))
    u = _a2a_draws(jax.random.PRNGKey(0), p, p * 8, feat)
    packed, zero, scale = QC._quantize(_t(xa), u.reshape(p, p * 8, feat), 8)
    for w in range(p):
        q, params = jquantize(xa[w], 8, jax.random.fold_in(jax.random.PRNGKey(0), w))
        np.testing.assert_array_equal(packed[w].numpy(), np.asarray(jpack_bits(q, 8)))
        np.testing.assert_array_equal(zero[w].numpy(), np.asarray(params.zero))
        np.testing.assert_array_equal(scale[w].numpy(), np.asarray(params.scale))


@pytest.mark.parametrize("p,bits,n", [(4, 8, 1000), (4, 4, 40), (8, 8, 3000),
                                      (8, 4, 1000)])
def test_psum_and_all_to_all_equal_the_jax_packages(p, bits, n):
    """Every worker's all-reduced value bitwise equal to the JAX package's,
    and within the JAX package's own bar of the exact sum; the all-to-all
    bitwise equal too."""
    g = jax.random.normal(jax.random.PRNGKey(0), (p, n)) * 2
    want = _jax_psum(g, bits)
    u1, u2 = _psum_draws(jax.random.PRNGKey(1), p, n)
    got = quantized_psum(_t(g), bits=bits, u1=u1, u2=u2).numpy()
    np.testing.assert_array_equal(got, want)
    exact = np.asarray(g).sum(0)
    tol = 0.35 if bits == 4 else 0.06
    assert np.abs(got - exact).max() < tol * np.abs(exact).max() + 1e-3

    rows, feat = p * 8, 64
    x = jax.random.normal(jax.random.PRNGKey(3), (p, rows, feat))
    want = np.asarray(jax.vmap(lambda xi: jq_all_to_all(xi, "w", bits=bits),
                               axis_name="w")(x))
    got = quantized_all_to_all(_t(x), bits=bits,
                               u=_a2a_draws(jax.random.PRNGKey(0), p, rows, feat))
    np.testing.assert_array_equal(got.numpy(), want)
    exact = np.asarray(x).reshape(p, p, 8, feat).transpose(1, 0, 2, 3).reshape(p, rows, feat)
    tol = 0.35 if bits == 4 else 0.05
    assert np.abs(got.numpy() - exact).max() < tol * np.abs(exact).max() + 1e-3


def test_tree_version_per_leaf():
    """One fold per leaf in sorted-key order, as the JAX package's tree
    flattening takes them: every leaf bitwise equal."""
    p = 4
    grads = {"b": jax.random.normal(jax.random.PRNGKey(2), (p, 8, 16)),
             "a": jax.random.normal(jax.random.PRNGKey(1), (p, 40)),
             "c": {"w": jax.random.normal(jax.random.PRNGKey(5), (p, 3, 100))}}
    want = jax.vmap(lambda g: jq_psum_tree(g, "w", bits=8), axis_name="w")(grads)
    key = jax.random.PRNGKey(2)
    order = [("a",), ("b",), ("c", "w")]           # sorted keys, JAX's leaf order
    us = [_psum_draws(jax.random.fold_in(key, i), p, int(np.prod(grads[k[0]].shape[1:])
                                                         if len(k) == 1 else 300))
          for i, k in enumerate(order)]
    got = quantized_psum_tree(jax.tree_util.tree_map(_t, grads), bits=8, us=us)
    assert sorted(got) == ["a", "b", "c"] and list(got["c"]) == ["w"]
    for k in order:
        g, w = got, want
        for part in k:
            g, w = g[part], w[part]
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.shape == tuple(w.shape)


def test_unbiased_over_keys():
    """Stochastic rounding keeps the all-reduce unbiased: the mean of 50
    all-reduces under the JAX package's keys 0..49 (replayed) lies within
    its bar of the exact sum, bitwise the JAX package's mean. Without
    uniforms the port draws them from a torch.Generator: the same seed
    gives the same result."""
    p, n = 4, 256
    g = jnp.broadcast_to(jnp.linspace(-1, 1, n)[None], (p, n))
    tg = _t(g)
    acc = torch.zeros(n)
    want = jnp.zeros((n,))
    for i in range(50):
        u1, u2 = _psum_draws(jax.random.PRNGKey(i), p, n)
        acc += quantized_psum(tg, bits=4, u1=u1, u2=u2)[0]
        want = want + _jax_psum(g, 4, key=jax.random.PRNGKey(i))[0]
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want))
    bias = float((acc / 50 - tg.sum(0)).abs().max())
    assert bias < 0.1, bias

    a, b = (quantized_psum(tg, bits=4, generator=torch.Generator().manual_seed(7))
            for _ in range(2))
    assert torch.equal(a, b)
