"""The port's seg_aggregate and bucketed forward against the JAX package.

Tolerance: rtol = atol = 1e-5, the bar tests/test_kernels.py sets. The
port's plain version multiplies then sums over k with torch's reduction,
the JAX versions use einsum or the Pallas kernel's chunked accumulation,
so the fp32 sums are taken in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graph.structure import (bucketed_ell_from_csr as j_bucketed,
                                   coo_to_csr as j_coo_to_csr,
                                   stack_bucketed_ells as j_stack)
from repro.kernels import ref as jref
from repro.kernels.ops import padded_device_bucketed as j_padded
from repro.kernels.seg_aggregate import bucketed_aggregate as j_bucketed_aggregate
from repro.kernels.seg_aggregate import device_bucketed as j_device_bucketed
from repro.kernels.seg_aggregate import seg_aggregate as j_seg_aggregate

from repro_torch.graph.structure import (bucketed_ell_from_csr, coo_to_csr,
                                         stack_bucketed_ells)
from repro_torch.kernels import seg_aggregate as sa
from repro_torch.kernels.ops import padded_device_bucketed
from repro_torch.kernels.ref import seg_aggregate_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n, f, r, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    idx = rng.integers(0, n, size=(r, k)).astype(np.int32)
    w = (rng.uniform(size=(r, k)) * (rng.uniform(size=(r, k)) > 0.3)).astype(np.float32)
    return x, idx, w


@pytest.mark.parametrize("n,f,r,k", [(64, 128, 8, 1), (300, 256, 64, 20),
                                     (128, 128, 16, 7)])
def test_plain_matches_pallas_interpret(n, f, r, k):
    x, idx, w = _inputs(n, f, r, k, n + f + r + k)
    expect = np.asarray(j_seg_aggregate(jnp.asarray(x), jnp.asarray(idx),
                                        jnp.asarray(w), interpret=True))
    got = sa.seg_aggregate(torch.from_numpy(x), torch.from_numpy(idx),
                           torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), expect, **TOL)


@pytest.mark.parametrize("n,f,r,k", [(50, 100, 13, 1), (200, 47, 9, 16),
                                     (90, 8, 5, 33), (30, 16, 3, 1024)])
def test_plain_matches_jnp_ref_unaligned(n, f, r, k):
    x, idx, w = _inputs(n, f, r, k, 7 * n + k)
    expect = np.asarray(jref.seg_aggregate_ref(jnp.asarray(x), jnp.asarray(idx),
                                               jnp.asarray(w)))
    got = seg_aggregate_ref(torch.from_numpy(x), torch.from_numpy(idx),
                            torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), expect, **TOL)


def _coo(rng, n_src, n_dst, hub_degree):
    """Random rectangular COO with degree-0 and degree-1 rows plus a hub."""
    n_edges = int(rng.integers(n_dst, 3 * n_dst))
    src = rng.integers(0, n_src, n_edges)
    dst = rng.integers(0, n_dst, n_edges)
    src = np.concatenate([src, rng.integers(0, n_src, hub_degree)])
    dst = np.concatenate([dst, np.full(hub_degree, n_dst // 2)])
    # Row 0 gets exactly one in-edge and row 1 none: degree-1 and degree-0.
    keep = (dst != 0) & (dst != 1)
    src = np.concatenate([src[keep], [n_src - 1]])
    dst = np.concatenate([dst[keep], [0]])
    w = rng.uniform(0.1, 1.0, len(src)).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), w


@pytest.mark.parametrize("n_src,n_dst,hub,f", [(40, 40, 70, 8), (64, 24, 300, 16),
                                               (30, 50, 1030, 12)])
@pytest.mark.parametrize("layout", ["stacked", "padded"])
def test_bucketed_forward_matches_jax(n_src, n_dst, hub, f, layout):
    rng = np.random.default_rng(n_src * 1000 + n_dst + hub)
    src, dst, w = _coo(rng, n_src, n_dst, hub)
    x = rng.normal(size=(n_src, f)).astype(np.float32)
    cj = j_coo_to_csr(src, dst, w, n_dst, n_src)
    ct = coo_to_csr(src, dst, w, n_dst, n_src)
    ej, et = j_bucketed(cj), bucketed_ell_from_csr(ct)
    assert ct.row_degrees()[0] == 1 and ct.row_degrees()[1] == 0
    assert max(et.ks) >= 1024 or max(et.ks) >= hub
    if layout == "stacked":     # row_align=8 padding, as the full-batch path
        dj = j_device_bucketed(j_stack([ej]), squeeze=True)
        dt = sa.device_bucketed(stack_bucketed_ells([et]), device="cpu")
    else:                       # shape-class padding incl. empty buckets
        caps = [(k, 64) for k in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)]
        dj, dt = j_padded(ej, caps), padded_device_bucketed(et, caps, device="cpu")
        assert any(b.n == 0 for b in dt.buckets)
    assert [b.n for b in dt.buckets if b.n] == [b.rows.shape[0] for b in et.buckets]
    expect = np.asarray(j_bucketed_aggregate(jnp.asarray(x), dj, dj, n_dst,
                                             use_kernel=False))
    got = sa.bucketed_aggregate(torch.from_numpy(x), dt, n_dst)
    assert got.shape == (n_dst, f)
    np.testing.assert_allclose(got.numpy(), expect, **TOL)
    assert np.all(got.numpy()[1] == 0)          # degree-0 row stays zero


def test_real_rows_keep_row_zero():
    # Bucket whose first real row is destination 0; padding rows also point
    # at 0 with zero weights and must not count as real.
    rows = np.array([0, 3, 5, 0, 0, 0, 0, 0])
    w = np.zeros((8, 2), np.float32)
    w[:3] = 0.5
    assert sa._real_rows(rows, w) == 3
    assert sa._real_rows(np.zeros(8, np.int64), np.zeros((8, 2), np.float32)) == 0


def test_cpu_path_counts_no_launch_and_checks_inputs():
    x, idx, w = _inputs(20, 8, 4, 3, 0)
    before = sa.launches
    sa.seg_aggregate(torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(w))
    assert sa.launches == before
    with pytest.raises(TypeError):
        sa.seg_aggregate(torch.from_numpy(x), torch.from_numpy(idx).long(),
                         torch.from_numpy(w))
    with pytest.raises(ValueError):
        sa.seg_aggregate(torch.from_numpy(x), torch.from_numpy(idx),
                         torch.from_numpy(w[:, :2].copy()))
    with pytest.raises(ValueError):
        sa.seg_aggregate(torch.from_numpy(x).t(), torch.from_numpy(idx),
                         torch.from_numpy(w))
