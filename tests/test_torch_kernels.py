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


def test_bucketed_aggregate_refuses_grad_without_reverse_layout():
    """Without ``ell_t`` the aggregation has no backward; an ``x`` that needs
    a gradient is refused on every device, so a caller cannot pass the CPU
    tests and lose the gradient on the card."""
    rng = np.random.default_rng(7)
    src, dst, w = _coo(rng, 40, 24, 0)
    ct = coo_to_csr(src, dst, w, 24, 40)
    lay = sa.device_bucketed(stack_bucketed_ells([bucketed_ell_from_csr(ct)]),
                             device="cpu")
    x = torch.from_numpy(rng.normal(size=(40, 8)).astype(np.float32)).requires_grad_()
    with pytest.raises(ValueError, match="ell_t"):
        sa.bucketed_aggregate(x, lay, 24)
    with torch.no_grad():
        assert sa.bucketed_aggregate(x, lay, 24).shape == (24, 8)
    assert sa.bucketed_aggregate(x.detach(), lay, 24).grad_fn is None


# -- the kernel's tables: one launch per aggregation -----------------------------
#
# The CUDA kernel cannot run here; what decides which rows it computes is
# the tables built in Python. _gather_rows decodes them as
# csrc/seg_aggregate.cu's seg_aggregate_gather does, line for line: the
# bucket scan (:223-226), row_tiles, p and r (:228-231) and the padding
# test (:235). A drift of the .cu from it shows on the card, where
# tests/test_torch_gpu.py runs the kernel on the same layouts against the
# plain version.


def _counts(b, workers):
    return b.counts.tolist() if b.counts is not None else [b.n] * workers


def _workers(lay):
    return lay.buckets[0].idx.shape[0] if lay.buckets[0].counts is not None else 1


def _gather_rows(table, buckets, workers):
    """(bucket, worker, row) -> times stored, over every tile of the grid."""
    seen = {}
    for tile in range(table.tiles):
        bi = max(i for i, s in enumerate(table.tile_start) if s <= tile)
        b = buckets[bi]
        row_tiles = -(-b.n // table.rows_per_tile)
        local = tile - table.tile_start[bi]
        p, r0 = local // row_tiles, (local % row_tiles) * table.rows_per_tile
        assert p < workers
        for r in range(r0, r0 + table.rows_per_tile):
            if r < _counts(b, workers)[p]:
                seen[(bi, p, r)] = seen.get((bi, p, r), 0) + 1
    return seen


def _uneven_stack():
    """Three workers; worker 1 has no row of degree 1 or 2, worker 2 a hub."""
    rng = np.random.default_rng(11)
    ells = []
    for p in range(3):
        src = rng.integers(0, 50, 200 + 150 * p)
        dst = rng.integers(0, 30, src.shape[0])
        if p == 2:
            dst[:90] = 7
        csr = coo_to_csr(src, dst, np.full(src.shape[0], 0.5, np.float32), 30, 50)
        if p == 1:                                   # drop rows of degree <= 2
            deg = csr.row_degrees()
            keep = deg[dst] > 2
            csr = coo_to_csr(src[keep], dst[keep], np.full(int(keep.sum()), 0.5,
                                                           np.float32), 30, 50)
        ells.append(bucketed_ell_from_csr(csr))
    return sa.device_bucketed(stack_bucketed_ells(ells), device="cpu", squeeze=False), 50


def _padded_graph():
    """One graph at a serving shape class: the whole ladder, empty buckets
    included, each padded past its real rows."""
    rng = np.random.default_rng(3)
    src, dst, w = _coo(rng, 40, 24, 70)
    et = bucketed_ell_from_csr(coo_to_csr(src, dst, w, 24, 40))
    return padded_device_bucketed(et, [(k, 64) for k in (1, 2, 4, 8, 16, 32, 64, 128)],
                                  device="cpu"), 40


@pytest.fixture(scope="module")
def train_layouts():
    """The fourteen stacked layouts of the small flagship spec (the
    training path's local graph, intra and inter send gathers, send-side
    pre-aggregations and receive scatters, and their reverses), a stack in
    which one worker has
    no row in a bucket, and a padded one-graph layout as the server builds
    them."""
    from repro_torch.configs.train_products_paper import FLAGSHIP
    from repro_torch.run import RunSpec, build_session

    wd = build_session(RunSpec.from_dict(FLAGSHIP), device="cpu").wd
    m = wd.x.shape[1]
    lays = {"local": (wd.ell, m), "local_t": (wd.ell_t, m)}
    for name, plan in (("intra", wd.hier_plan.intra), ("inter", wd.hier_plan.inter)):
        lays[name] = (plan.recv_ell, plan.send_gather_idx.shape[1])
        lays[name + "_t"] = (plan.recv_ell_t, m)
        lays[name + "_pre"] = (plan.pre_ell, m)
        lays[name + "_pre_t"] = (plan.pre_ell_t, plan.send_gather_idx.shape[1])
        lays[name + "_send"] = (plan.send_ell, m)
        lays[name + "_send_t"] = (plan.send_ell_t, plan.send_gather_idx.shape[1])
    lays["uneven"] = _uneven_stack()
    lays["padded"] = _padded_graph()
    return lays


LAYOUTS = ["local", "local_t", "intra", "intra_t", "inter", "inter_t", "intra_pre",
           "intra_pre_t", "inter_pre", "inter_pre_t", "intra_send", "intra_send_t",
           "inter_send", "inter_send_t", "uneven", "padded"]


@pytest.mark.parametrize("name", LAYOUTS)
@pytest.mark.parametrize("f", [256, 100, 47])
def test_tables_cover_every_real_row_once(train_layouts, name, f):
    lay, _ = train_layouts[name]
    workers = _workers(lay)
    live = [b for b in lay.buckets if b.n]
    want = {(bi, p, r): 1 for bi, b in enumerate(live)
            for p, c in enumerate(_counts(b, workers)) for r in range(c)}
    if name == "uneven":
        assert any(0 in _counts(b, workers) for b in live)
    if name == "padded":
        assert len(live) < len(lay.buckets)
    table = sa.launch_table(lay, f)
    assert list(table.dims) == [v for b, s in zip(live, table.tile_start)
                                for v in (b.idx.shape[-1], b.idx.shape[-2], b.n, s)]
    assert _gather_rows(table, live, workers) == want
    chunks = -(-f // 4)                              # every feature once
    assert table.lanes * table.rows_per_tile <= sa.GATHER_THREADS
    assert table.lanes * -(-chunks // table.lanes) >= chunks \
        > table.lanes * (-(-chunks // table.lanes) - 1)


@pytest.mark.parametrize("name", LAYOUTS)
def test_tables_are_built_once_per_layout_and_width(train_layouts, name):
    lay, _ = train_layouts[name]
    buckets = sa._bucket_table(lay)
    assert sa._bucket_table(lay) is buckets
    assert buckets.buckets == tuple(b for b in lay.buckets if b.n)
    assert list(buckets.ptrs) == [t.data_ptr() if t is not None else 0
                                  for b in buckets.buckets
                                  for t in (b.idx, b.w, b.rows, b.counts)]
    tables = {f: sa.launch_table(lay, f) for f in (256, 100, 47)}
    assert all(sa.launch_table(lay, f) is t for f, t in tables.items())
    assert tables[256].lanes == 64 and tables[100].lanes == 25 and tables[47].lanes == 12


def test_tables_refuse_more_than_16_buckets():
    one = lambda: sa.DeviceEllBucket(rows=torch.tensor([1], dtype=torch.int32),
                                     idx=torch.zeros((1, 1), dtype=torch.int32),
                                     w=torch.ones((1, 1)), n=1)
    ok = sa.DeviceBucketedEll(tuple(one() for _ in range(sa.MAX_BUCKETS)))
    assert len(sa.launch_table(ok, 8).tile_start) == 16
    with pytest.raises(ValueError, match="at most 16"):
        sa.launch_table(sa.DeviceBucketedEll(tuple(one() for _ in range(17))), 8)


# -- kernels/ops.py: the public wrappers ------------------------------------------


@pytest.mark.parametrize("n,f,r,k", [(64, 128, 8, 3), (90, 100, 13, 5)])
def test_ops_aggregate_matches_jax(n, f, r, k):
    """``ops.aggregate`` on a dense ELL against the JAX package's (its
    Pallas kernel in interpret mode on the aligned shape, its jnp oracle on
    the ragged one); forward only."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops

    x, idx, w = _inputs(n, f, r, k, 3 * n + k)
    expect = np.asarray(jops.aggregate(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(w)))
    got = ops.aggregate(torch.from_numpy(x), torch.from_numpy(idx).long(),
                        torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), expect, **TOL)
    with pytest.raises(ValueError, match="forward only"):
        ops.aggregate(torch.from_numpy(x).requires_grad_(True), torch.from_numpy(idx),
                      torch.from_numpy(w))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_ops_quantizer_wrappers_match_jax_oracle(bits):
    """``ops.quantize_pack`` / ``ops.dequantize_unpack`` equal the JAX
    package's oracles bit for bit (the oracles divide, as the port does:
    ROADMAP C-ref2); rows that are not a multiple of 4 are refused by both
    packages."""
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops

    rng = np.random.default_rng(bits)
    x = rng.normal(size=(16, 64)).astype(np.float32)
    u = rng.uniform(size=(16, 64)).astype(np.float32)
    jp, jz, js = jref.quant_pack_ref(jnp.asarray(x), jnp.asarray(u), bits)
    tp, tz, ts = ops.quantize_pack(torch.from_numpy(x), torch.from_numpy(u), bits=bits)
    for a, b in ((tp, jp), (tz, jz), (ts, js)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        ops.dequantize_unpack(tp, tz, ts, bits=bits, feat=64).numpy(),
        np.asarray(jops.dequantize_unpack(jp, jz, js, bits=bits, feat=64,
                                          use_kernel=False)))
    with pytest.raises(TypeError):
        jops.quantize_pack(jnp.asarray(x[:6]), jnp.asarray(u[:6]), bits=bits)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.quantize_pack(torch.from_numpy(x[:6]), torch.from_numpy(u[:6]), bits=bits)
