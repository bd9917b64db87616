"""Tests of the port that need a CUDA card (marker ``gpu``); they skip without one.
One test, of the packed layout the quantizer kernels store, runs on the CPU.

They import neither JAX nor the JAX package, so they run on a machine
with only PyTorch: ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
Tolerance: rtol = atol = 1e-5; the kernel sums each row's slots in a fixed
order with fused multiply-adds, the plain version multiplies and then
reduces, so the fp32 sums differ in order. Each row's weights sum to 1,
as the mean-normalized graphs the server runs give them: with weights
that do not, a K = 1024 row's rounding in either order is of the order
of the bar itself.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.serve_products_paper import FLAGSHIP
from repro_torch.graph.structure import bucketed_ell_from_csr, coo_to_csr
from repro_torch.kernels import quant_pack as qp
from repro_torch.kernels import seg_aggregate as sa
from repro_torch.kernels.ops import padded_device_bucketed
from repro_torch.kernels.ref import seg_aggregate_ref
from repro_torch.serve import ServeSpec, build_server

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(n, f, r, k, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    idx = rng.integers(0, n, size=(r, k)).astype(np.int32)
    w = rng.uniform(size=(r, k))
    w = (w / w.sum(1, keepdims=True)).astype(np.float32)   # mean-normalized rows
    return (torch.from_numpy(a).to(dev) for a in (x, idx, w))


@pytest.mark.gpu
@pytest.mark.parametrize("n,f,r,k", [(500, 100, 37, 1), (500, 256, 64, 16),
                                     (300, 47, 9, 1024), (40, 8, 3, 5)])
def test_kernel_matches_plain(cuda, n, f, r, k):
    x, idx, w = _inputs(n, f, r, k, k, cuda)
    before = sa.launches
    got = sa.seg_aggregate(x, idx, w)
    assert sa.launches == before + 1
    torch.testing.assert_close(got, seg_aggregate_ref(x, idx, w), **TOL)


@pytest.mark.gpu
def test_bucketed_kernel_keeps_row_zero_and_skips_padding(cuda):
    rng = np.random.default_rng(1)
    src = rng.integers(0, 64, 400)
    dst = np.concatenate([rng.integers(0, 24, 100), np.full(300, 12)])
    keep = dst != 3                              # row 3: degree 0
    src, dst = src[keep], dst[keep]
    w = (1.0 / np.bincount(dst, minlength=24)[dst]).astype(np.float32)
    et = bucketed_ell_from_csr(coo_to_csr(src, dst, w, 24, 64))
    x = torch.from_numpy(rng.normal(size=(64, 100)).astype(np.float32)).to(cuda)
    caps = [(k, 64) for k in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)]
    dt = padded_device_bucketed(et, caps, device=cuda)
    before = sa.launches
    got = sa.bucketed_aggregate(x, dt, 24)
    assert sa.launches - before == 1                  # one launch, all buckets
    torch.testing.assert_close(got, sa.bucketed_forward_ref(x, dt, 24), **TOL)
    assert torch.count_nonzero(got[0]) > 0 and torch.count_nonzero(got[3]) == 0


@pytest.mark.gpu
def test_wrapper_rejects_bad_inputs(cuda):
    x, idx, w = _inputs(20, 8, 4, 3, 0, cuda)
    with pytest.raises(TypeError):
        sa.seg_aggregate(x, idx.long(), w)
    with pytest.raises(ValueError):
        sa.seg_aggregate(x, idx.cpu(), w)


@pytest.mark.gpu
def test_serving_on_card_matches_cpu(cuda):
    spec = ServeSpec.from_json(json.dumps(FLAGSHIP))
    on_card, on_cpu = build_server(spec, device=cuda), build_server(spec, device="cpu")
    reqs = [[1], [50], [200], [7, 8]]
    before = sa.launches
    for a, b in zip(on_card.serve_batch(reqs), on_cpu.serve_batch(reqs)):
        np.testing.assert_allclose(a, b, **TOL)
    assert sa.launches > before
    assert on_card.check_parity([3, 4, 5])


# -- the training slice ---------------------------------------------------------


QUANT_CASES = ("random", "empty_range", "signed_zeros", "noise_near_one", "unaligned")


@pytest.mark.gpu
@pytest.mark.parametrize("case", QUANT_CASES)
@pytest.mark.parametrize("rows", [4, 1024])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("f", [4, 16, 47, 100, 256, 1024])
def test_quant_kernels_equal_plain_bitwise(cuda, f, bits, rows, case):
    """Every path of csrc/quant_pack.cu: F = 4 (one float4 a row), 16 (whole
    words only), 47 (the scalar path), 100 (a ragged last word), 256 (the
    widest row held in registers), 1024 (the looping path); one group or
    256. The last group holds the case: an empty range, both -0.0 and +0.0
    as its minimum, noise at 1 - 2^-24, or x and noise 4 bytes off a
    16-byte boundary (the float4 paths must not be taken)."""
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels.ref import dequant_unpack_ref, quant_pack_ref

    rng = np.random.default_rng([f, bits, rows, QUANT_CASES.index(case)])
    x = rng.normal(size=(rows, f)).astype(np.float32)
    u = rng.uniform(size=(rows, f)).astype(np.float32)
    last = slice(rows - 4, rows)
    if case == "empty_range":
        x[last] = 0.5
    elif case == "signed_zeros":
        x[last] = np.abs(x[last])
        x[rows - 4, 0], x[rows - 1, -1] = -0.0, 0.0
    elif case == "noise_near_one":
        u[last] = np.float32(1.0) - np.float32(2.0**-24)
    x, u = torch.from_numpy(x).to(cuda), torch.from_numpy(u).to(cuda)
    if case == "unaligned":
        x, u = (torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(rows, f) for t in (x, u))
        assert x.data_ptr() % 16 and u.data_ptr() % 16 and x.is_contiguous()
    before = (qp.pack_launches, qp.unpack_launches)
    got = qp.quant_pack(x, u, bits)
    want = quant_pack_ref(x, u, bits)
    for a, b in zip(got, want):       # zero: either sign of 0.0 is the group's min
        assert torch.equal(a, b)
    deq = qp.dequant_unpack(*want, bits, f)
    assert torch.equal(deq.view(torch.int32),
                       dequant_unpack_ref(*want, bits, f).view(torch.int32))
    assert (qp.pack_launches, qp.unpack_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("f", [4, 16, 100, 256])
def test_packed_row_layout_the_kernels_store(bits, f):
    """The layout csrc/quant_pack.cu's float4 paths rely on (CPU, the plain
    packer): unit c of a packed row, a byte at Int2, a half-word at Int4
    and a word at Int8 (little-endian), holds the fields of features
    4c..4c+3, and the bytes after the last such unit are zero."""
    from repro_torch.quant.stochastic import pack_bits

    rng = np.random.default_rng([bits, f])
    q = rng.integers(0, 1 << bits, size=(8, f))
    packed = pack_bits(torch.from_numpy(q.astype(np.int32)), bits).numpy()
    row_bytes = packed.view(np.uint8).reshape(8, -1)
    units = row_bytes[:, : f * bits // 8].view({2: np.uint8, 4: "<u2", 8: "<u4"}[bits])
    want = sum(q[:, j::4] << (j * bits) for j in range(4))
    np.testing.assert_array_equal(units, want)
    assert not row_bytes[:, f * bits // 8:].any()


@pytest.mark.gpu
def test_stacked_aggregation_and_backward(cuda):
    from repro_torch.graph.structure import stack_bucketed_ells, transpose_csr

    rng = np.random.default_rng(4)
    ells, ells_t = [], []
    for p in range(3):                       # rectangular: 40 sources -> 24 rows
        src = rng.integers(0, 40, 150 + 60 * p)
        dst = rng.integers(0, 24, src.shape[0])
        dst[: 40 * p] = 3                     # a hub row in some workers only
        w = rng.uniform(0.1, 1.0, src.shape[0]).astype(np.float32)
        csr = coo_to_csr(src, dst, w, 24, 40)
        ells.append(bucketed_ell_from_csr(csr))
        ells_t.append(bucketed_ell_from_csr(transpose_csr(csr)))
    lay = sa.device_bucketed(stack_bucketed_ells(ells), device=cuda, squeeze=False)
    lay_t = sa.device_bucketed(stack_bucketed_ells(ells_t), device=cuda, squeeze=False)
    x = torch.randn((3, 40, 100), device=cuda, requires_grad=True)
    before = (sa.launches, sa.backward_launches)
    y = sa.bucketed_aggregate(x, lay, 24, ell_t=lay_t)
    g = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, g)
    assert sa.launches - before[0] == 1
    assert sa.backward_launches - before[1] == 1
    torch.testing.assert_close(y, sa.bucketed_forward_ref(x.detach(), lay, 24), **TOL)
    torch.testing.assert_close(dx, sa.bucketed_forward_ref(g, lay_t, 40), **TOL)


@pytest.mark.gpu
def test_training_on_card_matches_cpu(cuda):
    from repro_torch.configs.train_products_paper import FLAGSHIP as TRAIN_FLAGSHIP
    from repro_torch.core import GeneratorRandomness
    from repro_torch.run import RunSpec, build_session

    spec = RunSpec.from_dict(TRAIN_FLAGSHIP).with_overrides(["schedule.inter_bits=0"])
    losses = []
    for dev in (cuda, "cpu"):
        s = build_session(spec, device=dev,
                          randomness=GeneratorRandomness(0, draw_device="cpu"))
        losses.append([s.train_epoch()["loss"] for _ in range(2)])
    np.testing.assert_allclose(losses[0], losses[1], **TOL)


# -- the one-launch aggregation kernel on uneven and training layouts -----------


def _hub_layouts(dev):
    """A stack of 3 workers over 200 source rows and its one-graph padded
    form (worker 1): worker 1 has a hub row of degree 700 (K = 1024 bucket)
    that the others lack, row 0 is real (degree 1) in workers 0 and 1, row
    5 has degree 0 everywhere; weights are mean-normalized (each row sums
    to 1)."""
    from repro_torch.graph.structure import stack_bucketed_ells

    rng = np.random.default_rng(5)
    ells = []
    for p in range(3):
        src = rng.integers(0, 200, 900 + 300 * p)
        dst = rng.integers(1, 64, src.shape[0])
        if p == 1:
            dst[:700] = 9
            dst[700] = 0
        if p == 0:
            dst[0] = 0
        keep = dst != 5
        src, dst = src[keep], dst[keep]
        w = (1.0 / np.bincount(dst, minlength=64)[dst]).astype(np.float32)
        ells.append(bucketed_ell_from_csr(coo_to_csr(src, dst, w, 64, 200)))
    stacked = sa.device_bucketed(stack_bucketed_ells(ells), device=dev, squeeze=False)
    caps = [(k, 64) for k in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)]
    one = padded_device_bucketed(ells[1], caps, device=dev)
    assert any(b.n == 0 for b in one.buckets) and max(b.idx.shape[-1] for b in one.buckets
                                                      if b.n) == 1024
    return stacked, one


@pytest.mark.gpu
@pytest.mark.parametrize("f", [256, 100, 47])
def test_kernel_repeats_bitwise_on_hub_layouts(cuda, f):
    """Two launches give the same bits on a stack with a K = 1024 hub in
    one worker, a bucket another worker has no row in, a real row 0 and a
    degree-0 row, and on its padded one-graph form with empty buckets; one
    launch per call; close to the plain version."""
    stacked, one = _hub_layouts(cuda)
    for lay, x in ((stacked, torch.randn((3, 200, f), device=cuda)),
                   (one, torch.randn((200, f), device=cuda))):
        before = sa.launches
        a = sa._bucketed_forward(x, lay, 64)
        b = sa._bucketed_forward(x, lay, 64)
        assert sa.launches - before == 2
        assert torch.equal(a, b)
        torch.testing.assert_close(a, sa.bucketed_forward_ref(x, lay, 64), **TOL)
        rows = a.reshape(-1, 64, f)
        assert torch.count_nonzero(rows[0, 0]) > 0          # real row 0 kept
        assert torch.count_nonzero(rows[:, 5]) == 0         # degree-0 row stays zero


@pytest.mark.gpu
@pytest.mark.parametrize("f", [256, 100, 47])
def test_kernel_on_the_training_layouts(cuda, f):
    """The fourteen stacked layouts of the small flagship spec (the layouts
    tests/test_torch_kernels.py decodes the launch tables of), forward and
    backward, against the plain version."""
    from repro_torch.configs.train_products_paper import FLAGSHIP as TRAIN_FLAGSHIP
    from repro_torch.run import RunSpec, build_session

    wd = build_session(RunSpec.from_dict(TRAIN_FLAGSHIP), device=cuda).wd
    m = wd.x.shape[1]
    lays = [(wd.ell, m, m), (wd.ell_t, m, m)]
    for plan in (wd.hier_plan.intra, wd.hier_plan.inter):
        wire = plan.send_gather_idx.shape[1]
        lays += [(plan.recv_ell, wire, m), (plan.recv_ell_t, m, wire),
                 (plan.pre_ell, m, wire), (plan.pre_ell_t, wire, m),
                 (plan.send_ell, m, wire), (plan.send_ell_t, wire, m)]
    for lay, n_in, n_out in lays:
        x = torch.randn((wd.x.shape[0], n_in, f), device=cuda)
        got = sa._bucketed_forward(x, lay, n_out)
        assert torch.equal(got, sa._bucketed_forward(x, lay, n_out))
        torch.testing.assert_close(got, sa.bucketed_forward_ref(x, lay, n_out), **TOL)


# -- single-device training, GAT serving, resume --------------------------------


def _sbm(dev, nodes=600, classes=4):
    from repro_torch.core.trainer import prepare_single
    from repro_torch.graph import sbm_graph
    from repro_torch.graph.generators import sbm_features

    g = sbm_graph(nodes, classes, avg_degree=12, homophily=0.85, seed=0)
    x, _ = sbm_features(g, 16, noise=1.5, seed=1)
    return g, x, prepare_single(g, x, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("f", [256, 100, 47])
def test_one_graph_aggregation_backward(cuda, f):
    """The single-device trainer's aggregation: one graph, forward over
    ``ell`` and backward over ``ell_t``, one launch each, against the plain
    version."""
    _, _, data = _sbm(cuda)
    n = data.x.shape[0]
    x = torch.randn((n, f), device=cuda, requires_grad=True)
    before = (sa.launches, sa.backward_launches)
    y = sa.bucketed_aggregate(x, data.ell, ell_t=data.ell_t)
    g = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, g)
    assert (sa.launches - before[0], sa.backward_launches - before[1]) == (1, 1)
    torch.testing.assert_close(y, sa.bucketed_forward_ref(x.detach(), data.ell, n), **TOL)
    torch.testing.assert_close(dx, sa.bucketed_forward_ref(g, data.ell_t, n), **TOL)


@pytest.mark.gpu
def test_dense_ell_aggregate(cuda):
    """``ops.aggregate`` on the dense max-degree ELL: one launch, against
    the plain version."""
    from repro_torch.kernels.ops import aggregate

    _, _, data = _sbm(cuda)
    x = torch.randn((data.x.shape[0], 256), device=cuda)
    before = sa.launches
    got = aggregate(x, data.ell_idx, data.ell_w)
    assert sa.launches == before + 1
    torch.testing.assert_close(got, seg_aggregate_ref(x, data.ell_idx, data.ell_w), **TOL)


@pytest.mark.gpu
def test_single_device_training_on_card_matches_cpu(cuda):
    from repro_torch.core import GCNConfig, GeneratorRandomness, train_gcn_single

    g, x, _ = _sbm(cuda)
    for model in ("sage", "gat"):
        cfg = GCNConfig(model=model, in_dim=16, hidden_dim=32, num_classes=4,
                        num_layers=2, dropout=0.5, label_prop=True)
        losses = []
        before = (sa.launches, sa.backward_launches)
        for dev in (cuda, "cpu"):
            _, hist = train_gcn_single(
                g, x, cfg, epochs=3, log_every=1, device=dev,
                randomness=GeneratorRandomness(0, draw_device="cpu"))
            losses.append([h["loss"] for h in hist])
        assert sa.launches > before[0]
        if model == "sage":
            assert sa.backward_launches - before[1] == 3 * 2   # 2 layers, 3 epochs
        np.testing.assert_allclose(losses[0], losses[1], **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [1, 4])
def test_gat_served_equals_full_batch_on_card(cuda, heads):
    spec = ServeSpec.from_json(json.dumps(FLAGSHIP)).with_overrides(
        ["model.model=gat", f"model.gat_heads={heads}", "serve.fanouts=full"])
    server = build_server(spec, device=cuda)
    full = server.full_batch_logits()
    reqs = [[1], [50], [200], [7, 8], [90]]
    before = sa.launches
    for req, logits in zip(reqs, server.serve_batch(reqs)):
        assert np.array_equal(logits, full[np.asarray(req)]), req
    assert sa.launches > before


@pytest.mark.gpu
def test_resume_on_card_is_bitwise(cuda, tmp_path):
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.configs.train_products_paper import FLAGSHIP as TRAIN_FLAGSHIP
    from repro_torch.run import RunSpec, build_session

    spec = lambda n: RunSpec.from_dict(TRAIN_FLAGSHIP).with_overrides([f"exec.epochs={n}"])
    full = build_session(spec(4), device=cuda)
    hist = full.fit(log_every=1)
    build_session(spec(2), device=cuda).fit(log_every=1, ckpt_dir=tmp_path)
    resumed = build_session(spec(4), device=cuda)
    assert resumed.fit(log_every=1, ckpt_dir=tmp_path, resume=True) == hist[2:]
    a, b = _flatten(resumed.trainer.train_state()), _flatten(full.trainer.train_state())
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.gpu
def test_pre_aggregation_repeats_bitwise(cuda):
    """The send-side pre-aggregation on the ``ell`` backend runs through
    the kernel, so its forward and backward repeat bit for bit (the
    ``coo`` backend's ``index_add`` adds with atomics on the card)."""
    from repro_torch.configs.train_products_paper import FLAGSHIP as TRAIN_FLAGSHIP
    from repro_torch.core.exchange import assemble_send
    from repro_torch.run import RunSpec, build_session

    wd = build_session(RunSpec.from_dict(TRAIN_FLAGSHIP), device=cuda).wd
    for plan in (wd.hier_plan.intra, wd.hier_plan.inter):
        h = torch.randn((wd.x.shape[0], wd.x.shape[1], 100), device=cuda)
        runs = []
        for _ in range(3):
            x = h.clone().requires_grad_(True)
            y = assemble_send(x, plan, "ell")
            runs.append((y.detach(), torch.autograd.grad(y, x, torch.ones_like(y))[0]))
        for y, dx in runs[1:]:
            assert torch.equal(y, runs[0][0]) and torch.equal(dx, runs[0][1])
        torch.testing.assert_close(runs[0][0], assemble_send(h, plan, "coo"), **TOL)


@pytest.mark.gpu
def test_send_gather_over_the_layout_on_card(cuda, monkeypatch):
    """The raw send gather over the plan's send layout on the card, both
    stages at F=256: two forward and backward passes give the same bits
    (C1), one launch each way a call; the forward is the index gather's
    bit for bit and its gradient the index gather's within TOL. In a
    stacked ``ell`` epoch every send gather goes over the layout, and each
    adds one backward launch against the same epoch through the index."""
    from repro_torch.configs.train_products_paper import FLAGSHIP as TRAIN_FLAGSHIP
    from repro_torch.core import exchange as X
    from repro_torch.run import RunSpec, build_session

    session = build_session(RunSpec.from_dict(TRAIN_FLAGSHIP), device=cuda)
    wd = session.wd
    for plan in (wd.hier_plan.intra, wd.hier_plan.inter):
        h = torch.randn((wd.x.shape[0], wd.x.shape[1], 256), device=cuda)
        g = torch.randn((h.shape[0], plan.send_gather_idx.shape[1], 256), device=cuda)
        runs = []
        for pl in (plan, plan, plan._replace(send_ell=None, send_ell_t=None)):
            x = h.clone().requires_grad_(True)
            before = (sa.launches, sa.backward_launches)
            y = X._send_gather(x, pl, "ell")
            (dx,) = torch.autograd.grad(y, x, g)
            runs.append((y.detach(), dx,
                         (sa.launches - before[0], sa.backward_launches - before[1])))
        (y, dx, launched), (y2, dx2, launched2), (yi, dxi, launched_i) = runs
        assert torch.equal(y, y2) and torch.equal(dx, dx2)
        assert launched == launched2 == (1, 1) and launched_i == (0, 0)
        assert torch.equal(y.view(torch.int32), yi.view(torch.int32))
        torch.testing.assert_close(dx, dxi, **TOL)

    def epoch():
        gathers, bwd = X.gather_counts(), sa.backward_launches
        session.train_epoch()
        return ({k: v - gathers[k] for k, v in X.gather_counts().items()},
                sa.backward_launches - bwd)

    layout, bwd = epoch()                     # epoch 0 refreshes both stages
    assert layout["layout"] > 0 and layout["index"] == 0
    epoch()
    gather = X._send_gather
    monkeypatch.setattr(X, "_send_gather", lambda h, plan, backend: gather(
        h, plan._replace(send_ell=None, send_ell_t=None), backend))
    index, bwd_index = epoch()                # epoch 2 refreshes both again
    assert index == {"layout": 0, "index": layout["layout"]}
    assert bwd - bwd_index == layout["layout"]


# -- multiproc on the card, recovery, and the coo backend (C1) -------------------


@pytest.mark.gpu
def test_multiproc_on_card_matches_stacked(cuda):
    """The small flagship spec as 8 processes sharing the card against the
    stacked run on the card, from the same parameters and draws: epoch 0
    within 1e-5, the rest within the Int2 wire's 1e-3 (a last-bit change
    before the stochastic rounding can move an element a whole level).
    Every rank launches every kernel."""
    from repro_torch.configs.train_products_paper import FLAGSHIP as TRAIN_FLAGSHIP
    from repro_torch.launch.shm_store import leaked_segments
    from repro_torch.run import RunSpec, build_session

    spec = RunSpec.from_dict(TRAIN_FLAGSHIP).with_overrides(["exec.mode=multiproc"])
    session = build_session(spec, device=cuda)
    rt = session.trainer
    try:
        mp = [session.train_epoch()["loss"] for _ in range(3)]
        mp_eval = session.evaluate()
        stats, token = list(rt.epoch_stats), rt.token
    finally:
        session.close()
    assert leaked_segments(token) == []
    stacked = build_session(spec.with_overrides(["exec.mode=vmap", "exec.nprocs=0"]),
                            device=cuda)
    st = [stacked.train_epoch()["loss"] for _ in range(3)]
    assert abs(mp[0] - st[0]) <= 1e-5
    np.testing.assert_allclose(mp[1:], st[1:], atol=1e-3, rtol=0)
    assert abs(mp_eval - stacked.evaluate()) <= 0.05
    for rank in range(8):
        total = {k: sum(s["launches"][rank][k] for s in stats)
                 for k in stats[0]["launches"][rank]}
        assert all(v > 0 for v in total.values()), (rank, total)


@pytest.mark.gpu
def test_shard_map_gloo_on_card_equals_multiproc(cuda):
    """The small flagship spec under exec.mode=shard_map as 8 gloo ranks
    sharing the card (backend="gloo") against multiproc on the card, from
    the same parameters and draws: losses and evaluation bitwise (every
    cross-rank sum moves data, then sums in rank order), equal wire bytes,
    and every rank launches every kernel."""
    from repro_torch.configs.train_products_paper import FLAGSHIP as TRAIN_FLAGSHIP
    from repro_torch.launch.shm_store import leaked_segments
    from repro_torch.run import RunSpec, build_session

    base = RunSpec.from_dict(TRAIN_FLAGSHIP)
    runs = {}
    for mode, backend in (("shard_map", "gloo"), ("multiproc", None)):
        session = build_session(base.with_overrides([f"exec.mode={mode}"]), device=cuda,
                                backend=backend)
        rt = session.trainer
        try:
            losses = [session.train_epoch()["loss"] for _ in range(3)]
            runs[mode] = (losses, session.evaluate(), list(rt.epoch_stats), rt.token)
        finally:
            session.close()
        assert leaked_segments(runs[mode][3]) == []
    assert runs["shard_map"][:2] == runs["multiproc"][:2]
    stats = runs["shard_map"][2]
    assert ([s["wire_bytes"] for s in stats]
            == [s["wire_bytes"] for s in runs["multiproc"][2]])
    for rank in range(8):
        total = {k: sum(s["launches"][rank][k] for s in stats)
                 for k in stats[0]["launches"][rank]}
        assert all(v > 0 for v in total.values()), (rank, total)


@pytest.mark.gpu
def test_chaos_kill_on_card_is_bitwise(cuda, tmp_path):
    from repro_torch.launch.chaos import evaluate_case, run_baseline, run_faulted
    from repro_torch.run import RunSpec

    spec = RunSpec().with_overrides([
        "graph.source=sbm", "graph.nodes=96", "graph.classes=4",
        "graph.feat_dim=16", "graph.feat_noise=2.0", "graph.homophily=0.8",
        "graph.norm=mean", "partition.nparts=2", "schedule.bits=2",
        "model.model=sage", "model.hidden_dim=16", "model.num_layers=2",
        "model.dropout=0.5", "model.label_prop=true", "exec.mode=multiproc",
        "exec.nprocs=2", "exec.epochs=4", "exec.ckpt_every=1", "exec.max_restarts=2",
        "exec.heartbeat_s=5.0"])
    baseline = run_baseline(spec, device=cuda)
    obs = run_faulted(spec, "kill", rank=1, at_epoch=2, ckpt_dir=str(tmp_path),
                      device=cuda)
    case = evaluate_case("kill", 1, 2, baseline, obs, 0.0)
    assert case["ok"], {k: v for k, v in case.items() if k != "events"}
    assert case["max_loss_delta"] == 0.0 and case["leaked_segments"] == []


@pytest.mark.gpu
def test_coo_backend_repeats_and_resumes_bitwise(cuda, tmp_path):
    """``agg_backend="coo"`` (specs/coo_fallback.json) adds in a fixed order
    on the card (ROADMAP C1): two runs are bitwise equal, and a run
    resumed from a checkpoint equals the uninterrupted one."""
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.run import RunSpec, build_session

    root = Path(__file__).resolve().parents[1]
    spec = lambda n: RunSpec.load(root / "specs" / "coo_fallback.json").with_overrides(
        [f"exec.epochs={n}"])
    runs = [build_session(spec(4), device=cuda) for _ in range(2)]
    hists = [s.fit(log_every=1) for s in runs]
    assert hists[0] == hists[1]
    build_session(spec(2), device=cuda).fit(log_every=1, ckpt_dir=tmp_path)
    resumed = build_session(spec(4), device=cuda)
    assert resumed.fit(log_every=1, ckpt_dir=tmp_path, resume=True) == hists[0][2:]
    for s in (runs[1], resumed):
        a, b = _flatten(s.trainer.train_state()), _flatten(runs[0].trainer.train_state())
        assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.gpu
def test_flagship_audit_clean_on_card(cuda):
    """The flagship spec's ranks' programs, recorded on the card, pass all
    five rules, with the kernels on their path launched."""
    from repro_torch.analysis.audit import audit_spec
    from repro_torch.run import RunSpec

    root = Path(__file__).resolve().parents[1]
    before = (sa.launches, sa.backward_launches, qp.pack_launches, qp.unpack_launches)
    res = audit_spec(RunSpec.load(root / "specs" / "flagship_hier_int2_overlap.json"),
                     steps=2, device=cuda)
    assert [str(f) for f in res["findings"]] == [] and res["rule_errors"] == []
    assert len(res["ran"]) == 5 and res["ranks"] == 8
    after = (sa.launches, sa.backward_launches, qp.pack_launches, qp.unpack_launches)
    assert all(a > b for a, b in zip(after, before)), (before, after)


@pytest.mark.gpu
def test_shard_map_rank_programs_on_card_equal_the_cpus(cuda):
    """The hierarchical flagship spec's rank programs lowered on the card
    (no fleet: the ``fake`` backend, every rank on this card) record, op
    for op, what the CPU's lowering records: kind, direction, layer,
    level, role, shape, dtype, bytes and group."""
    from repro_torch.run import RunSpec, build_session

    root = Path(__file__).resolve().parents[1]
    spec = RunSpec.load(root / "specs" / "flagship_hier_int2_overlap.json")
    lowered = {}
    for dev in (cuda, "cpu"):
        with build_session(spec, device=dev) as s:
            lowered[str(dev)] = s.lower()
    card, cpu = lowered[str(cuda)], lowered["cpu"]
    assert len(card.programs) == len(cpu.programs) == 8
    key = lambda o: (o.kind, o.direction, o.layer, o.level, o.role, o.shape, o.dtype,
                     o.bytes, o.chunks, o.group)
    for a, b in zip(card.programs, cpu.programs):
        assert a.rank == b.rank and [key(o) for o in a.ops] == [key(o) for o in b.ops]
    assert card.collective_order()["inter_a2a_before_compute"]


@pytest.mark.gpu
def test_exec_auto_on_card_equals_explicit_winner(cuda, tmp_path):
    """A session built with exec.auto trains bitwise as the tuner's winner
    spec written out, on the card."""
    from repro_torch.run import RunSpec, build_session, tune

    root = Path(__file__).resolve().parents[1]
    base = RunSpec.load(root / "specs" / "hier_int2_inter.json")
    result = tune(base, axes=["partition.refine=none,bucket-max", "schedule.inter_cd=1,2"],
                  top_k=2, probe_mode="vmap", device=cuda)
    path = tmp_path / "tuned.json"
    path.write_text(json.dumps(result))
    runs = []
    for spec in (base.with_overrides([f"exec.auto={path}"]),
                 RunSpec.from_dict(result["winner"]["spec"])):
        s = build_session(spec, device=cuda)
        runs.append((s.schedule, [s.train_epoch()["loss"] for _ in range(2)],
                     [v for p in s.trainer.params["layers"] for v in p.values()]))
    (sa_, la, pa), (sb_, lb, pb) = runs
    assert sa_ == sb_ and la == lb
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


# -- LM serving ---------------------------------------------------------------

LM_ARCHS = ("tinyllama-1.1b", "llama3.2-3b", "qwen2.5-32b", "starcoder2-3b",
            "qwen2-vl-2b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b",
            "zamba2-2.7b", "xlstm-350m", "whisper-small")


@pytest.mark.gpu
@pytest.mark.parametrize("name", LM_ARCHS)
def test_lm_serving_on_card_matches_cpu(cuda, name):
    """Smoke configs, bf16 as shipped: 8 teacher-forced serve_steps on the
    card against the CPU from the same weights within the family's bf16 bar
    × max|logit| (``serve_llm.bf16_bar``; a token whose experts flip on a
    near-tie is left out with the later positions that attend to it, and a
    flip that is no near-tie fails); the entry point's loop twice, bitwise.
    Whisper decodes against the cross K/V of frames drawn from a seed."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.launch.serve_llm import (RecordRoutes, bf16_bar, build_lm, draw_frames,
                                              generate, router_flips, teacher_forced)
    from repro_torch.utils.trees import tree_map

    cfg = get_smoke_arch(name)
    lm = build_lm(cfg, 0, cuda)
    toks = torch.randint(0, cfg.vocab_size, (4, 8), generator=torch.Generator().manual_seed(0))
    frames = draw_frames(cfg, 4, 0) if cfg.family == "audio" else None
    with RecordRoutes() as card_r:
        card = teacher_forced(lm.served, cfg, toks.to(cuda), frames).float().cpu()
    with RecordRoutes() as host_r:
        host = teacher_forced(tree_map(lambda t: t.cpu(), lm.served), cfg, toks,
                              frames).float()
    _, affected, not_ties = router_flips(card_r, host_r, cfg, 4, 8)
    assert not not_ties
    keep = torch.ones((4, 8), dtype=torch.bool)
    for b, s in affected:
        keep[b, s] = False
    assert (card - host)[keep].abs().max() <= bf16_bar(cfg) * host.abs().max()
    a, b = generate(lm, toks, 6, frames), generate(lm, toks, 6, frames)
    assert torch.isfinite(a.logits).all()
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.logits, b.logits)


# -- LM training --------------------------------------------------------------

LM_TRAIN_FAMILIES = {"dense": "tinyllama-1.1b", "vlm": "qwen2-vl-2b",
                     "moe": "granite-moe-1b-a400m", "mla": "deepseek-v2-lite-16b",
                     "hybrid": "zamba2-2.7b", "ssm": "xlstm-350m", "audio": "whisper-small"}


@pytest.mark.gpu
@pytest.mark.parametrize("family", list(LM_TRAIN_FAMILIES))
def test_lm_training_on_card_matches_cpu(cuda, family, monkeypatch):
    """Smoke configs, one train_step at num_microbatches=2 (its halves,
    loss_and_grads and adamw_update) on the card and on the CPU from the
    same parameters and batch. fp32: the loss within 1e-5 relative, every
    gradient, mu and nu leaf within 1e-5 x its tree's max (cuBLAS sums in
    another order than the CPU's BLAS). bf16: the loss within
    serve_llm.bf16_bar. Every gradient finite; two train_steps on the card
    bitwise equal."""
    from repro_torch.configs import get_smoke_arch
    from repro_torch.launch.serve_llm import bf16_bar, resolve_device
    from repro_torch.launch.train import lm_batch
    from repro_torch.models import common, init_params, loss_and_grads, train_step
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.utils.trees import tree_leaves, tree_map

    resolve_device(cuda)                      # TF32 off, as on the launcher's path
    cfg = get_smoke_arch(LM_TRAIN_FAMILIES[family])
    params = init_params(torch.Generator().manual_seed(0), cfg)
    seq = 32 + (cfg.vision_patches if cfg.family == "vlm" else 0)
    batch = lm_batch(cfg, 4, seq, torch.Generator().manual_seed(1))

    def on(tree, dev):
        return tree_map(lambda t: t.to(dev), tree)

    def run(dev):
        p, b = on(params, dev), on(batch, dev)
        loss, grads = loss_and_grads(p, cfg, b, num_microbatches=2)
        _, opt = adamw_update(grads, adamw_init(p), p, 3e-4, grad_clip=1.0)
        trees = on((grads, opt.mu, opt.nu), "cpu")
        assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(trees[0]))
        return float(loss), trees

    for dtype in (torch.float32, torch.bfloat16):
        monkeypatch.setattr(common, "COMPUTE_DTYPE", dtype)
        (card_loss, card), (host_loss, host) = run(cuda), run(torch.device("cpu"))
        rel = abs(card_loss - host_loss) / abs(host_loss)
        if dtype == torch.bfloat16:
            assert rel <= bf16_bar(cfg)
            continue
        assert rel <= 1e-5
        for got, want in zip(card, host):
            scale = max(float(w.abs().max()) for w in tree_leaves(want))
            assert max(float((g - w).abs().max()) for g, w in
                       zip(tree_leaves(got), tree_leaves(want))) <= 1e-5 * scale
    p, b = on(params, cuda), on(batch, cuda)
    (pa, oa, la), (pb, ob, lb) = (train_step(p, adamw_init(p), b, cfg, num_microbatches=2)
                                  for _ in range(2))
    assert torch.equal(la, lb)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves((pa, oa.mu, oa.nu)),
                                                 tree_leaves((pb, ob.mu, ob.nu))))


def _gcn_dryrun_on_card(cuda):
    """The check-overlap dry-run (rmat-10, 8 workers, 2 groups, Int2,
    --overlap --assert-overlap) on the card, and the kernel launches it
    made."""
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.dryrun import gcn_base_spec, run_gcn_dryrun

    spec = gcn_base_spec(8, scale=10).with_overrides(
        ["partition.groups=2", "schedule.overlap=true"])
    before = launch_counts()
    rec = run_gcn_dryrun(spec, save=False, assert_overlap=True, device=cuda)
    after = launch_counts()
    assert rec["status"] == "ok", rec.get("traceback")
    return rec, {k: after[k] - before[k] for k in after}


@pytest.mark.gpu
def test_gcn_dryrun_on_card_records_its_peak(cuda):
    rec, _ = _gcn_dryrun_on_card(cuda)
    assert isinstance(rec["memory"], int) and rec["memory"] > 0
    assert rec["device"] == torch.cuda.get_device_name(cuda)
    order = rec["collective_order"]
    assert order["wire_before_compute"] and order["inter_wire_before_compute"]
    assert rec["audit_findings"] == []
    assert (rec["collectives"]["all-to-all"]["result_bytes"]
            == rec["predicted_hlo_wire_bytes"]["total"])


@pytest.mark.gpu
def test_gcn_dryrun_cost_is_the_same_on_card_and_cpu(cuda):
    """The kernels' reads and writes count as one op a call on both
    devices (kernels.traffic), so the step's cost is the same figure."""
    from repro_torch.launch.dryrun import gcn_base_spec, run_gcn_dryrun

    card, _ = _gcn_dryrun_on_card(cuda)
    spec = gcn_base_spec(8, scale=10).with_overrides(
        ["partition.groups=2", "schedule.overlap=true"])
    host = run_gcn_dryrun(spec, save=False, assert_overlap=True, device="cpu")
    assert host["status"] == "ok", host.get("traceback")
    assert card["cost"] == host["cost"]
    assert card["collectives"] == host["collectives"]


@pytest.mark.gpu
def test_gcn_dryrun_on_card_launches_the_kernels(cuda):
    _, launched = _gcn_dryrun_on_card(cuda)
    for k in ("seg_aggregate", "seg_aggregate_backward", "quant_pack", "dequant_unpack"):
        assert launched[k] > 0, (k, launched)


@pytest.mark.gpu
@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_collectives_on_card_equal_the_plain_path(cuda, p, bits):
    """The quantized all-reduce, its tree version and the all-to-all on the
    card (quant_pack / dequant_unpack kernels) bitwise equal to the same
    calls on the CPU (the plain versions) with the same uniforms."""
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.sharding import (quantized_all_to_all, quantized_psum,
                                      quantized_psum_tree)

    gen = torch.Generator().manual_seed(p * 10 + bits)
    n = 3000
    rows = (n + (-n) % (p * 512)) // 128
    g = torch.randn((p, n), generator=gen) * 2
    u1 = torch.rand((p, rows, 128), generator=gen)
    u2 = torch.rand((p, rows // p, 128), generator=gen)
    x = torch.randn((p, p * 8, 100), generator=gen)
    u = torch.rand(x.shape, generator=gen)
    tree = {"a": torch.randn((p, 40), generator=gen), "b": torch.randn((p, 8, 16),
                                                                        generator=gen)}
    us = [(torch.rand((p, 4 * p, 128), generator=gen),
           torch.rand((p, 4, 128), generator=gen)) for _ in range(2)]
    before = (qp.pack_launches, qp.unpack_launches)
    card = (quantized_psum(g.to(cuda), bits=bits, u1=u1.to(cuda), u2=u2.to(cuda)),
            quantized_all_to_all(x.to(cuda), bits=bits, u=u.to(cuda)),
            quantized_psum_tree({k: v.to(cuda) for k, v in tree.items()}, bits=bits,
                                us=[(a.to(cuda), b.to(cuda)) for a, b in us]))
    assert (qp.pack_launches - before[0], qp.unpack_launches - before[1]) == (7, 7)
    host = (quantized_psum(g, bits=bits, u1=u1, u2=u2),
            quantized_all_to_all(x, bits=bits, u=u),
            quantized_psum_tree(tree, bits=bits, us=us))
    assert torch.equal(card[0].cpu(), host[0])
    assert torch.equal(card[1].cpu(), host[1])
    for k in tree:
        assert torch.equal(card[2][k].cpu(), host[2][k])


# -- the spans (core.record) on the card ------------------------------------------


@pytest.mark.gpu
def test_spans_leave_the_device_list_and_hold_the_index_backward(cuda, monkeypatch):
    """A period (a refresh and a stale epoch) of a hierarchical Int2 session
    under ``torch.profiler`` with CUDA activity lists the same device
    activities, by name and count, with the spans live as with their gate
    forced off; the send gather's and the label lookup's spans hold at
    least 90% of the device time of ``indexing_backward_kernel*``, and no
    more than the period's wall time."""
    from collections import Counter
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.train_products_paper import FLAGSHIP as TRAIN_FLAGSHIP
    from repro_torch.core import record
    from repro_torch.run import RunSpec, build_session

    session = build_session(RunSpec.from_dict(TRAIN_FLAGSHIP).with_overrides(
        ["graph.nodes=4096", "graph.feat_dim=100", "graph.classes=47",
         "model.hidden_dim=256", "model.num_layers=3"]), device=cuda)
    for _ in range(2):
        session.train_epoch()

    def period():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                session.train_epoch()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        return Counter(e.name for e in dev), dev, wall

    record.SPANS.steps.clear()
    live, dev, wall = period()
    steps = record.traced_steps()
    monkeypatch.setattr(record, "_profiler", SimpleNamespace(_is_profiler_enabled=False))
    gated, _, _ = period()
    assert [r.epoch for r in steps] == [2, 3] and len(record.SPANS.steps) == 2
    assert live == gated
    index_ms = sum(e.time_range.elapsed_us() for e in dev
                   if "indexing_backward_kernel" in e.name) * 1e-3
    spans_ms = sum(r.device_ms("gnn.exchange.send_gather") + r.device_ms("gnn.lp_embed")
                   for r in steps)
    assert index_ms > 0 and 0.9 * index_ms <= spans_ms <= wall * 1e3
