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
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.serve_products_paper import FLAGSHIP
from repro_torch.graph.structure import bucketed_ell_from_csr, coo_to_csr
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
    """The ten stacked layouts of the small flagship spec (the layouts
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
                 (plan.pre_ell, m, wire), (plan.pre_ell_t, wire, m)]
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
