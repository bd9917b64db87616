"""The port's host-side NumPy copies against the JAX package, array for array,
and the guard that keeps JAX and ``repro`` out of the port."""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.run.session as jsession
from repro.core.exchange import host_recv_bucketed as j_host_recv_bucketed
from repro.core.trainer import prepare_distributed_host as j_prepare_host
from repro.graph import structure as jst
from repro.graph.remote import build_halo_plan as j_build_halo_plan
from repro.run.spec import RunSpec as JRunSpec
from repro.kernels.ops import padded_device_bucketed as j_padded
from repro.serve import ServeSpec as JServeSpec
from repro.serve import extract_ego as j_extract_ego
from repro.serve.server import ShapeLadder as JShapeLadder

import repro_torch.run.session as tsession
from repro_torch.core.exchange import host_recv_bucketed as t_host_recv_bucketed
from repro_torch.core.trainer import prepare_distributed_host as t_prepare_host
from repro_torch.graph.remote import build_halo_plan as t_build_halo_plan
from repro_torch.run.spec import RunSpec as TRunSpec
from repro_torch.configs.serve_products_paper import OVERRIDES, serve_products_paper
from repro_torch.graph import structure as tst
from repro_torch.kernels.ops import padded_device_bucketed as t_padded
from repro_torch.serve import ServeSpec as TServeSpec
from repro_torch.serve import extract_ego as t_extract_ego
from repro_torch.serve.server import ShapeLadder as TShapeLadder

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

# Modules the port carries over verbatim, imports pointing into repro_torch.
VERBATIM = ["utils/registry.py", "graph/structure.py", "graph/generators.py",
            "graph/partition.py", "graph/mvc.py", "graph/remote.py",
            "run/sources.py", "serve/spec.py", "serve/egonet.py", "serve/cache.py",
            "configs/graphsage_paper.py", "launch/shm_store.py", "core/perf_model.py",
            "data/pipeline.py", "data/__init__.py"]


def _run_json(graph=None, partition=None):
    return {
        "graph": {"source": "sbm", "nodes": 192, "classes": 4, "feat_dim": 8,
                  "avg_degree": 6, "norm": "mean", "seed": 3, **(graph or {})},
        "partition": {"nparts": 4, **(partition or {})},
        "model": {"model": "sage", "hidden_dim": 16, "num_layers": 2},
    }


def _specs(**kw):
    d = {"run": _run_json(**kw), "serve": {"batch_size": 4, "min_nodes": 32}}
    return (JServeSpec.from_json(json.dumps(d)),
            TServeSpec.from_json(json.dumps(d)))


def _assert_graph_equal(gj, gt):
    assert gj.num_nodes == gt.num_nodes
    for name in ("src", "dst", "edge_weight", "labels", "train_mask"):
        a, b = getattr(gj, name), getattr(gt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(a, b) and a.dtype == b.dtype, name


def _assert_csr_equal(cj, ct):
    assert (cj.num_rows, cj.num_cols) == (ct.num_rows, ct.num_cols)
    for name in ("indptr", "indices", "weights"):
        a, b = getattr(cj, name), getattr(ct, name)
        assert np.array_equal(a, b) and a.dtype == b.dtype, name


def _assert_ell_equal(ej, et):
    assert (ej.num_rows, ej.num_cols, ej.nnz) == (et.num_rows, et.num_cols, et.nnz)
    assert ej.ks == et.ks
    for bj, bt in zip(ej.buckets, et.buckets):
        for name in ("rows", "idx", "w"):
            a, b = getattr(bj, name), getattr(bt, name)
            assert np.array_equal(a, b) and a.dtype == b.dtype, (bj.k, name)


@pytest.mark.parametrize("rel", VERBATIM)
def test_copies_are_verbatim(rel):
    orig = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    assert port == orig.replace("repro.", "repro_torch.")


def test_token_pipeline_equal():
    from repro.data import synthetic_token_batches as j_batches
    from repro_torch.data import synthetic_token_batches as t_batches

    for vocab, b, s in ((512, 3, 70), (32000, 2, 4096)):
        for bj, bt in zip(j_batches(vocab, b, s, 3, seed=5), t_batches(vocab, b, s, 3, seed=5)):
            assert bj.keys() == bt.keys() == {"tokens"}
            assert np.array_equal(bj["tokens"], bt["tokens"])
            assert bj["tokens"].dtype == bt["tokens"].dtype == np.int32


def test_gcn_dataset_equal():
    from repro.data import make_gcn_dataset as j_make
    from repro_torch.data import make_gcn_dataset as t_make

    dj, dt = j_make("tiny", seed=2), t_make("tiny", seed=2)
    assert (dj.name, dj.num_classes) == (dt.name, dt.num_classes)
    _assert_graph_equal(dj.graph, dt.graph)
    assert np.array_equal(dj.features, dt.features) and dj.features.dtype == dt.features.dtype


@pytest.mark.parametrize("graph", [
    {},
    {"norm": "gcn", "features": "random"},
    {"source": "rmat", "scale": 7, "edge_factor": 4, "norm": "none"},
])
def test_build_graph_equal(graph):
    js, ts = _specs(graph=graph)
    gj, xj = jsession.build_graph(js.run)
    gt, xt = tsession.build_graph(ts.run)
    _assert_graph_equal(gj, gt)
    assert np.array_equal(xj, xt) and xj.dtype == xt.dtype


@pytest.mark.parametrize("partition", [
    {"nparts": 4},
    {"nparts": 4, "refine": "bucket-max"},
    {"nparts": 8, "groups": 2},
    {"nparts": 8, "groups": 2, "refine": "bucket-max"},
])
def test_partition_labels_equal(partition):
    js, ts = _specs(partition=partition)
    gj, _ = jsession.build_graph(js.run)
    gt, _ = tsession.build_graph(ts.run)
    pj = np.asarray(jsession.build_partition(js.run, gj).part)
    pt = tsession.build_partition(ts.run, gt).part
    assert np.array_equal(pj, pt) and pt.dtype == pj.dtype


def _graph_pair():
    js, ts = _specs()
    gj, _ = jsession.build_graph(js.run)
    gt, _ = tsession.build_graph(ts.run)
    return gj, gt


def test_bucketed_ell_and_block_diag_equal():
    gj, gt = _graph_pair()
    cj, ct = gj.csr_by_dst(), gt.csr_by_dst()
    _assert_csr_equal(cj, ct)
    _assert_ell_equal(jst.bucketed_ell_from_csr(cj), tst.bucketed_ell_from_csr(ct))
    egos_j = [j_extract_ego(cj, [t], 2) for t in (0, 7, 50)]
    egos_t = [t_extract_ego(ct, [t], 2) for t in (0, 7, 50)]
    mj = jst.block_diag_csrs([e.csr for e in egos_j])
    mt = tst.block_diag_csrs([e.csr for e in egos_t])
    _assert_csr_equal(mj, mt)
    _assert_ell_equal(jst.bucketed_ell_from_csr(mj), tst.bucketed_ell_from_csr(mt))
    sj = jst.stack_bucketed_ells([jst.bucketed_ell_from_csr(mj)])
    stt = tst.stack_bucketed_ells([tst.bucketed_ell_from_csr(mt)])
    for a, b in zip(sj, stt):
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert np.array_equal(x, y) and x.dtype == y.dtype


@pytest.mark.parametrize("fanouts", [None, [3, 2]])
def test_extract_ego_equal(fanouts):
    gj, gt = _graph_pair()
    cj, ct = gj.csr_by_dst(), gt.csr_by_dst()
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for targets in ([0], [3, 90], [11, 12, 13]):
        ej = j_extract_ego(cj, targets, 2, fanouts=fanouts, rng=rj)
        et = t_extract_ego(ct, targets, 2, fanouts=fanouts, rng=rt)
        assert np.array_equal(ej.nodes, et.nodes)
        assert (ej.num_targets, ej.num_expanded) == (et.num_targets, et.num_expanded)
        _assert_csr_equal(ej.csr, et.csr)


def test_shape_ladder_equal():
    gj, gt = _graph_pair()
    cj, ct = gj.csr_by_dst(), gt.csr_by_dst()
    deg = cj.row_degrees()
    lj = JShapeLadder(int(deg.max()), cj.nnz / gj.num_nodes, 32)
    lt = TShapeLadder(int(deg.max()), ct.nnz / gt.num_nodes, 32)
    for c in (32, 64, 256, 1024):
        assert lj.caps(c) == lt.caps(c)
    for targets in ([0], [1, 2, 3, 4, 5, 6, 7, 8]):
        ej = jst.bucketed_ell_from_csr(j_extract_ego(cj, targets, 2).csr)
        et = tst.bucketed_ell_from_csr(t_extract_ego(ct, targets, 2).csr)
        assert lj.class_for(ej) == lt.class_for(et)


def test_padded_device_bucketed_equal():
    gj, gt = _graph_pair()
    cj, ct = gj.csr_by_dst(), gt.csr_by_dst()
    targets = [4, 9, 33]
    ej = jst.bucketed_ell_from_csr(jst.block_diag_csrs(
        [j_extract_ego(cj, [t], 2).csr for t in targets]))
    et = tst.bucketed_ell_from_csr(tst.block_diag_csrs(
        [t_extract_ego(ct, [t], 2).csr for t in targets]))
    deg = cj.row_degrees()
    ladder = TShapeLadder(int(deg.max()), ct.nnz / gt.num_nodes, 32)
    _, caps = ladder.class_for(et)
    dj, dt = j_padded(ej, caps), t_padded(et, caps, device="cpu")
    assert len(dj.buckets) == len(dt.buckets) == len(caps)
    real = {b.k: b.rows.shape[0] for b in et.buckets}
    for (k, _), bj, bt in zip(caps, dj.buckets, dt.buckets):
        for name in ("rows", "idx", "w"):
            a, b = np.asarray(getattr(bj, name)), getattr(bt, name).numpy()
            assert np.array_equal(a, b) and a.dtype == b.dtype, (k, name)
        assert bt.n == real.get(k, 0)


def test_serve_spec_roundtrip_and_hash():
    js, ts = _specs(partition={"nparts": 8, "groups": 2})
    over = ["serve.fanouts=4,2", "serve.max_staleness=3", "exec.seed=7"]
    js, ts = js.with_overrides(over), ts.with_overrides(over)
    assert ts.to_dict() == js.to_dict()
    assert ts.content_hash() == js.content_hash()
    assert ts.run.content_hash() == js.run.content_hash()
    assert TServeSpec.from_json(ts.to_json()) == ts
    assert ts.describe() == js.describe()


def test_serve_products_paper_is_flagship_with_overrides():
    flagship = ROOT / "specs" / "serve_flagship.json"
    spec = serve_products_paper()
    assert spec == TServeSpec.load(flagship).with_overrides(OVERRIDES)
    assert spec.content_hash() == JServeSpec.load(flagship).with_overrides(
        OVERRIDES).content_hash()
    m, g = spec.run.model, spec.run.graph
    assert (m.model, m.num_layers, m.hidden_dim) == ("sage", 3, 256)
    assert (g.nodes, g.feat_dim, g.classes) == (16384, 100, 47)
    assert spec.serve.resolved_fanouts(3) == [15, 10, 5]


# -- the halo plans ------------------------------------------------------------


def _assert_arrays_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and np.array_equal(a, b), what


def _assert_plan_equal(pj, pt, what):
    for name in ("nparts", "rows_per_pair"):
        assert getattr(pj, name) == getattr(pt, name), (what, name)
    for name in ("send_gather_idx", "send_gather_mask", "pre_src", "pre_slot",
                 "pre_weight", "recv_row", "recv_dst", "recv_weight"):
        _assert_arrays_equal(getattr(pj, name), getattr(pt, name), (what, name))


def _assert_stacked_ells_equal(sj, st, what):
    assert len(sj) == len(st), what
    for a, b in zip(sj, st):
        assert a[0] == b[0], what
        for x, y in zip(a[1:], b[1:]):
            _assert_arrays_equal(x, y, what)


@pytest.mark.parametrize("partition", [
    {"nparts": 4},
    {"nparts": 8, "groups": 2},
    {"nparts": 8, "groups": 2, "strategy": "pre", "refine": "bucket-max"},
])
def test_halo_plans_equal(partition):
    """``graph/remote.py``'s copy builds the reference's plans array for
    array: CommStats, the flat HaloPlan or both levels of the HierHaloPlan,
    the stacked worker arrays and the bucketed receive layouts."""
    run = _run_json(partition=partition)
    js, ts = JRunSpec.from_dict(run), TRunSpec.from_dict(run)
    gj, xj = jsession.build_graph(js)
    gt, xt = tsession.build_graph(ts)
    pgj, pgt = jsession.build_partition(js, gj), tsession.build_partition(ts, gt)
    assert type(pgj).__name__ == type(pgt).__name__
    sj, st = pgj.stats, pgt.stats
    for name in ("nparts", "vanilla", "pre", "post", "hybrid", "selected",
                 "padded_rows_per_pair", "num_groups", "group_size", "intra_rows",
                 "inter_rows", "flat_inter_rows"):
        assert getattr(sj, name) == getattr(st, name), name
    _assert_arrays_equal(sj.per_pair_hybrid, st.per_pair_hybrid, "per_pair_hybrid")
    assert sj.as_dict() == st.as_dict()
    hj, ht = j_prepare_host(gj, xj, pgj), t_prepare_host(gt, xt, pgt)
    for name in ("x", "labels", "train_mask", "eval_mask", "owned_mask", "coo_src",
                 "coo_dst", "coo_w"):
        _assert_arrays_equal(getattr(hj, name), getattr(ht, name), name)
    assert hj.max_owned == ht.max_owned
    _assert_stacked_ells_equal(hj.ell_stacked, ht.ell_stacked, "local ell")
    _assert_stacked_ells_equal(hj.ell_t_stacked, ht.ell_t_stacked, "local ell_t")
    if "groups" in partition:
        assert (hj.hier_plan.num_groups, hj.hier_plan.group_size) == (
            ht.hier_plan.num_groups, ht.hier_plan.group_size)
        levels = [("intra", hj.hier_plan.intra, ht.hier_plan.intra),
                  ("inter", hj.hier_plan.inter, ht.hier_plan.inter)]
    else:
        levels = [("flat", hj.plan, ht.plan)]
        _assert_plan_equal(j_build_halo_plan(pgj), t_build_halo_plan(pgt), "unpadded")
    for what, pj, pt in levels:
        _assert_plan_equal(pj, pt, what)
        for a, b in zip(j_host_recv_bucketed(pj, hj.max_owned),
                        t_host_recv_bucketed(pt, ht.max_owned)):
            _assert_stacked_ells_equal(a, b, (what, "recv"))


def test_to_dist_config_equal():
    from repro.core import DistConfig as JDistConfig

    for partition, schedule in (({"nparts": 4}, {"bits": 2, "cd": 3}),
                                ({"nparts": 8, "groups": 2},
                                 {"inter_bits": 2, "inter_cd": 2, "overlap": True})):
        run = dict(_run_json(partition=partition), schedule=schedule)
        js, ts = JRunSpec.from_dict(run), TRunSpec.from_dict(run)
        dj = js.schedule.to_dist_config(js.partition, lr=0.05)
        dt = ts.schedule.to_dist_config(ts.partition, lr=0.05)
        assert isinstance(dj, JDistConfig)
        assert dataclasses.asdict(dj) == dataclasses.asdict(dt)
        assert dj.schedule().describe() == dt.schedule().describe()


# -- the shared-memory store and the perf model (A1) -----------------------


def _toy_op_table():
    return [{"id": "t.L0.flat.x", "pairs": [[0, 1, 96], [1, 0, 96], [0, 0, 96]]},
            {"id": "t.grads", "pairs": [[0, 1, 13], [1, 0, 13]]}]


def test_plan_mailbox_equal():
    from repro.launch.shm_store import plan_mailbox as j_plan
    from repro_torch.launch.shm_store import plan_mailbox as t_plan

    for nprocs in (0, 2, 8):
        assert j_plan(_toy_op_table(), nprocs=nprocs) == t_plan(_toy_op_table(),
                                                                nprocs=nprocs)


def test_shm_arena_and_mailbox_round_trip():
    """Publish a store, attach it as a rank would, post and collect through
    the mailboxes, and leave no segment behind."""
    from repro_torch.launch import shm_store as ts

    rng = np.random.default_rng(0)
    arrays = {"x": rng.normal(size=(2, 5, 3)).astype(np.float32),
              "labels": np.arange(10, dtype=np.int32).reshape(2, 5),
              "mask": rng.random((2, 5)) < 0.5}
    token = ts.run_token()
    arena, mb, frag = ts.publish_store(token, arrays, _toy_op_table(), nprocs=2)
    try:
        assert ts.leaked_segments(token) == sorted([f"{token}-mail", f"{token}-store"])
        view = ts.ShmArena.attach(frag["store"]["name"], frag["store"]["table"])
        for k, a in arrays.items():
            got = view.views()[k]
            assert got.dtype == a.dtype and np.array_equal(got, a)
        view.close()
        r0, r1 = (ts.Mailboxes.attach(frag["mailbox"]["name"], frag["mailbox"], r)
                  for r in (0, 1))
        payload = np.arange(24, dtype=np.float32)
        r0.post("t.L0.flat.x", 1, payload)
        assert np.array_equal(r1.collect("t.L0.flat.x", 0).view(np.float32), payload)
        r1.complete("t.L0.flat.x")
        assert r0.bytes_written == 96 and mb.heartbeats()[0] == 1
        with pytest.raises(ValueError, match="holds 13 bytes"):
            r0.post("t.grads", 1, payload)
        mb.recover()
        with pytest.raises(ts.TransportRecover):
            r1.collect("t.grads", 0)
        for h in (r0, r1):
            h.close()
    finally:
        mb.close()
        arena.close()
    assert ts.leaked_segments(token) == []


def test_perf_model_equal():
    """Every public function of the perf model's copy against the
    reference's on the same inputs."""
    from repro.core import perf_model as jpm
    from repro_torch.core import perf_model as tpm

    rng = np.random.default_rng(1)
    vol = rng.integers(0, 500, size=(4, 4)).astype(np.float64)
    nnz, rows = rng.integers(100, 900, 4), rng.integers(50, 200, 4)
    for name in ("abci-xeon6148", "fugaku-a64fx", "tpu-v5e-ici"):
        hj, ht = jpm.get_hardware(name), tpm.get_hardware(name)
        assert dataclasses.asdict(hj) == dataclasses.asdict(ht)
        assert hj.beta == ht.beta
        np.testing.assert_array_equal(jpm.comm_time_matrix(vol, 64, hj, 2),
                                      tpm.comm_time_matrix(vol, 64, ht, 2))
        assert jpm.comm_time(vol, 64, hj) == tpm.comm_time(vol, 64, ht)
        assert (jpm.quant_comm_time(vol, 64, hj, 2, rows)
                == tpm.quant_comm_time(vol, 64, ht, 2, rows))
        assert jpm.delta_ratio(300.0, 64, 2, hj) == tpm.delta_ratio(300.0, 64, 2, ht)
        for bits in (0, 2):
            assert (jpm.epoch_time_model(vol, nnz, rows, 100, 256, 3, hj, bits)
                    == tpm.epoch_time_model(vol, nnz, rows, 100, 256, 3, ht, bits))
        assert (jpm.hier_epoch_time(1e6, 3e5, nnz, rows, 100, 256, 3, hj)
                == tpm.hier_epoch_time(1e6, 3e5, nnz, rows, 100, 256, 3, ht))
    assert jpm.speedup_model(100.0, 50.0, 16.0, 0.3) == tpm.speedup_model(
        100.0, 50.0, 16.0, 0.3)
    custom = tpm.HardwareSpec("custom", bw_comm=1e9, latency=1e-6, th_cal=1e11)
    assert tpm.register_hardware(custom) is tpm.get_hardware("custom")
    measured = tpm.measure_local_hardware(size_mb=1, iters=1)
    assert measured.bw_comm > 0 and measured.latency > 0 and measured.th_cal > 0


# -- the multiproc op table ---------------------------------------------------


def _op_table_pair(spec_json):
    """(reference op table, port op table) of a spec, from the port's own
    partition (the plans are held equal above) and parameter count."""
    from repro.launch.multiproc import build_op_table as j_table
    from repro_torch.core import model as TM
    from repro_torch.launch.multiproc import build_op_table as t_table
    from repro_torch.optim.adamw import tree_leaves

    js, ts = JRunSpec.from_dict(spec_json), TRunSpec.from_dict(spec_json)
    gt, xt = tsession.build_graph(ts)
    hwd = t_prepare_host(gt, xt, tsession.build_partition(ts, gt))
    plans = ({"flat": hwd.plan} if hwd.plan is not None else
             {"intra": hwd.hier_plan.intra, "inter": hwd.hier_plan.inter})
    wire_rows = {k: int(p.send_gather_idx.shape[-1]) for k, p in plans.items()}
    cfg = ts.model.to_gcn_config(ts.graph, ts.schedule)
    nparams = sum(t.numel() for t in tree_leaves(TM.init_params(cfg)))
    dims = cfg.dims()[: cfg.num_layers]
    tables = []
    for spec, table in ((js, j_table), (ts, t_table)):
        dc = spec.schedule.to_dist_config(spec.partition, lr=spec.exec.lr)
        tables.append(table(dc.schedule(), dc.sync_fp32().schedule(),
                            spec.partition.nparts, cfg.num_layers, dims, wire_rows,
                            nparams))
    return tables, dims


_TOY_FLAT = {"graph": {"source": "sbm", "nodes": 96, "classes": 4, "feat_dim": 16,
                       "feat_noise": 2.0, "homophily": 0.8, "norm": "mean"},
             "partition": {"nparts": 2}, "schedule": {"bits": 2},
             "model": {"model": "sage", "hidden_dim": 16, "num_layers": 2,
                       "dropout": 0.0, "label_prop": False},
             "exec": {"mode": "multiproc", "nprocs": 2}}
_TOY_HIER = {"graph": {"source": "sbm", "nodes": 128, "classes": 4, "feat_dim": 16,
                       "feat_noise": 2.0, "homophily": 0.8, "norm": "mean"},
             "partition": {"nparts": 4, "groups": 2},
             "schedule": {"inter_bits": 2, "inter_cd": 2, "overlap": True},
             "model": {"model": "sage", "hidden_dim": 16, "num_layers": 2},
             "exec": {"mode": "multiproc", "nprocs": 4}}


def _paper_spec_json():
    from repro_torch.configs.train_products_paper import train_products_paper
    return train_products_paper("exec.mode=multiproc").to_dict()


@pytest.mark.parametrize("spec_json", [_TOY_FLAT, _TOY_HIER, None],
                         ids=["flat_p2", "hier_p4", "train_products_paper"])
def test_op_table_equal(spec_json):
    """The port's mailbox op table is the reference's, op for op and pair
    for pair; a slot's bytes differ only in a quantized chunk's payload at
    a width that does not fill whole words (layer 0's F = 100 at Int2):
    the reference sends a byte per value, the port the kernel's
    ceil(F/16) words."""
    (jt, tt), dims = _op_table_pair(_paper_spec_json() if spec_json is None
                                    else spec_json)
    assert [op["id"] for op in jt] == [op["id"] for op in tt]
    ragged = 0
    for jop, top in zip(jt, tt):
        assert [p[:2] for p in jop["pairs"]] == [p[:2] for p in top["pairs"]]
        jb, tb = jop["pairs"][0][2], top["pairs"][0][2]
        assert all(p[2] == jb for p in jop["pairs"]) and all(
            p[2] == tb for p in top["pairs"])
        layer = int(jop["id"].split(".")[1][1:]) if ".L" in jop["id"] else None
        f = dims[layer] if layer is not None else 0
        if jb != tb:
            # Only a quantized chunk's payload at a ragged width differs.
            assert f % 16 != 0, jop["id"]
            rows = (jb - tb) // (f - 4 * -(-f // 16))
            assert jb == rows * f + rows // 4 * 8, jop["id"]
            assert tb == rows * -(-f // 16) * 4 + rows // 4 * 8, jop["id"]
            ragged += 1
    # train_products_paper: layer 0's Int2 inter a2a, forward and backward
    assert ragged == (0 if spec_json is not None else 2)


# -- the import guard -------------------------------------------------------

_PORT_FILES = sorted((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path}: imports {bad}"


def test_port_serve_loads_without_jax():
    code = ("import sys, repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.run, repro_torch.parity, "
            "repro_torch.launch.multiproc, repro_torch.launch.chaos, "
            "repro_torch.core.halo, repro_torch.core.perf_model, repro_torch.data; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
