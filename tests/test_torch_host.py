"""The port's host-side NumPy copies against the JAX package, array for array,
and the guard that keeps JAX and ``repro`` out of the port."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.run.session as jsession
from repro.graph import structure as jst
from repro.kernels.ops import padded_device_bucketed as j_padded
from repro.serve import ServeSpec as JServeSpec
from repro.serve import extract_ego as j_extract_ego
from repro.serve.server import ShapeLadder as JShapeLadder

import repro_torch.run.session as tsession
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
            "graph/partition.py", "run/sources.py", "serve/spec.py",
            "serve/egonet.py", "serve/cache.py", "configs/graphsage_paper.py"]


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
    pt = tsession.build_partition(ts.run, gt)
    assert np.array_equal(pj, pt) and pt.dtype == np.int32


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
            "repro_torch.parity; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
