"""The serving slice as a whole: a JAX ``GNNServer`` and the port's, on the CPU,
built on the same small ServeSpec with the JAX parameters carried across.

Tolerance against the JAX server: rtol = atol = 1e-5 (fp32 sums in other
orders, as in test_torch_model.py). Within the port, full-fanout served
logits must equal its own full-batch logits exactly (``np.array_equal``),
the property the JAX server asserts.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.serve import ServeSpec as JServeSpec
from repro.serve import build_server as j_build_server

from repro_torch.kernels import seg_aggregate as sa
from repro_torch.run.session import build_graph, build_partition
from repro_torch.serve import GNNServer, ServeError
from repro_torch.serve import ServeSpec as TServeSpec
from repro_torch.serve import build_server
from repro_torch.parity import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)

SPEC = {
    "run": {
        "graph": {"source": "sbm", "nodes": 160, "classes": 4, "feat_dim": 8,
                  "avg_degree": 6, "norm": "mean", "seed": 3},
        "partition": {"nparts": 4, "groups": 2},
        "model": {"model": "sage", "hidden_dim": 16, "num_layers": 2},
    },
    "serve": {"batch_size": 4, "min_nodes": 32, "max_staleness": 1},
}
REQUESTS = [[3], [17], [40, 41], [99], [5], [150], [77]]


def _pair(*over):
    jspec = JServeSpec.from_json(json.dumps(SPEC)).with_overrides(list(over))
    tspec = TServeSpec.from_json(json.dumps(SPEC)).with_overrides(list(over))
    jserver = j_build_server(jspec)
    g, x = build_graph(tspec.run)
    cfg = tspec.run.model.to_gcn_config(tspec.run.graph, tspec.run.schedule)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jserver.params))
    tserver = GNNServer(cfg, g, x, params, serve_cfg=tspec.serve,
                        part=build_partition(tspec.run, g).part, device="cpu")
    return jserver, tserver


@pytest.mark.parametrize("fanouts", ["full", "3,2"])
def test_serve_batch_matches_jax(fanouts):
    jserver, tserver = _pair(f"serve.fanouts={fanouts}")
    for rounds in range(2):     # the second round reads the warm cache
        got = tserver.serve_batch(REQUESTS)
        expect = jserver.serve_batch(REQUESTS)
        assert len(got) == len(expect) == len(REQUESTS)
        for g, e in zip(got, expect):
            assert g.shape == e.shape
            np.testing.assert_allclose(g, np.asarray(e), **TOL)
    assert tserver.cache.stats() == jserver.cache.stats()
    ts, js = tserver.stats(), jserver.stats()
    for key in ("requests_served", "batches_dispatched", "shape_ladder"):
        assert ts[key] == js[key]
    assert 1 <= len(ts["shape_classes"]) and js["compiled_programs"] >= 1


def test_served_equals_own_full_batch_bitwise():
    _, tserver = _pair()
    full = tserver.full_batch_logits()
    served = tserver.serve_batch(REQUESTS)
    for req, logits in zip(REQUESTS, served):
        assert np.array_equal(logits, full[np.asarray(req)])
    assert tserver.check_parity([1, 2, 3, 4])


def test_full_batch_matches_jax():
    jserver, tserver = _pair()
    np.testing.assert_allclose(tserver.full_batch_logits(),
                               np.asarray(jserver.full_batch_logits()), **TOL)


def test_cpu_serving_launches_no_kernel():
    _, tserver = _pair("serve.fanouts=3,2")
    before = sa.launches
    tserver.serve_batch(REQUESTS[:2])
    assert sa.launches == before


def test_build_server_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    spec = TServeSpec.from_json(json.dumps(SPEC))
    with pytest.raises(ServeError, match="no CUDA card"):
        build_server(spec)
    with pytest.raises(ServeError, match="no CUDA card"):
        build_server(spec, device="cuda")


def test_build_server_on_cpu_and_unported_options(tmp_path):
    spec = TServeSpec.from_json(json.dumps(SPEC))
    server = build_server(spec, device="cpu")
    assert server.serve_batch([[0]])[0].shape == (1, 4)
    # GAT serves (tests/test_torch_gat.py holds it to the JAX server).
    gat = build_server(spec.with_overrides(["model.model=gat", "model.hidden_dim=16"]),
                       device="cpu")
    assert gat.serve_batch([[0]])[0].shape == (1, 4)
    # serve.ckpt restores (tests/test_torch_ckpt.py); a directory without a
    # checkpoint is refused.
    with pytest.raises(ServeError, match="no loadable checkpoint"):
        build_server(spec.with_overrides([f"serve.ckpt={tmp_path}"]), device="cpu")


def test_launch_serve_cli_on_cpu(capsys):
    from pathlib import Path

    from repro_torch.launch.serve import main

    spec = Path(__file__).resolve().parents[1] / "specs" / "serve_flagship.json"
    assert main(["--spec", str(spec), "--device", "cpu", "--requests", "6",
                 "--set", "serve.batch_size=4"]) == 0
    out = capsys.readouterr().out
    assert "served 6 requests" in out and "kernel_launches=0" in out
    assert "bit-identical" in out
