"""GAT in the port against ``repro.core.layers``' GAT, and GAT serving.

The layer on the dense ELL (``gat_aggregate``) and on the degree-bucketed
layout (``gat_aggregate_bucketed``), values and gradients (JAX's
``jax.grad`` against torch autograd), at 1 and 4 heads, on a graph with a
degree-0 row and a hub. Then GAT served by the port: bitwise equal to its
own full-batch forward (the JAX server's guarantee,
``tests/test_serving.py::test_served_parity_gat``) and within 1e-5 of the
JAX server's logits from the same parameters.

Tolerance: rtol = atol = 1e-5, fp32 sums of the two frameworks in other
orders.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import layers as JL
from repro.core import model as JM
from repro.graph.structure import (bucketed_ell_from_csr as j_bucketed,
                                   coo_to_csr as j_coo_to_csr,
                                   ell_from_csr as j_ell_from_csr,
                                   stack_bucketed_ells as j_stack)
from repro.kernels.seg_aggregate import device_bucketed as j_device_bucketed
from repro.serve import ServeSpec as JServeSpec
from repro.serve import build_server as j_build_server

from repro_torch.core import layers as TL
from repro_torch.core import model as TM
from repro_torch.core.trainer import GAT_NOT_DISTRIBUTED
from repro_torch.graph.structure import (bucketed_ell_from_csr, coo_to_csr,
                                         ell_from_csr, stack_bucketed_ells)
from repro_torch.kernels.seg_aggregate import device_bucketed
from repro_torch.parity import params_from_jax
from repro_torch.run import RunSpec, build_session
from repro_torch.run.session import build_graph, build_partition
from repro_torch.serve import GNNServer
from repro_torch.serve import ServeSpec as TServeSpec
from repro_torch.serve import build_server

TOL = dict(rtol=1e-5, atol=1e-5)
N, D_IN, D_OUT = 40, 12, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(seed):
    """Mean-normalized COO with a degree-0 row (3) and a hub (row 7)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 160)
    dst = np.concatenate([rng.integers(0, N, 120), np.full(40, 7)])
    keep = dst != 3
    src, dst = src[keep], dst[keep]
    w = (1.0 / np.bincount(dst, minlength=N)[dst]).astype(np.float32)
    return src, dst, w


def _layer(heads, seed):
    p = JL.init_layer(jax.random.PRNGKey(seed), "gat", D_IN, D_OUT, heads)
    p["b"] = jnp.asarray(np.random.default_rng(seed).normal(size=D_OUT), jnp.float32)
    h = np.random.default_rng(seed + 1).normal(size=(N, D_IN)).astype(np.float32)
    g = np.random.default_rng(seed + 2).normal(size=(N, D_OUT)).astype(np.float32)
    return p, h, g


def _layouts(src, dst, w):
    """(jax dense, port dense, jax bucketed, port bucketed)."""
    jcsr = j_coo_to_csr(src, dst, w, N, N)
    tcsr = coo_to_csr(src, dst, w, N, N)
    ji, jw, jv = j_ell_from_csr(jcsr)
    ti, tw, tv = ell_from_csr(tcsr)
    jb = j_device_bucketed(j_stack([j_bucketed(jcsr)]), squeeze=True)
    tb = device_bucketed(stack_bucketed_ells([bucketed_ell_from_csr(tcsr)]), device="cpu")
    return ((jnp.asarray(ji), jnp.asarray(jv)),
            (torch.from_numpy(ti), torch.from_numpy(tv)), jb, tb)


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("layout", ["dense", "bucketed"])
def test_gat_layer_values_and_grads_match_jax(heads, layout):
    src, dst, w = _graph(heads)
    jdense, tdense, jb, tb = _layouts(src, dst, w)
    jp, h, g = _layer(heads, 7 * heads)

    def jfn(p, x):
        if layout == "dense":
            out = JL.gat_aggregate(p, x, *jdense, heads)
        else:
            out = JL.gat_aggregate_bucketed(p, x, jb, N, heads)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(h))
    tp = {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in jp.items()}
    th = torch.tensor(h, requires_grad=True)
    if layout == "dense":
        tout = TL.gat_aggregate(tp, th, *tdense, heads)
    else:
        tout = TL.gat_aggregate_bucketed(tp, th, tb, N, heads)
    keys = ["a_dst", "a_src", "b", "w"]          # the layer's; LayerNorm's are the model's
    tgrads = torch.autograd.grad((tout * torch.from_numpy(g)).sum(),
                                 [tp[k] for k in keys] + [th])
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), **TOL)
    # The degree-0 row is its bias alone, the hub row a real average.
    np.testing.assert_array_equal(tout.detach().numpy()[3], np.asarray(jp["b"]))
    for k, tg in zip(keys, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jgrads[0][k]), **TOL,
                                   err_msg=k)
    np.testing.assert_allclose(tgrads[-1].numpy(), np.asarray(jgrads[1]), **TOL)


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_kernel_form_matches_autograd_form(heads):
    """Without autograd recording the weighted sum runs as one stacked
    ``seg_aggregate`` (heads stacked); it equals the einsum form within
    1e-5 and is taken only when no gradient is needed."""
    src, dst, w = _graph(10 + heads)
    _, _, _, tb = _layouts(src, dst, w)
    jp, h, _ = _layer(heads, 3)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    with torch.no_grad():
        stacked = TL.gat_aggregate_bucketed(tp, torch.from_numpy(h), tb, N, heads)
    th = torch.from_numpy(h).requires_grad_(True)
    recorded = TL.gat_aggregate_bucketed(tp, th, tb, N, heads)
    assert stacked.grad_fn is None and recorded.grad_fn is not None
    np.testing.assert_allclose(stacked.numpy(), recorded.detach().numpy(), **TOL)


def test_gat_init_keys_shapes_and_head_check():
    cfg = TM.GCNConfig(model="gat", in_dim=12, hidden_dim=16, num_classes=4,
                       num_layers=2, gat_heads=4)
    params = TM.init_params(cfg)
    jparams = JM.init_params(jax.random.PRNGKey(0), JM.GCNConfig(
        model="gat", in_dim=12, hidden_dim=16, num_classes=4, num_layers=2,
        gat_heads=4))
    for tl, jl in zip(params["layers"], jparams["layers"]):
        assert {k: tuple(v.shape) for k, v in tl.items()} == \
            {k: tuple(v.shape) for k, v in jl.items()}
    # glorot of (heads, dh): fan_in = heads, fan_out = dh.
    assert float(params["layers"][0]["a_src"].abs().max()) <= np.sqrt(6.0 / (4 + 4))
    with pytest.raises(ValueError, match="% heads"):
        TL.init_layer(torch.Generator().manual_seed(0), "gat", 12, 47, 4)


@pytest.mark.parametrize("strategy", ["hybrid", "pre", "post"])
def test_distributed_gat_still_refused(strategy):
    """ROADMAP C-ref7: the JAX package's distributed GAT raises a
    broadcasting error. The port's trains GAT where every halo row is a
    raw source (``post``) and refuses the strategies whose plans send
    pre-aggregated rows, with a message that says why."""
    spec = RunSpec.load(Path(__file__).resolve().parents[1] / "specs"
                        / "flagship_hier_int2_overlap.json").with_overrides(
        ["exec.mode=vmap", "model.model=gat", f"partition.strategy={strategy}"])
    if strategy == "post":
        s = build_session(spec, device="cpu")
        assert np.isfinite(s.train_epoch()["loss"]) and 0.0 <= s.evaluate() <= 1.0
        return
    with pytest.raises(NotImplementedError, match="pre-aggregated"):
        build_session(spec, device="cpu")
    assert "strategy=post" in GAT_NOT_DISTRIBUTED


SPEC = {
    "run": {
        "graph": {"source": "sbm", "nodes": 160, "classes": 4, "feat_dim": 8,
                  "avg_degree": 6, "norm": "mean", "seed": 3},
        "partition": {"nparts": 4, "groups": 2},
        "model": {"model": "gat", "hidden_dim": 16, "num_layers": 2,
                  "gat_heads": 4},
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


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_served_equals_full_batch_bitwise(heads):
    _, tserver = _pair(f"model.gat_heads={heads}")
    full = tserver.full_batch_logits()
    for req, logits in zip(REQUESTS, tserver.serve_batch(REQUESTS)):
        assert np.array_equal(logits, full[np.asarray(req)]), req
    assert tserver.check_parity([5, 23])


@pytest.mark.parametrize("fanouts", ["full", "3,2"])
def test_gat_serving_matches_jax(fanouts):
    jserver, tserver = _pair(f"serve.fanouts={fanouts}")
    for got, expect in zip(tserver.serve_batch(REQUESTS), jserver.serve_batch(REQUESTS)):
        assert got.shape == expect.shape
        np.testing.assert_allclose(got, np.asarray(expect), **TOL)
    np.testing.assert_allclose(tserver.full_batch_logits(),
                               np.asarray(jserver.full_batch_logits()), **TOL)


def test_build_server_gat_on_cpu():
    server = build_server(TServeSpec.from_json(json.dumps(SPEC)), device="cpu")
    assert server.cfg.model == "gat" and set(server.params["layers"][0]) == {
        "ln_scale", "ln_bias", "b", "w", "a_src", "a_dst"}
    out = server.serve_batch([[0], [1, 2]])
    assert out[0].shape == (1, 4) and out[1].shape == (2, 4)
    assert all(np.all(np.isfinite(o)) for o in out)
