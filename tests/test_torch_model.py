"""The port's eval forward against ``repro.core.model.forward``, from the same
parameters (carried across with ``repro_torch.parity.params_from_jax``).

Tolerance: rtol = atol = 1e-5. Both run fp32 on the CPU, but the matrix
products, LayerNorm reductions and aggregation sums of the two frameworks
take their fp32 sums in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as JM
from repro.graph.structure import bucketed_ell_from_csr as j_bucketed
from repro.graph.structure import coo_to_csr as j_coo_to_csr
from repro.graph.structure import stack_bucketed_ells as j_stack
from repro.kernels.seg_aggregate import bucketed_aggregate as j_bucketed_aggregate
from repro.kernels.seg_aggregate import device_bucketed as j_device_bucketed

from repro_torch.core import layers as TL
from repro_torch.core import model as TM
from repro_torch.graph.structure import (bucketed_ell_from_csr, coo_to_csr,
                                         stack_bucketed_ells)
from repro_torch.kernels.seg_aggregate import bucketed_aggregate, device_bucketed
from repro_torch.parity import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
N, IN, HID, CLASSES = 96, 12, 24, 5


def _graph(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, 4 * N).astype(np.int32)
    dst = rng.integers(0, N, 4 * N).astype(np.int32)
    w = rng.uniform(0.1, 1.0, len(src)).astype(np.float32)
    x = rng.normal(size=(N, IN)).astype(np.float32)
    labels = rng.integers(0, CLASSES, N).astype(np.int32)
    prop = rng.uniform(size=N) < 0.4
    return src, dst, w, x, labels, prop


@pytest.mark.parametrize("model", ["sage", "gcn", "gin"])
@pytest.mark.parametrize("label_prop", [True, False])
@pytest.mark.parametrize("norm", ["layer", "none"])
def test_forward_matches_jax(model, label_prop, norm):
    seed = 4 * ["sage", "gcn", "gin"].index(model) + 2 * label_prop + (norm == "layer")
    src, dst, w, x, labels, prop = _graph(seed)
    kw = dict(model=model, in_dim=IN, hidden_dim=HID, num_classes=CLASSES,
              num_layers=2, norm=norm, label_prop=label_prop)
    jcfg, tcfg = JM.GCNConfig(**kw), TM.GCNConfig(**kw)
    jparams = JM.init_params(jax.random.PRNGKey(1), jcfg)
    if model == "gin":   # a non-zero eps exercises the (1 + eps) * h term
        jparams["layers"][0]["eps"] = jnp.float32(0.25)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))

    dj = j_device_bucketed(j_stack([j_bucketed(j_coo_to_csr(src, dst, w, N, N))]),
                           squeeze=True)
    dt = device_bucketed(stack_bucketed_ells([bucketed_ell_from_csr(
        coo_to_csr(src, dst, w, N, N))]), device="cpu")
    expect = JM.forward(jparams, jcfg, jnp.asarray(x), jnp.asarray(labels),
                        jnp.asarray(prop),
                        lambda l, h: j_bucketed_aggregate(h, dj, dj, N,
                                                          use_kernel=False))
    got = TM.forward(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(labels),
                     torch.from_numpy(prop),
                     lambda l, h: bucketed_aggregate(h, dt, N))
    assert got.shape == (N, CLASSES)
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def test_init_params_keys_shapes_and_seed():
    cfg = TM.GCNConfig(in_dim=IN, hidden_dim=HID, num_classes=CLASSES, num_layers=3)
    jparams = JM.init_params(jax.random.PRNGKey(0),
                             JM.GCNConfig(in_dim=IN, hidden_dim=HID,
                                          num_classes=CLASSES, num_layers=3))
    a = TM.init_params(cfg, torch.Generator().manual_seed(3))
    b = TM.init_params(cfg, torch.Generator().manual_seed(3))
    assert set(a) == set(jparams)
    for pt, pj, pb in zip(a["layers"], jparams["layers"], b["layers"]):
        assert set(pt) == set(pj)
        for k in pt:
            assert tuple(pt[k].shape) == tuple(pj[k].shape)
            assert torch.equal(pt[k], pb[k])
    lim = np.sqrt(6.0 / (IN + HID))
    assert float(a["layers"][0]["w_self"].abs().max()) <= lim


def test_gat_not_ported():
    """GAT is ported for one device and serving: its parameters build under
    the JAX package's keys and shapes, and the model runs through its
    attention layer. What stays unported is distributed GAT, which the
    JAX package cannot train either (ROADMAP C-ref7)."""
    kw = dict(model="gat", in_dim=IN, hidden_dim=HID, num_classes=4, num_layers=2,
              gat_heads=4)
    jparams = JM.init_params(jax.random.PRNGKey(2), JM.GCNConfig(**kw))
    tparams = TM.init_params(TM.GCNConfig(**kw))
    for pt, pj in zip(tparams["layers"], jparams["layers"]):
        assert {k: tuple(v.shape) for k, v in pt.items()} == \
            {k: tuple(v.shape) for k, v in pj.items()}
    src, dst, w, x, labels, prop = _graph(20)
    dt = device_bucketed(stack_bucketed_ells([bucketed_ell_from_csr(
        coo_to_csr(src, dst, w, N, N))]), device="cpu")
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    with torch.no_grad():
        got = TM.forward(params, TM.GCNConfig(**kw), torch.from_numpy(x),
                         torch.from_numpy(labels % 4), torch.from_numpy(prop),
                         lambda l, h: TL.gat_aggregate_bucketed(
                             params["layers"][l], h, dt, N, 4))
    assert got.shape == (N, 4) and torch.all(torch.isfinite(got))
    with pytest.raises(ValueError, match="no linear UPDATE"):
        TL.apply_update("gat", {}, torch.zeros(1), torch.zeros(1))
