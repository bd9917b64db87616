"""The port's single-device trainer against ``repro.core.trainer``'s.

Same graph and features (the port's copies of the generators, held to the
originals by test_torch_host.py), same initial parameters (the JAX
package's ``init_params``, carried across with ``params_from_jax``), and
the port's random draws replaying the JAX package's single-device key
folds (:class:`JaxSingleReplay`):

  kp, kd = split(PRNGKey(seed * 100003 + epoch))          (trainer.py:138, :175)
  LP:       bernoulli(kp, lp_rate, [N])                   (model.py:203)
  dropout:  per layer kd, sub = split(kd); bernoulli(sub, 1 - p, h.shape)
                                                          (model.py:228-229)

Tolerance: rtol = atol = 1e-5. The JAX package trains gcn/sage/gin over the
dense max-degree ELL, the port over the degree-bucketed layout; both hold
each row's neighbours in CSR order, but the fp32 sums of the two
frameworks run in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import model as JM
from repro.core import trainer as JT
from repro.graph import sbm_graph as j_sbm_graph
from repro.graph.generators import sbm_features as j_sbm_features

from repro_torch.core import model as TM
from repro_torch.core import trainer as TT
from repro_torch.graph import sbm_graph
from repro_torch.graph.generators import sbm_features
from repro_torch.kernels import seg_aggregate as sa
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_map
from repro_torch.parity import params_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
SEED = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxSingleReplay:
    """The single-device step's named draws, replayed with ``jax.random``
    under the JAX package's key folds (module docstring)."""

    def __init__(self, seed: int):
        self.seed = seed

    def _keys(self, epoch):
        return jax.random.split(jax.random.PRNGKey(self.seed * 100003 + epoch))

    def lp_select(self, epoch, shape, rate, device):
        kp, _ = self._keys(epoch)
        return torch.from_numpy(np.array(jax.random.bernoulli(kp, rate, shape))).to(device)

    def dropout_keep(self, epoch, layer, shape, keep, device):
        _, kd = self._keys(epoch)
        for _ in range(layer + 1):
            kd, sub = jax.random.split(kd)
        return torch.from_numpy(np.array(jax.random.bernoulli(sub, keep, shape))).to(device)


@pytest.fixture(scope="module")
def graph():
    """(JAX graph, port graph, features): 600 nodes, 4 classes, so GAT
    runs with 4 heads."""
    jg = j_sbm_graph(600, 4, avg_degree=12, homophily=0.85, seed=0)
    jx, _ = j_sbm_features(jg, 16, noise=1.5, seed=1)
    tg = sbm_graph(600, 4, avg_degree=12, homophily=0.85, seed=0)
    tx, _ = sbm_features(tg, 16, noise=1.5, seed=1)
    np.testing.assert_array_equal(jx, tx)
    return jg, tg, tx


def _cfgs(model, **kw):
    base = dict(model=model, in_dim=16, hidden_dim=32, num_classes=4,
                num_layers=2, dropout=0.5, label_prop=True, norm="layer")
    base.update(kw)
    return JM.GCNConfig(**base), TM.GCNConfig(**base)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("norm", ["mean", "gcn"])
@pytest.mark.parametrize("layouts", [("dense", "bucketed"), ("dense",), ("bucketed",)])
def test_prepare_single_arrays_equal(graph, norm, layouts):
    jg, tg, x = graph
    jd = JT.prepare_single(jg, x, norm=norm, layouts=layouts)
    td = TT.prepare_single(tg, x, norm=norm, layouts=layouts, device="cpu")
    for name in ("x", "labels", "train_mask", "eval_mask", "ell_idx", "ell_w",
                 "ell_valid"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)), err_msg=name)
    assert (td.ell is None) == (jd.ell is None) == ("bucketed" not in layouts)
    for tl, jl in ((td.ell, jd.ell), (td.ell_t, jd.ell_t)):
        if jl is None:
            continue
        assert len(tl.buckets) == len(jl.buckets)
        for tb, jb in zip(tl.buckets, jl.buckets):
            for f in ("rows", "idx", "w"):
                np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                              np.asarray(getattr(jb, f)))
            assert tb.n <= tb.rows.shape[0] and not tb.w[tb.n:].any()


@pytest.mark.parametrize("model", ["gcn", "sage", "gin", "gat"])
@pytest.mark.parametrize("layouts,use_kernel", [(("dense", "bucketed"), False),
                                                (("dense", "bucketed"), True),
                                                (("dense",), False)])
def test_agg_fn_forward_matches_jax(graph, model, layouts, use_kernel):
    """The whole eval forward through ``make_single_agg_fn``: the bucketed
    layout (port) or the dense ELL, against the JAX package's agg_fn on the
    same prepared layouts."""
    jg, tg, x = graph
    norm = "gcn" if model == "gcn" else "mean"
    jcfg, tcfg = _cfgs(model)
    jparams = JM.init_params(jax.random.PRNGKey(5), jcfg)
    tparams = params_from_jax(_np(jparams))
    jd = JT.prepare_single(jg, x, norm=norm, layouts=layouts)
    td = TT.prepare_single(tg, x, norm=norm, layouts=layouts, device="cpu")
    prop = np.random.default_rng(0).uniform(size=600) < 0.3
    expect = JM.forward(jparams, jcfg, jd.x, jd.labels, jnp.asarray(prop),
                        JT.make_single_agg_fn(jcfg, jd, lambda: jparams, use_kernel))
    with torch.no_grad():
        got = TM.forward(tparams, tcfg, td.x, td.labels, torch.from_numpy(prop),
                         TT.make_single_agg_fn(tcfg, td, lambda: tparams, use_kernel))
    np.testing.assert_allclose(got.numpy(), np.asarray(expect), **TOL)


def _trajectories(graph, model, epochs):
    jg, tg, x = graph
    jcfg, tcfg = _cfgs(model)
    jparams, jhist = JT.train_gcn_single(jg, x, jcfg, epochs=epochs, lr=0.01,
                                         seed=SEED, log_every=1)
    init = params_from_jax(_np(JM.init_params(jax.random.PRNGKey(SEED), jcfg)))
    tparams, thist = TT.train_gcn_single(tg, x, tcfg, epochs=epochs, lr=0.01,
                                         seed=SEED, log_every=1, device="cpu",
                                         params=init,
                                         randomness=JaxSingleReplay(SEED))
    return (jparams, jhist), (tparams, thist)


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_train_trajectory_matches_jax(graph, model):
    """10 epochs, dropout 0.5 and label propagation on: loss within 1e-5
    per epoch, equal eval accuracy after every epoch, and the final
    parameters within 1e-5."""
    (jparams, jhist), (tparams, thist) = _trajectories(graph, model, 10)
    assert [h["epoch"] for h in thist] == [h["epoch"] for h in jhist] == list(range(10))
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist],
                               **TOL)
    assert [h["eval_acc"] for h in thist] == [h["eval_acc"] for h in jhist]
    for a, b in zip(jax.tree_util.tree_leaves(_np(jparams)),
                    jax.tree_util.tree_leaves(tree_map(lambda t: t.numpy(), tparams))):
        np.testing.assert_allclose(b, a, **TOL)


@pytest.mark.parametrize("model", ["sage", "gat", "gcn", "gin"])
def test_single_eval_matches_jax(graph, model):
    jg, tg, x = graph
    norm = "gcn" if model == "gcn" else "mean"
    jcfg, tcfg = _cfgs(model)
    jparams = JM.init_params(jax.random.PRNGKey(11), jcfg)
    # Each package's training layout: the JAX package aggregates the linear
    # models over the dense ELL (trainer.py:168-169), the port over buckets.
    jd = JT.prepare_single(jg, x, norm=norm,
                           layouts=("bucketed",) if model == "gat" else ("dense",))
    td = TT.prepare_single(tg, x, norm=norm, layouts=("bucketed",), device="cpu")
    got = TT.single_eval(params_from_jax(_np(jparams)), tcfg, td)
    assert got == float(JT.single_eval(jparams, jcfg, jd))


def test_single_train_step_gradient_matches_jax(graph):
    """One step's parameters (AdamW after the first gradient) within
    1e-5: the bucketed backward over ``ell_t`` against JAX's autodiff of
    the dense aggregation."""
    jg, tg, x = graph
    jcfg, tcfg = _cfgs("sage")
    jparams = JM.init_params(jax.random.PRNGKey(SEED), jcfg)
    jd = JT.prepare_single(jg, x, layouts=("dense",))
    td = TT.prepare_single(tg, x, layouts=("bucketed",), device="cpu")
    jnew, _, jm = JT.single_train_step(jparams, JT.adamw_init(jparams), jcfg, jd,
                                       jax.random.PRNGKey(SEED * 100003), 0.01)
    tparams = params_from_jax(_np(jparams))
    tnew, tstate, tm = TT.single_train_step(tparams, adamw_init(tparams), tcfg, td,
                                            JaxSingleReplay(SEED), 0, 0.01)
    assert tstate.step == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(_np(jnew)),
                    jax.tree_util.tree_leaves(tree_map(lambda t: t.numpy(), tnew))):
        np.testing.assert_allclose(b, a, **TOL)


def test_single_device_learns():
    """``tests/test_gcn_core.py::TestTraining::test_single_device_learns``
    in the port, at ``examples/quickstart.py``'s bar (eval accuracy > 0.9),
    through the plain versions on the CPU (no kernel launched)."""
    g = sbm_graph(600, 5, avg_degree=12, homophily=0.85, seed=0)
    x, _ = sbm_features(g, 16, noise=1.5, seed=1)
    cfg = TM.GCNConfig(model="sage", in_dim=16, hidden_dim=32, num_classes=5,
                       num_layers=2, dropout=0.3, label_prop=True, norm="layer")
    before = (sa.launches, sa.backward_launches)
    _, hist = TT.train_gcn_single(g, x, cfg, epochs=25, lr=0.01, log_every=25,
                                  device="cpu")
    assert [h["epoch"] for h in hist] == [0, 24]
    assert hist[-1]["eval_acc"] > 0.9
    assert (sa.launches, sa.backward_launches) == before


def test_train_gcn_single_defaults_to_the_card(graph, monkeypatch):
    _, tg, x = graph
    _, tcfg = _cfgs("sage")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TT.train_gcn_single(tg, x, tcfg, epochs=1)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        TT.prepare_single(tg, x)


def test_dense_aggregation_is_forward_only(graph):
    """``ops.aggregate`` (the dense ELL path) refuses an input that needs a
    gradient on every device, as the bucketed aggregation without its
    reverse layout does."""
    _, tg, x = graph
    td = TT.prepare_single(tg, x, layouts=("dense",), device="cpu")
    _, tcfg = _cfgs("sage")
    agg = TT.make_single_agg_fn(tcfg, td, lambda: None)
    with pytest.raises(ValueError, match="forward only"):
        agg(0, td.x.clone().requires_grad_(True))
