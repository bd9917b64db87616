"""The port's stacked distributed trainer against ``repro``'s vmap trainer.

Both sessions start from the same parameters (the JAX package's
``init_params``, copied with ``parity.params_from_jax``), and the port's
random draws replay the JAX package's key folds (:class:`JaxReplay`):

  kw = fold_in(PRNGKey(1000003 + epoch), g*W + w)   (trainer.py:509-515, :789)
  LP:       bernoulli(fold_in(kw, 1), lp_rate)
  dropout:  split(fold_in(kw, 104729)) once per layer    (model.py:91)
  wire:     uniform(fold_in(fold_in(kw, 7919 + l), si)), backward
            folding 0x5BD1 on top                (trainer.py:488, exchange.py:665)

The flagship spec (hierarchical 2x4, Int2 inter, inter_cd=2) under both
overlap settings (ROADMAP C-ref1: each against the reference with the same
setting) and the flat fp32 spec: the parameters after one step and a
5-epoch loss trajectory within rtol = atol = 1e-5, equal accuracies. Each
reference trainer is built once per module: its first step compiles for
seconds.
"""

import io
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.run.session as jsession
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.optim import schedule as j_schedule
from repro.run.spec import RunSpec as JRunSpec

from repro_torch.core import GeneratorRandomness
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.optim import schedule as t_schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parity import params_from_jax
from repro_torch.run import RunSpec, build_session

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
EPOCHS = 5

SPECS = {
    "flagship_overlap": ("flagship_hier_int2_overlap.json", []),
    "flagship_sequential": ("flagship_hier_int2_overlap.json",
                            ["schedule.overlap=false"]),
    "flat_fp32": ("flat_fp32.json", []),
}


class JaxReplay:
    """The step's named draws, replayed with ``jax.random`` under the JAX
    package's key folds (module docstring); worker p = g * W + w."""

    @staticmethod
    def _kw(epoch, p):
        return jax.random.fold_in(jax.random.PRNGKey(1000003 + epoch), p)

    @staticmethod
    def _stack(fn, workers, device):
        return torch.from_numpy(np.stack([np.asarray(fn(p)) for p in range(workers)])
                                ).to(device)

    def lp_select(self, epoch, shape, rate, device):
        return self._stack(lambda p: jax.random.bernoulli(
            jax.random.fold_in(self._kw(epoch, p), 1), rate, shape[1:]), shape[0], device)

    def dropout_keep(self, epoch, layer, shape, keep, device):
        def one(p):
            kd = jax.random.fold_in(self._kw(epoch, p), 104729)
            for _ in range(layer + 1):
                kd, sub = jax.random.split(kd)
            return jax.random.bernoulli(sub, keep, shape[1:])
        return self._stack(one, shape[0], device)

    def quant_uniform(self, epoch, layer, stage, backward, shape, device):
        rows, feat = shape[1:]

        def one(p):
            k = jax.random.fold_in(jax.random.fold_in(self._kw(epoch, p), 7919 + layer),
                                   stage)
            if backward:
                k = jax.random.fold_in(k, 0x5BD1)
            return jax.random.uniform(k, (rows // 4, 4, feat),
                                      dtype=jnp.float32).reshape(rows, feat)
        return self._stack(one, shape[0], device)


def _np_params(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_params(params):
    out = {"layers": [{k: v.detach().numpy() for k, v in p.items()}
                      for p in params["layers"]]}
    if "lp_embed" in params:
        out["lp_embed"] = params["lp_embed"].detach().numpy()
    return out


@pytest.fixture(scope="module", params=list(SPECS))
def runs(request):
    """(reference, port) records of the same EPOCHS-epoch run."""
    name, extra = SPECS[request.param]
    over = ["exec.mode=vmap"] + extra
    js = JRunSpec.load(ROOT / "specs" / name).with_overrides(over)
    ts = RunSpec.load(ROOT / "specs" / name).with_overrides(over)
    jsess = jsession.build_session(js)
    init = _np_params(jsess.trainer.params)
    tsess = build_session(ts, device="cpu", randomness=JaxReplay(),
                          params=params_from_jax(init))
    rec = {"j": {"hist": []}, "t": {"hist": []}}
    for e in range(EPOCHS):
        rec["j"]["hist"].append(jsess.train_epoch())
        rec["t"]["hist"].append(tsess.train_epoch())
        if e == 0:
            rec["j"]["step1"] = _np_params(jsess.trainer.params)
            rec["t"]["step1"] = _port_params(tsess.trainer.params)
    rec["j"]["eval"] = jsess.evaluate()
    rec["t"]["eval"] = tsess.evaluate()
    rec["spec"] = request.param
    return rec


def test_params_after_one_step(runs):
    want = jax.tree_util.tree_leaves(runs["j"]["step1"])
    got = jax.tree_util.tree_leaves(runs["t"]["step1"])
    assert len(want) == len(got)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


def test_loss_trajectory_and_eval(runs):
    jh, th = runs["j"]["hist"], runs["t"]["hist"]
    np.testing.assert_allclose([m["loss"] for m in th], [m["loss"] for m in jh], **TOL)
    np.testing.assert_allclose([m["train_acc"] for m in th],
                               [m["train_acc"] for m in jh], **TOL)
    assert runs["t"]["eval"] == runs["j"]["eval"]


def test_gradient_is_p_times_the_mean_loss_gradient():
    """ROADMAP C-ref6: the JAX package's vmap step returns P times the
    gradient of its global mean loss; the port's step backpropagates
    ``P * loss`` and so returns the same gradients."""
    over = ["exec.mode=vmap", "model.dropout=0.0", "model.label_prop=false",
            "schedule.inter_bits=0"]
    spec_path = ROOT / "specs" / "flagship_hier_int2_overlap.json"
    jsess = jsession.build_session(JRunSpec.load(spec_path).with_overrides(over))
    tr = jsess.trainer
    jgrads = tr._step(*tr._step_args(jax.random.PRNGKey(1000003)))[0]
    jgrads = jax.tree_util.tree_leaves(_np_params(tr._unreplicate(jgrads)))
    tsess = build_session(RunSpec.load(spec_path).with_overrides(over), device="cpu",
                          params=params_from_jax(_np_params(tr.params)))
    tgrads, metrics, _ = tsess.trainer.train_step()
    p = tsess.trainer.dc.nparts
    assert p == 8
    for a, b in zip(jax.tree_util.tree_leaves(_port_params(tgrads)), jgrads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    # ... and P times the gradient of the mean loss itself.
    params = {"layers": [{k: v.detach().requires_grad_(True) for k, v in layer.items()}
                         for layer in tsess.trainer.params["layers"]]}
    from repro_torch.core import model as M
    from repro_torch.core.trainer import _dist_forward
    t = tsess.trainer
    logits, _ = _dist_forward(params, t.cfg, t.dc, t.wd, torch.zeros_like(t.wd.train_mask))
    ls, _, cnt = M.loss_and_metrics(logits, t.wd.labels, t.wd.train_mask)
    mean_grads = torch.autograd.grad(ls.sum() / cnt.sum(), tree_leaves(params))
    for a, b in zip(tree_leaves(tgrads), mean_grads):
        np.testing.assert_allclose(a.numpy(), p * b.numpy(), rtol=1e-5, atol=1e-6)
    assert abs(float(metrics["loss"]) - float((ls.sum() / cnt.sum()).detach())) < 1e-6


def test_adamw_matches_reference():
    rng = np.random.default_rng(0)
    params = {"layers": [{"w": rng.normal(size=(5, 3)).astype(np.float32),
                          "b": rng.normal(size=(3,)).astype(np.float32)}]}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = j_adamw_init(jp)
    tp = params_from_jax(params)
    ts = adamw_init(tp)
    for step in range(4):
        g = {"layers": [{"w": rng.normal(size=(5, 3)).astype(np.float32) * 10.0 ** -step,
                         "b": rng.normal(size=(3,)).astype(np.float32)}]}
        jp, js = j_adamw_update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, 0.01)
        tp, ts = adamw_update(params_from_jax(g), ts, tp, 0.01)
    for a, b in zip(jax.tree_util.tree_leaves(_port_params(tp)),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    assert ts.step == int(js.step) == 4


@pytest.mark.parametrize("name,args", [("constant_lr", (0.01,)),
                                       ("cosine_lr", (0.01, 40)),
                                       ("linear_warmup_cosine", (0.01, 5, 40))])
def test_lr_schedules_match_reference(name, args):
    jf, tf = getattr(j_schedule, name)(*args), getattr(t_schedule, name)(*args)
    for step in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        np.testing.assert_allclose(float(tf(step)), float(jf(step)), rtol=1e-6, atol=0)


def test_generator_randomness_is_named_not_ordered():
    r = GeneratorRandomness(3, draw_device="cpu")
    a = r.quant_uniform(2, 1, 0, True, (8, 12, 5), "cpu")
    r.lp_select(2, (8, 12), 0.5, "cpu")
    assert torch.equal(a, r.quant_uniform(2, 1, 0, True, (8, 12, 5), "cpu"))
    assert not torch.equal(a, r.quant_uniform(2, 1, 0, False, (8, 12, 5), "cpu"))
    assert 0.0 <= float(a.min()) and float(a.max()) < 1.0
    keep = r.dropout_keep(0, 0, (8, 100, 16), 0.5, "cpu")
    assert keep.dtype == torch.bool and 0.4 < float(keep.float().mean()) < 0.6


def test_launch_train_cli_on_cpu():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tlaunch.main(["--spec", str(ROOT / "specs" / "flagship_hier_int2_overlap.json"),
                           "--set", "exec.mode=vmap", "--set", "exec.epochs=1",
                           "--device", "cpu"])
    text = out.getvalue()
    assert rc == 0
    assert "epoch    1 loss" in text and "trained 1 epochs" in text


def test_unported_paths_raise(monkeypatch):
    spec = RunSpec.load(ROOT / "specs" / "flagship_hier_int2_overlap.json")
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        build_session(spec, device="cpu")                    # exec.mode=shard_map
    spec = spec.with_overrides(["exec.mode=vmap"])
    with pytest.raises(NotImplementedError, match="not ported"):
        build_session(spec.with_overrides(["exec.auto=tuned.json"]), device="cpu")
    sess = build_session(spec, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        sess.trainer.lower_step()
    # Checkpoints are ported (tests/test_torch_ckpt.py); resuming needs a
    # directory.
    with pytest.raises(ValueError, match="ckpt_dir"):
        sess.fit(1, resume=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_session(spec)
