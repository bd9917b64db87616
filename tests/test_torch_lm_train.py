"""LM training in the port against ``repro.models``: the 7 attention-family
smoke configs (dense, vlm, moe, MLA).

The same parameters (drawn by the port, given to the JAX package as numpy)
and the same batch (a numpy seed) go through both packages'
``compute_loss`` and its gradient (``jax.value_and_grad`` against the
port's ``loss_and_grads``, autograd through per-block recompute):

- fp32 (both packages' ``COMPUTE_DTYPE`` patched to float32): the loss
  within 1e-5 relative, and each gradient leaf within 1e-5 × the tree's
  max |g|, the GNN trainer's bar (the two packages sum the products in
  other orders);
- bf16, as shipped: the loss within ``serve_llm.bf16_bar`` relative;
- every gradient leaf of the port finite in both dtypes.

llama3.2's batch carries a ``loss_mask`` and qwen2-vl's ``patches``.
``train_step`` at ``num_microbatches=2`` is held to the reference's for
tinyllama and granite-moe by its loss, AdamW's ``mu`` and ``nu`` (each leaf
within 1e-5 × the tree's max) and ``step``. The parameters after the step
are not compared: AdamW's first step is sign-like (mhat / sqrt(vhat) =
sign(g)), so a near-zero gradient that differs in its last bit moves its
parameter by 2 lr. Then the port alone: micro-batches against one batch,
recompute against a direct call (bitwise), the caller's mask left as it
was, and the ``--arch`` entry point. ``test_torch_lm_train_recurrent.py``
holds the hybrid, ssm and audio families.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCFG
from repro import models as JM
from repro.models import common as JC
from repro.optim import adamw_init as j_adamw_init

from repro_torch import configs as TCFG
from repro_torch import models as TM
from repro_torch.launch import serve_llm
from repro_torch.launch import train as tlaunch
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw_init
from repro_torch.utils.trees import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["tinyllama-1.1b", "llama3.2-3b", "qwen2.5-32b", "starcoder2-3b",
         "qwen2-vl-2b", "granite-moe-1b-a400m", "deepseek-v2-lite-16b"]
BAR = 1e-5              # fp32: loss relative; a leaf × its tree's max
B, S = 4, 8
_JITS = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed: int = 0):
    """tokens [B, S] from a numpy seed; llama3.2 with a loss_mask, the vlm
    with its patches before S text tokens, whisper with its frames."""
    rng = np.random.default_rng(seed)
    s = S + (cfg.vision_patches if cfg.family == "vlm" else 0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.name.startswith("llama3.2"):
        batch["loss_mask"] = (rng.random((B, s)) < 0.7).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(B, cfg.vision_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, cfg.enc_frames, cfg.d_model)).astype(
            np.float32)
    return batch


def _setup(name):
    """(JAX cfg, port cfg, port params, the same as numpy, numpy batch)."""
    jcfg, tcfg = JCFG.get_smoke_arch(name), TCFG.get_smoke_arch(name)
    params = TM.init_params(torch.Generator().manual_seed(1), tcfg)
    return jcfg, tcfg, params, tree_map(lambda t: t.numpy(), params), _batch(tcfg)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jit(name, what, jcfg):
    """One jitted JAX function per (config, what): ``COMPUTE_DTYPE`` is
    read while tracing, so ``what`` names the dtype too."""
    key = (name, what)
    if key not in _JITS:
        if what == "grad_f32":
            fn = jax.value_and_grad(lambda p, b: JM.compute_loss(p, jcfg, b))
        elif what == "loss_bf16":
            fn = lambda p, b: JM.compute_loss(p, jcfg, b)  # noqa: E731
        else:  # train_f32
            fn = lambda p, o, b: JM.train_step(p, o, b, jcfg,  # noqa: E731
                                               num_microbatches=2)
        _JITS[key] = jax.jit(fn)
    return _JITS[key]


def _f32(monkeypatch):
    monkeypatch.setattr(JC, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(TC, "COMPUTE_DTYPE", torch.float32)


def _leaf_errors(jax_tree, port_tree) -> float:
    """Max |port - jax| over the leaves, over the JAX tree's max |leaf|;
    the leaves in the same (sorted key) order and of the same shapes."""
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jax_tree)]
    got = [t.detach().numpy() for t in tree_leaves(port_tree)]
    assert [w.shape for w in want] == [g.shape for g in got]
    assert all(g.dtype == np.float32 for g in got)
    scale = max(float(np.abs(w).max()) for w in want)
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want)) / scale


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree))


def check_grads_fp32(name, monkeypatch):
    """The fp32 loss and every gradient leaf against the reference's."""
    _f32(monkeypatch)
    jcfg, tcfg, params, jp, batch = _setup(name)
    jl, jg = _jit(name, "grad_f32", jcfg)(jp, batch)
    loss, grads = TM.loss_and_grads(params, tcfg, _torch_batch(batch))
    assert abs(float(loss) - float(jl)) <= BAR * abs(float(jl))
    assert _finite(grads)
    err = _leaf_errors(jg, grads)
    print(f"{name}: fp32 gradient leaves within {err:.3e} of the tree's max")
    assert err <= BAR


def check_loss_bf16(name):
    """The bf16 loss within the family's bar; the port's gradients finite."""
    jcfg, tcfg, params, jp, batch = _setup(name)
    jl = float(_jit(name, "loss_bf16", jcfg)(jp, batch))
    loss, grads = TM.loss_and_grads(params, tcfg, _torch_batch(batch))
    rel = abs(float(loss) - jl) / abs(jl)
    print(f"{name}: bf16 loss {float(loss)} vs {jl} ({rel:.3e} relative)")
    assert rel <= serve_llm.bf16_bar(tcfg)
    assert _finite(grads)


def check_train_step(name, monkeypatch):
    """``train_step(num_microbatches=2)`` at fp32: loss, mu, nu and step."""
    _f32(monkeypatch)
    jcfg, tcfg, params, jp, batch = _setup(name)
    _, jopt, jl = _jit(name, "train_f32", jcfg)(jp, j_adamw_init(jp), batch)
    _, opt, loss = TM.train_step(params, adamw_init(params), _torch_batch(batch), tcfg,
                                 num_microbatches=2)
    assert abs(float(loss) - float(jl)) <= BAR * abs(float(jl))
    assert opt.step == int(jopt.step) == 1
    assert _leaf_errors(jopt.mu, opt.mu) <= BAR
    assert _leaf_errors(jopt.nu, opt.nu) <= BAR


def check_recompute_is_bitwise(name, monkeypatch):
    """Per-block recompute changes no value: the loss and gradients equal a
    run with the checkpoint wrapper replaced by a direct call, bit for bit
    (deterministic algorithms: the CPU's index backward otherwise adds in
    threads)."""
    _, tcfg, params, _, batch = _setup(name)
    tb = _torch_batch(batch)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = TM.loss_and_grads(params, tcfg, tb, num_microbatches=2)
        monkeypatch.setattr(TT, "_recompute", lambda fn, *args: fn(*args))
        want = TM.loss_and_grads(params, tcfg, tb, num_microbatches=2)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])))


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference_fp32(name, monkeypatch):
    check_grads_fp32(name, monkeypatch)


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_loss_within_bar_and_grads_finite(name):
    check_loss_bf16(name)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "granite-moe-1b-a400m"])
def test_train_step_microbatches_match_reference(name, monkeypatch):
    check_train_step(name, monkeypatch)


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "granite-moe-1b-a400m"])
def test_recompute_changes_no_value(name, monkeypatch):
    check_recompute_is_bitwise(name, monkeypatch)


def test_microbatches_equal_one_batch(monkeypatch):
    """At fp32 without MoE (whose capacity and aux loss depend on the
    tokens of a call) two micro-batches of equal masks give the one batch's
    loss and gradients within 1e-6."""
    _f32(monkeypatch)
    _, tcfg, params, _, batch = _setup("tinyllama-1.1b")
    tb = _torch_batch(batch)
    l1, g1 = TM.loss_and_grads(params, tcfg, tb)
    l2, g2 = TM.loss_and_grads(params, tcfg, tb, num_microbatches=2)
    assert abs(float(l1 - l2)) <= 1e-6 * abs(float(l1))
    scale = max(float(g.abs().max()) for g in tree_leaves(g1))
    assert max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(g1), tree_leaves(g2))) <= 1e-6 * scale


def test_microbatches_are_consecutive_rows(monkeypatch):
    """Micro-batch i is rows [i*B/nm, (i+1)*B/nm), as the reference's reshape
    leaves them: the MoE loss is the mean of the two halves' (a strided
    split would route other sets of tokens, at other capacities)."""
    _, tcfg, params, _, batch = _setup("granite-moe-1b-a400m")
    tb = _torch_batch(batch)
    loss = float(TM.loss_and_grads(params, tcfg, tb, num_microbatches=2)[0])
    parts = [float(TM.compute_loss(params, tcfg, {"tokens": tb["tokens"][i:i + 2]}))
             for i in (0, 2)]
    assert loss == pytest.approx(sum(parts) / 2, rel=1e-6)
    with pytest.raises(ValueError, match="micro-batches"):
        TM.train_step(params, adamw_init(params), tb, tcfg, num_microbatches=3)


def test_caller_mask_is_left_as_it_was():
    _, tcfg, params, _, batch = _setup("llama3.2-3b")
    tb = _torch_batch(batch)
    mask = tb["loss_mask"].clone()
    with torch.no_grad():
        TM.compute_loss(params, tcfg, tb)
    assert torch.equal(tb["loss_mask"], mask) and bool(mask[:, -1].any())


def test_entry_point_trains_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--arch",
                        "tinyllama-1.1b", "--smoke", "--steps", "2", "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("arch tinyllama-1.1b-smoke: 2L d=256 (reduced config) on cpu")
    assert [ln.split(":")[0] for ln in lines[1:]] == ["step 0", "step 1"]
    losses = [float(ln.split()[3]) for ln in lines[1:]]
    assert all(np.isfinite(losses))


def test_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tlaunch.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "1"])


def test_lm_batch_draws_from_the_generator():
    cfg = TCFG.get_smoke_arch("qwen2-vl-2b")
    a, b = (tlaunch.lm_batch(cfg, 2, 24, torch.Generator().manual_seed(3)) for _ in range(2))
    assert a.keys() == {"tokens", "patches"}
    assert a["patches"].shape == (2, cfg.vision_patches, cfg.d_model)
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="no text"):
        tlaunch.lm_batch(cfg, 2, cfg.vision_patches, torch.Generator())
