"""LM training of the hybrid, ssm and audio families in the port against
``repro.models``: the zamba2, xLSTM and whisper smoke configs, with the
checks and bars of ``test_torch_lm_train.py`` (whisper's batch carries its
frames): the fp32 loss and every gradient leaf, the bf16 loss, finite
gradients, ``train_step`` at ``num_microbatches=2`` for zamba2, and
recompute against a direct call, bitwise.

Then Mamba-2 at the full configs' SSD chunk of 128 over 256 tokens: the
decay above the diagonal reaches exp(88), where fp32 overflows. The port
masks before the exp, so its gradients are finite and its forward is the
reference's; the reference's ``where(causal, exp(rel), 0)`` gives NaN
gradients there (ROADMAP C-ref14, a behaviour of the reference).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as JMB

from repro_torch.models import mamba2 as TMB
from repro_torch.utils.trees import tree_map

from test_torch_lm_train import (check_grads_fp32, check_loss_bf16,
                                 check_recompute_is_bitwise, check_train_step)

ARCHS = ["zamba2-2.7b", "xlstm-350m", "whisper-small"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference_fp32(name, monkeypatch):
    check_grads_fp32(name, monkeypatch)


@pytest.mark.parametrize("name", ARCHS)
def test_bf16_loss_within_bar_and_grads_finite(name):
    check_loss_bf16(name)


def test_train_step_microbatches_match_reference(monkeypatch):
    check_train_step("zamba2-2.7b", monkeypatch)


@pytest.mark.parametrize("name", ARCHS)
def test_recompute_changes_no_value(name, monkeypatch):
    check_recompute_is_bitwise(name, monkeypatch)


def test_mamba_full_chunk_has_finite_gradients():
    """Narrow width (d_model 64, 4 heads of 32, state 16), the full configs'
    chunk of 128, 2 x 256 tokens, fp32, A = -1 and dt = softplus(x + 0) as
    init gives them."""
    tcfg = TMB.MambaConfig(d_inner=128, head_dim=32, state_dim=16, chunk=128)
    jcfg = JMB.MambaConfig(d_inner=128, head_dim=32, state_dim=16, chunk=128)
    params = TMB.init_mamba(torch.Generator().manual_seed(0), 64, tcfg)
    x = np.random.default_rng(0).normal(size=(2, 256, 64)).astype(np.float32)
    jp = tree_map(lambda t: t.numpy(), params)

    def jloss(p, xx):
        return JMB.mamba_train(p, xx, jcfg).astype(jnp.float32).sum()

    jout = np.asarray(jax.jit(lambda p, xx: JMB.mamba_train(p, xx, jcfg))(jp, x))
    jgrad = jax.jit(jax.grad(jloss))(jp, x)
    live = tree_map(lambda t: t.clone().requires_grad_(), params)
    out = TMB.mamba_train(live, torch.from_numpy(x), tcfg)
    out.float().sum().backward()
    scale = float(np.abs(jout).max())
    assert float(np.abs(out.detach().numpy() - jout).max()) <= 1e-5 * scale
    assert all(bool(torch.isfinite(t.grad).all()) for t in live.values())
    ref_nan = sorted(k for k, g in jgrad.items() if np.isnan(np.asarray(g)).any())
    print(f"reference's NaN gradient leaves at chunk 128 (C-ref14): {ref_nan}")
    assert ref_nan == ["A_log", "dt_bias", "w_in"]
