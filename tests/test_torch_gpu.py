"""Tests of the port that need a CUDA card (marker ``gpu``); they skip without one.

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
    assert sa.launches - before == sum(1 for b in dt.buckets if b.n)
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
