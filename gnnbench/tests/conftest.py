"""Shared pieces of the benchmark's tests (run from the repository root:
``python -m pytest gnnbench/tests``). They run on the CPU at 2,048 nodes;
those marked ``gpu`` need a card and skip without one."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = 2048
SEED = 2**31 + 77


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
