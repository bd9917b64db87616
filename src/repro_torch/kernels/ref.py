"""Plain PyTorch versions of the kernels (counterpart of ``repro.kernels.ref``).

They define what the hand-written kernels compute. The wrappers use them
for tensors on the CPU; the tests and ``chip_smoke.py`` hold the kernels to
them on the card.
"""

from __future__ import annotations

import torch


def seg_aggregate_ref(
    x: torch.Tensor,      # [N, F] source features
    ell_idx: torch.Tensor,  # [R, K] integer source ids per dst-row slot
    ell_w: torch.Tensor,    # [R, K] f32 edge weights (0 = padding)
) -> torch.Tensor:
    """out[r] = sum_k ell_w[r, k] * x[ell_idx[r, k]] — the paper's index_add/SpMM."""
    return (ell_w.to(x.dtype)[..., None] * x[ell_idx.long()]).sum(1)
