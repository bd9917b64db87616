"""Carry parameters across from the JAX package.

``params_from_jax(tree)`` takes the parameter tree of
``repro.core.model.init_params`` (or a restored checkpoint), with its
leaves as numpy arrays or anything ``np.asarray`` accepts, and returns
the port's parameters under the same keys: ``layers[i].{ln_scale,
ln_bias, w_self, w_neigh, w, b, ...}`` and ``lp_embed``. Both packages
then compute the same function, which is how the tests hold the port to
the reference. This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict:
    def leaf(a) -> torch.Tensor:
        return torch.tensor(np.asarray(a), device=device)

    out: Dict = {"layers": [{k: leaf(v) for k, v in p.items()}
                            for p in tree["layers"]]}
    if "lp_embed" in tree:
        out["lp_embed"] = leaf(tree["lp_embed"])
    return out
