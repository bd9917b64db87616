"""Carry parameters across from the JAX package.

``params_from_jax(tree)`` takes the parameter tree of
``repro.core.model.init_params`` (or a restored checkpoint), with its
leaves as numpy arrays or anything ``np.asarray`` accepts, and returns
the port's parameters under the same keys: ``layers[i].{ln_scale,
ln_bias, w_self, w_neigh, w, b, ...}`` and ``lp_embed``. Both packages
then compute the same function, which is how the tests hold the port to
the reference. ``lm_params_from_jax(tree)`` does the same for the LM
parameters of ``repro.models.init_params``: the same nested keys, with
per-layer tensors stacked on the leading layer axis as ``jax.vmap`` init
leaves them. :class:`RecordedDraws` keeps a run's named random draws
(``core.randomness``) as arrays, so a spawned rank can replay draws that
another object made (the JAX package's key folds) without that object.
This module imports neither JAX nor the JAX package.
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


def lm_params_from_jax(tree: Dict[str, Any], device="cpu") -> Dict:
    def convert(t):
        if isinstance(t, dict):
            return {k: convert(v) for k, v in t.items()}
        return torch.tensor(np.asarray(t), device=device)

    return convert(tree)


class RecordedDraws:
    """The named draws of a randomness object (``lp_select``,
    ``dropout_keep``, ``quant_uniform``), recorded as numpy arrays the
    first time a run asks for each, then served from the table. A pickled
    copy carries the table and not the source, so the processes of a
    multi-process run replay the draws a stacked run recorded (every rank
    draws at the stacked shape) without the source's imports and start-up;
    a draw the table does not hold raises ``KeyError`` there."""

    def __init__(self, source):
        self.source = source
        self.table: Dict[tuple, np.ndarray] = {}

    def __getstate__(self):
        return {"source": None, "table": self.table}

    def _draw(self, key: tuple, make, device) -> torch.Tensor:
        if key not in self.table:
            if self.source is None:
                raise KeyError(f"draw {key} was not recorded")
            self.table[key] = make().cpu().numpy()
        return torch.from_numpy(self.table[key].copy()).to(device)

    def lp_select(self, epoch, shape, rate, device) -> torch.Tensor:
        return self._draw(("lp", epoch, tuple(shape), rate),
                          lambda: self.source.lp_select(epoch, shape, rate, "cpu"), device)

    def dropout_keep(self, epoch, layer, shape, keep, device) -> torch.Tensor:
        return self._draw(("dropout", epoch, layer, tuple(shape), keep),
                          lambda: self.source.dropout_keep(epoch, layer, shape, keep, "cpu"),
                          device)

    def quant_uniform(self, epoch, layer, stage, backward, shape, device) -> torch.Tensor:
        return self._draw(("quant", epoch, layer, stage, bool(backward), tuple(shape)),
                          lambda: self.source.quant_uniform(epoch, layer, stage, backward,
                                                            shape, "cpu"), device)
