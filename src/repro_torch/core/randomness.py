"""The random draws of a training step, by name.

torch cannot replay the JAX package's threefry keys, so every random draw
of the distributed step goes through one object handed to the trainer,
with named draws over the stacked worker axis:

  * ``lp_select(epoch, shape, rate)``      — the label-propagation
    Bernoulli per worker (``[P, M]`` bool, True with probability ``rate``);
  * ``dropout_keep(epoch, layer, shape, keep)`` — the dropout keep mask per
    worker and layer (``[P, M, F]`` bool);
  * ``quant_uniform(epoch, layer, stage, backward, shape)`` — the
    stochastic-rounding uniforms in [0, 1) per worker, layer and exchange
    stage, for the forward wire and for the backward one
    (``[P, rows, F]`` fp32).

Each method also takes the ``device`` the result must lie on.
:class:`GeneratorRandomness` backs ordinary runs. A test that holds the
port to the JAX package backs the same methods with ``jax.random`` under
the JAX package's key folds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_KINDS = {"lp": 1, "dropout": 2, "quant": 3}


class GeneratorRandomness:
    """Named draws from ``torch.Generator``s seeded from ``seed``.

    Every draw seeds its own generator from (seed, epoch, name), so the
    draws do not depend on the order they are asked for (the backward
    wire's uniforms are drawn inside autograd). ``draw_device`` is where
    the generators run: ``None`` draws on the device the result goes to;
    ``"cpu"`` draws on the CPU and copies, so a run on the card and one on
    the CPU see the same numbers.
    """

    def __init__(self, seed: int = 0, draw_device: Optional[str] = None):
        self.seed = int(seed)
        self.draw_device = draw_device

    def _generator(self, device, *name: int) -> Tuple[torch.Generator, torch.device]:
        dev = torch.device(self.draw_device if self.draw_device is not None else device)
        state = np.random.SeedSequence([self.seed, *name]).generate_state(2, np.uint32)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(state[0]) << 31 ^ int(state[1]))
        return gen, dev

    def _uniform(self, shape, device, *name: int) -> torch.Tensor:
        gen, dev = self._generator(device, *name)
        return torch.rand(shape, generator=gen, device=dev).to(device)

    def lp_select(self, epoch: int, shape, rate: float, device) -> torch.Tensor:
        return self._uniform(shape, device, epoch, _KINDS["lp"]) < rate

    def dropout_keep(self, epoch: int, layer: int, shape, keep: float,
                     device) -> torch.Tensor:
        return self._uniform(shape, device, epoch, _KINDS["dropout"], layer) < keep

    def quant_uniform(self, epoch: int, layer: int, stage: int, backward: bool,
                      shape, device) -> torch.Tensor:
        return self._uniform(shape, device, epoch, _KINDS["quant"], layer, stage,
                             int(backward))
