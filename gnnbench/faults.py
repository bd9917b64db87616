"""Faults planted in the program's timed path, to show that the comparison
catches them (``control.py --faults`` on the chip, and the CPU tests):

  unchanged_state  the optimizer returns the state it was given;
  half_batch       the loss is the mean over the first half of the nodes;
  no_exchange      the halo rows the exchange received are left out of
                   the aggregation (distributed cells only).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def unchanged_state():
    from repro_torch.core import trainer
    return _patched(trainer, "adamw_update", lambda grads, state, params, lr: (params, state))


def half_batch():
    from repro_torch.core import model

    sound = model.loss_and_metrics

    def half(logits, labels, loss_mask):
        mask = loss_mask.clone()
        mask[..., mask.shape[-1] // 2:] = False
        return sound(logits, labels, mask)

    return _patched(model, "loss_and_metrics", half)


def no_exchange():
    from repro_torch.core import exchange
    return _patched(exchange, "scatter_recv", lambda acc, recv, plan, agg_backend="coo": acc)


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "no_exchange": no_exchange}


def applicable(cfg) -> list:
    """The faults a configuration's program can have."""
    names = ["unchanged_state", "half_batch"]
    if cfg["program"] == "sage_session":
        names.append("no_exchange")
    return names
