"""The comparison that decides ``correct``.

Each number is read from the program's first three steps and from the
reference's, over the same inputs and draws:

  loss1_gap          the relative gap between the two sides' first loss;
  loss_gap           the largest relative gap of the losses over the
                     three steps;
  grad_gap           the first gradient as the optimizer got it, by the
                     worst leaf: the gap between the two sides' norms of a
                     leaf, over the reference's norm of that leaf or of
                     the median leaf, whichever is larger;
  grad_gap_median    the same gap of the median leaf;
  change_gap         each leaf's change after the three steps, by the
                     worst leaf, leaving out the leaves whose reference
                     gradient is under a thousandth of the median leaf's
                     (they move under AdamW by round-off alone);
  change_gap_median  the same gap of the median leaf.

The reference may add exact checks of its own (``checks``), such as
``edges_off``: the in-edges that the program's placement and wire plans
count other than once (limit 0).

Each number has a limit of its own (``limits/<cell>.json``); a limit of
``None`` reports the number without judging it.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

ROUNDOFF_SHARE = 1e-3


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keys) -> list:
    keys = list(keys)
    floor = statistics.median(ref[k] for k in keys)
    gaps = [abs(prog[k] - ref[k]) / max(ref[k], floor) for k in keys]
    return [g if math.isfinite(g) else math.inf for g in gaps]


def _rel(a: float, b: float) -> float:
    gap = abs(a - b) / abs(b)
    return gap if math.isfinite(gap) else math.inf


def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref`` as ``harness.checked_readings`` gives them."""
    losses = [_rel(a, b) for a, b in zip(prog["losses"], ref["losses"], strict=True)]
    g_ref = ref["grad_norms"]
    med = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= ROUNDOFF_SHARE * med]
    grads = _leaf_gaps(prog["grad_norms"], g_ref, g_ref)
    changes = _leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    out = {"loss1_gap": losses[0], "loss_gap": max(losses),
           "grad_gap": max(grads), "grad_gap_median": statistics.median(grads),
           "change_gap": max(changes), "change_gap_median": statistics.median(changes)}
    out.update({k: float(v) for k, v in ref.get("checks", {}).items()})
    return out


def judge(nums: Dict[str, float], limits: Dict) -> Dict:
    """``correct`` and each number beside its limit."""
    compared = {k: {"value": v, "limit": limits.get(k)} for k, v in nums.items()}
    correct = all(c["limit"] is None or c["value"] <= c["limit"]
                  for c in compared.values())
    return {"correct": correct, "compared": compared}
