"""Arithmetic the metric readers share (``chip_smoke.py``'s profiled-epoch
busy share, with the device intervals merged)."""

from __future__ import annotations

import math
from typing import Dict, List, Optional


def merged_seconds(intervals) -> float:
    """Seconds covered by a union of [start, end] microsecond intervals."""
    busy, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-6


def busy_seconds(traced: List[Dict]) -> float:
    """Seconds in which some device activity ran, over the traced epochs."""
    return sum(merged_seconds([(s, e) for _, s, e in ep["device"]]) for ep in traced)


def mean_epoch_ms(ctx: Dict, kind: str) -> Optional[float]:
    times = [s for k, s in ctx["epochs"] if k == kind]
    return sum(times) / len(times) * 1e3 if times else None
