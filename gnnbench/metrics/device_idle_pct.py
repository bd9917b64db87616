"""device_idle_pct: the share of the traced epochs' wall time in which no
device activity ran (the union of the profiler's device intervals)."""

from gnnbench.metrics_common import busy_seconds


def read(ctx):
    traced = ctx["traced"]
    if not traced:
        return None
    wall = sum(ep["wall_s"] for ep in traced)
    return 100.0 * (1.0 - busy_seconds(traced) / wall)
