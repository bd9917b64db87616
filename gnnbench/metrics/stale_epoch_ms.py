"""stale_epoch_ms: the window's mean epoch on the host clock over the
epochs that serve the delayed wire's cached halo."""

from gnnbench.metrics_common import mean_epoch_ms


def read(ctx):
    return mean_epoch_ms(ctx, "stale")
