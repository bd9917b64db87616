"""refresh_epoch_ms: the window's mean epoch on the host clock over the
epochs in which every delayed wire runs (``epoch % inter_cd == 0``)."""

from gnnbench.metrics_common import mean_epoch_ms


def read(ctx):
    return mean_epoch_ms(ctx, "refresh")
