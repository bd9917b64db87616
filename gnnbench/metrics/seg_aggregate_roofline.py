"""seg_aggregate_roofline: the least time of the graph's aggregation work
(its bytes over the card's bandwidth, ``counts.aggregation_bytes``) over
the device time of the ``seg_aggregate`` kernels, in the traced refresh
epochs, where every aggregation runs forward and backward."""

from gnnbench import counts


def read(ctx):
    pk = counts.peaks(ctx["device_kind"])
    refresh = [ep for ep in ctx["traced"] if ep["kind"] == "refresh"]
    busy = counts.kernel_seconds(refresh, ("seg_aggregate",))
    if pk is None or not busy:
        return None
    raw = ctx["raw"]
    work = counts.aggregation_bytes(ctx["config"]["model"], raw["num_nodes"],
                                    counts.edges(raw)) * len(refresh)
    return 100.0 * work / pk["hbm_bytes_s"] / busy
