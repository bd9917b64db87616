"""step_mfu: the model's FLOPs of one training step (``counts``) over the
window's epoch time, as a share of the card's fp32 peak."""

from gnnbench import counts


def read(ctx):
    pk = counts.peaks(ctx["device_kind"])
    if pk is None:
        return None
    model, raw = ctx["config"]["model"], ctx["raw"]
    n, e = raw["num_nodes"], counts.edges(raw)
    flops = (counts.gat_flops if model["model"] == "gat" else counts.sage_flops)(model, n, e)
    epoch_s = ctx["window_s"] / len(ctx["epochs"])
    return 100.0 * flops / epoch_s / pk["fp32_flops"]
