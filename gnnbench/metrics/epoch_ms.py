"""epoch_ms: the window's wall time over the whole epochs it completed
(each epoch ends on the device: the loss is read back)."""


def read(ctx):
    return ctx["window_s"] / len(ctx["epochs"]) * 1e3
