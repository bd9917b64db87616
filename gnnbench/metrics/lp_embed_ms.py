"""lp_embed_ms: device ms per traced epoch in the label-propagation lookup
``lp_embed[labels]``, forward and its index backward: the program's span
``gnn.lp_embed`` (``repro_torch.core.record``), the mean over the traced
epochs' step records. None where the program keeps no spans, and on the
CPU."""


def read(ctx):
    from repro_torch.core import record

    mean = getattr(record, "step_device_ms", None)
    return None if mean is None else mean(len(ctx["traced"]), "gnn.lp_embed")
