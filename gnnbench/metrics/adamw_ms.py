"""adamw_ms: device ms per traced epoch in the AdamW update: the program's
span ``gnn.adamw`` (``repro_torch.core.record``), the mean over the traced
epochs' step records. None where the program keeps no spans, and on the
CPU."""


def read(ctx):
    from repro_torch.core import record

    mean = getattr(record, "step_device_ms", None)
    return None if mean is None else mean(len(ctx["traced"]), "gnn.adamw")
