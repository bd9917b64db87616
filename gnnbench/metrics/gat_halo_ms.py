"""gat_halo_ms: device ms per traced epoch in distributed GAT's halo
attention, forward and backward, over every layer and exchange stage: the
received rows' transform, their scores and gathers, and the merge into
the local softmax partials, the program's outermost ``gnn.gat.halo`` spans
(``repro_torch.core.record``), the mean over the traced epochs' step
records. None where the program keeps no such spans, and on the CPU."""


def read(ctx):
    from repro_torch.core import record

    mean = getattr(record, "step_device_ms", None)
    return None if mean is None else mean(len(ctx["traced"]), "gnn.gat.halo")
