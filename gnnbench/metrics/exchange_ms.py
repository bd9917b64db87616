"""exchange_ms: device ms per traced epoch in the halo exchange, forward
and backward, over every layer and stage: the program's outermost
``gnn.exchange.*`` spans (``repro_torch.core.record``; each layer's
``issue`` and ``finalize``, and the backward of the send gather, the
pre-aggregation, the wire and the receive scatter), send gather included,
the mean over the traced epochs' step records. None where the program
keeps no spans, and on the CPU."""


def read(ctx):
    from repro_torch.core import record

    mean = getattr(record, "step_device_ms", None)
    return None if mean is None else mean(len(ctx["traced"]), "gnn.exchange.")
