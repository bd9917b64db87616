"""send_gather_ms: device ms per traced epoch in the exchange's raw send
gathers, forward and their index backward, over every layer and stage:
the program's span ``gnn.exchange.send_gather`` (``repro_torch.core.record``),
the mean over the traced epochs' step records. None where the program
keeps no spans, and on the CPU."""


def read(ctx):
    from repro_torch.core import record

    mean = getattr(record, "step_device_ms", None)
    return None if mean is None else mean(len(ctx["traced"]), "gnn.exchange.send_gather")
