"""gat_gather_ms: device ms per traced epoch in GAT's per-bucket gathers
(``e_dst[rows]``, ``e_src[idx]``, ``whh[idx]``), forward and their index
backward, over every layer: the program's span ``gnn.gat.gather``
(``repro_torch.core.record``), the mean over the traced epochs' step
records. None where the program keeps no spans, and on the CPU."""


def read(ctx):
    from repro_torch.core import record

    mean = getattr(record, "step_device_ms", None)
    return None if mean is None else mean(len(ctx["traced"]), "gnn.gat.gather")
