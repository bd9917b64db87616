"""wire_mb: the bytes one refresh step's exchange delivered, over every
stage's collectives, forward and backward, over all workers: the
program's own record of the step (``core.exchange.recording``), taken in
one refresh epoch after the traced ones."""


def read(ctx):
    b = ctx["facts"].get("wire_bytes")
    return None if b is None else b / 1e6
