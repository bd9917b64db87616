"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` once the window has
closed, never reset: set-up included, as the card must hold it."""


def read(ctx):
    return ctx["peak_bytes"] / 2**30 if ctx["peak_bytes"] else None
