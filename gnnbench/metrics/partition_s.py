"""partition_s: host seconds in ``repro_torch.run.session.build_partition``
(partitioner, MVC classification, halo plans), timed by the entry's
wrapper while the session builds."""


def read(ctx):
    return ctx["facts"].get("partition_s") or None
