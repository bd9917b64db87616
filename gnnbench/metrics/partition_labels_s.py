"""partition_labels_s: host seconds the partitioner took for the labels
(``partition_hierarchical``, ``partition_graph``, ``refine_bucket_max``)
in the program's newest ``build_partition``: its set-up spans
``setup.partition.labels`` under ``setup.partition``
(``repro_torch.core.record``). None where the program keeps no spans."""


def read(ctx):
    from repro_torch.core import record

    seconds = getattr(record, "setup_seconds", None)
    return None if seconds is None else seconds("setup.partition.labels",
                                                within="setup.partition")
