"""The per-layer metrics that read the program's spans
(``repro_torch.core.record``): on the CPU a traced run reports the set-up
span ``partition_labels_s`` and none of the device metrics, and each reader
returns None, without raising, on a program that keeps no spans."""

from __future__ import annotations

import pytest

from conftest import SEED, SMALL
from gnnbench import harness

DEVICE = ("send_gather_ms", "exchange_ms", "lp_embed_ms", "gat_gather_ms", "adamw_ms")
READERS = DEVICE + ("partition_labels_s",)


def test_a_traced_cpu_run_reads_the_setup_span_alone():
    r = harness.run_cell("sage-products.hier-int2", SEED, 0.2, True, device="cpu",
                         shrink={"num_nodes": SMALL}, log=lambda m: None)
    metrics = r["metrics"]
    assert not set(DEVICE) & set(metrics)
    labels, partition = metrics["partition_labels_s"]["value"], metrics["partition_s"]["value"]
    assert 0 < labels < partition


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_none(monkeypatch, name):
    from repro_torch.core import record

    for attr in ("step_device_ms", "setup_seconds", "traced_steps", "setup_spans"):
        monkeypatch.delattr(record, attr)
    ctx = {"traced": [{"kind": "refresh"}, {"kind": "stale"}]}
    assert harness.load_module("metrics", name).read(ctx) is None


@pytest.mark.parametrize("name", DEVICE)
def test_fewer_step_records_than_traced_epochs_read_none(name):
    from repro_torch.core import record

    ctx = {"traced": [{}] * (len(record.SPANS.steps) + 1)}
    assert harness.load_module("metrics", name).read(ctx) is None
