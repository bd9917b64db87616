"""The distributed GAT cell: it loads by name, the configuration's heads
are the ones the program builds, the accepted per-layer metrics of the
layers it runs read there, and the halo span's reader reads nothing where
there is nothing to read."""

from __future__ import annotations

import pytest

from conftest import SEED, SMALL
from gnnbench import harness

GAT = "gat-papers100m.hier-int2-post"
LIMITS = {"loss1_gap", "loss_gap", "grad_gap", "grad_gap_median", "change_gap",
          "change_gap_median"}
# The exchange, the Int2 wire, the schedule's epochs, the lookup, AdamW and
# the partition run in this cell as in sage-products.hier-int2, GAT's
# gathers as in gat-arxiv.full-batch.
SHARED = ["partition_s", "partition_labels_s", "refresh_epoch_ms", "stale_epoch_ms",
          "wire_mb", "quant_pack_roofline", "send_gather_ms", "exchange_ms",
          "lp_embed_ms", "adamw_ms", "gat_gather_ms", "step_mfu", "device_idle_pct"]


def test_the_gat_cell_loads():
    bench = harness.benchmark()
    gat = harness.cell(bench, GAT)
    assert gat["config"]["model"]["model"] == "gat"
    assert gat["config"]["program"] == "sage_session"
    assert gat["traffic"]["partition"]["strategy"] == "post"
    assert set(gat["limits"]) == LIMITS
    assert "gat_halo_ms" in {m["name"] for m in harness.cell_metrics(bench, GAT, True)}


@pytest.mark.parametrize("metric", SHARED)
def test_the_gat_cell_reports_the_shared_layers_metrics(metric):
    names = {m["name"] for m in harness.cell_metrics(harness.benchmark(), GAT, True)}
    assert metric in names


def test_heads_are_the_specs_default():
    """``sage_session`` passes no ``gat_heads``: the configuration's heads
    must be the spec's default, which shapes the parameters the harness
    makes."""
    from repro_torch.run.spec import ModelSpec

    cfg = harness.cell(harness.benchmark(), GAT)["config"]
    assert cfg["model"]["heads"] == ModelSpec().gat_heads
    assert cfg["model"]["num_classes"] % cfg["model"]["heads"] == 0


def test_halo_reader_without_spans_reads_none(monkeypatch):
    from repro_torch.core import record

    monkeypatch.delattr(record, "step_device_ms")
    ctx = {"traced": [{"kind": "refresh"}, {"kind": "stale"}]}
    assert harness.load_module("metrics", "gat_halo_ms").read(ctx) is None


def test_a_traced_cpu_run_reports_no_device_metric():
    r = harness.run_cell(GAT, SEED, 0.2, True, device="cpu", shrink={"num_nodes": SMALL},
                         log=lambda m: None)
    assert r["correct"], r["compared"]
    assert "gat_halo_ms" not in r["metrics"] and "step_mfu" not in r["metrics"]
    assert r["compared"]["edges_off"]["value"] == 0
