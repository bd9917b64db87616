"""The FLOP and byte counters against hand counts on a small graph."""

from __future__ import annotations

import pytest

from gnnbench import counts
from gnnbench.metrics_common import merged_seconds

SAGE = {"model": "sage", "num_layers": 2, "in_dim": 3, "hidden_dim": 4, "num_classes": 2}
GAT = {**SAGE, "model": "gat", "heads": 2}
# 3 nodes, 2 undirected edges (4 directed) and 3 self loops: e = 7.
RAW = {"num_nodes": 3, "src": [0, 1, 1, 2], "dst": [1, 0, 2, 1]}


def test_edges_count_self_loops():
    assert counts.edges(RAW) == 7


def test_sage_flops_by_hand():
    # layer 0: 12·3·3·4 + 4·7·3 = 432 + 84; layer 1: 12·3·4·2 + 4·7·4 = 288 + 112
    assert counts.sage_flops(SAGE, 3, 7) == 432 + 84 + 288 + 112


def test_gat_flops_by_hand():
    # per layer 6·n·a·b + 12·n·b + 15·e·h + 6·e·b
    l0 = 6 * 3 * 3 * 4 + 12 * 3 * 4 + 15 * 7 * 2 + 6 * 7 * 4
    l1 = 6 * 3 * 4 * 2 + 12 * 3 * 2 + 15 * 7 * 2 + 6 * 7 * 2
    assert counts.gat_flops(GAT, 3, 7) == l0 + l1


def test_aggregation_bytes_by_hand():
    # per layer 2·(8·e + 8·n·a): a = 3, then 4
    assert counts.aggregation_bytes(SAGE, 3, 7) == 2 * (56 + 72) + 2 * (56 + 96)


def test_int2_wire_bytes_by_hand():
    # 8 rows; f = 3 then 4; one int32 word a row; 2 row groups of (zero, scale)
    per = lambda f: 2 * ((2 * 8 * f * 4 + 8 * 4 + 16) + (8 * 4 + 16 + 8 * f * 4))
    assert counts.int2_wire_bytes(SAGE, 8, 2) == per(3) + per(4)


def test_kernel_seconds_and_merge():
    traced = [{"kind": "refresh", "device": [("seg_aggregate_gather(x)", 0, 10),
                                             ("quant_pack_regs", 5, 8)]},
              {"kind": "stale", "device": [("seg_aggregate_gather(x)", 0, 4)]}]
    assert counts.kernel_seconds(traced, ("seg_aggregate",), {"refresh"}) == pytest.approx(1e-5)
    assert counts.kernel_seconds(traced, ("seg_aggregate",)) == pytest.approx(1.4e-5)
    assert merged_seconds([(0, 10), (5, 12), (20, 21)]) == pytest.approx(13e-6)


def test_peaks_only_for_known_cards():
    assert counts.peaks("NVIDIA H100 80GB HBM3")["fp32_flops"] == 67e12
    assert counts.peaks("cpu") is None
