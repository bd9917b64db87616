"""The SAGE reference reads only where the program put its rows, and holds
that placement to the raw edges: a sound plan counts every in-edge once
(``edges_off`` 0); an edge dropped or carried twice, a node placed twice,
a received row read from the wrong slot are each counted. The program's
record of its wire equals the session's predicted all-to-all bytes."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from conftest import SEED, SMALL
from gnnbench import compare, harness, inputs, trees

CELLS = ["sage-products.hier-int2", "sage-products.flat-fp32"]


def _program(cell, partition_seed=None):
    c = harness.cell(harness.benchmark(), cell)
    if partition_seed is not None:
        c["traffic"] = {**c["traffic"],
                        "partition": {**c["traffic"]["partition"], "seed": partition_seed}}
    cfg = {**c["config"], "graph": {**c["config"]["graph"], "num_nodes": SMALL}}
    raw = inputs.make_graph({**cfg["graph"], **c["traffic"]["graph"]},
                            cfg["model"]["num_classes"], cfg["model"]["in_dim"], SEED)
    params = inputs.make_params(cfg["model"], SEED, "cpu")
    prog = harness.load_module("programs", cfg["program"]).Program(
        cfg, c["traffic"], raw, trees.clone(params), inputs.Draws(SEED), SEED,
        torch.device("cpu"))
    return c, cfg, raw, prog, params


@pytest.fixture(scope="module")
def placed():
    out = {}
    for cell in CELLS:
        c, cfg, raw, prog, _ = _program(cell)
        out[cell] = (c, cfg, raw, prog.placement())
        prog.close()
    return out


def _edges_off(placed, cell, placement):
    c, cfg, raw, _ = placed[cell]
    ref = harness.load_module("reference", cfg["reference"])
    return ref.prepare(cfg, c["traffic"], raw, SEED, torch.device("cpu"), placement)["edges_off"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_placement_counts_every_edge_once(placed, cell):
    assert _edges_off(placed, cell, placed[cell][3]) == 0


def test_flat_fp32_reads_no_plan(placed):
    assert placed["sage-products.flat-fp32"][3]["stages"] == {}


def _inter(placement):
    return placement["stages"][1]


def _first(mask):
    return tuple(np.argwhere(mask)[0])


@pytest.mark.parametrize("fault", ["recv_dropped", "pre_dropped", "raw_twice",
                                   "recv_misread", "node_twice"])
def test_faulty_placement_is_counted(placed, fault):
    cell = "sage-products.hier-int2"
    p = copy.deepcopy(placed[cell][3])
    inter = _inter(p)
    if fault == "recv_dropped":
        inter["recv_mask"][_first(inter["recv_mask"])] = False
    elif fault == "pre_dropped":
        inter["pre_mask"][_first(inter["pre_mask"])] = False
    elif fault == "raw_twice":
        # A second worker of the group puts a raw row in an occupied slot.
        w, k = _first(inter["gather_mask"])
        other = w + 1 if (w + 1) % 4 else w - 1
        inter["gather_mask"][other, k] = True
        inter["gather"][other, k] = 0
    elif fault == "recv_misread":
        w, j = _first(inter["recv_mask"])
        i = int(np.flatnonzero(inter["recv_mask"][w])[-1])
        inter["recv_row"][w, i] = inter["recv_row"][w, j]
    else:
        owned = p["owned"]
        owned[0, 0] = owned[1, 0]
    assert _edges_off(placed, cell, p) > 0


def test_recorded_wire_equals_the_predicted_all_to_all():
    from repro_torch.core import exchange

    prog = _program("sage-products.hier-int2")[3]
    with exchange.recording() as rec:
        prog.step()                      # epoch 0: every wire runs
    prog.step()
    with prog.recording():
        prog.step()                      # epoch 2: the next refresh
    a2a = sum(o.bytes for o in rec.ops if o.kind == "all-to-all")
    assert a2a == prog.session.predicted_hlo_wire_bytes()["total"]
    assert prog.facts()["wire_bytes"] == sum(o.wire_bytes() for o in rec.ops) * 8 > a2a * 8
    prog.close()


@pytest.mark.parametrize("cell", CELLS)
def test_another_valid_partition_still_agrees(placed, cell):
    """A partition the program draws otherwise (another seed) moves the rows;
    the reference follows them and the run stays correct."""
    c, cfg, raw, prog, params0 = _program(cell, partition_seed=SEED + 1)
    got = harness.checked_readings(prog, params0)
    placement = prog.placement()
    prog.close()
    assert not np.array_equal(placement["owned"], placed[cell][3]["owned"])
    ref = harness.load_module("reference", cfg["reference"]).run(
        cfg, c["traffic"], raw, params0, inputs.Draws(SEED), SEED, torch.device("cpu"),
        placement=placement)
    verdict = compare.judge(compare.numbers(got, ref), c["limits"])
    assert verdict["correct"], verdict["compared"]
