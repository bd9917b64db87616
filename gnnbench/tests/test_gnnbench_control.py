"""The comparison against faults and the control, at 2,048 nodes on the
CPU: a sound run comes out correct; the run comes out not correct with
each fault the cell can have planted in the program's timed path, and
with the control (the reference in TF32) in the program's place."""

from __future__ import annotations

import contextlib

import pytest
import torch

from conftest import SEED, SMALL
from gnnbench import compare, faults, harness, inputs, trees

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]
CASES = [(c, f) for c in CELLS
         for f in [None] + faults.applicable(harness.cell(harness.benchmark(), c)["config"])]


@pytest.mark.parametrize("cell,fault", CASES)
def test_run_with_fault(cell, fault):
    with (faults.FAULTS[fault]() if fault else contextlib.nullcontext()):
        r = harness.run_cell(cell, SEED, 0.2, False, device="cpu",
                             shrink={"num_nodes": SMALL}, log=lambda m: None)
    assert r["correct"] is (fault is None), r["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = harness.cell(harness.benchmark(), cell)
    cfg = {**c["config"], "graph": {**c["config"]["graph"], "num_nodes": SMALL}}
    raw = inputs.make_graph({**cfg["graph"], **c["traffic"]["graph"]},
                            cfg["model"]["num_classes"], cfg["model"]["in_dim"], SEED)
    params0 = inputs.make_params(cfg["model"], SEED, "cpu")
    prog = harness.load_module("programs", cfg["program"]).Program(
        cfg, c["traffic"], raw, trees.clone(params0), inputs.Draws(SEED), SEED,
        torch.device("cpu"))
    placement = prog.placement()
    prog.close()
    ref_mod = harness.load_module("reference", cfg["reference"])
    L = ref_mod.prepare(cfg, c["traffic"], raw, SEED, torch.device("cpu"), placement)
    ref = ref_mod.train(L, cfg, params0, inputs.Draws(SEED), 3)
    ctl = ref_mod.train(L, cfg, params0, inputs.Draws(SEED), 3, control=True)
    assert not compare.judge(compare.numbers(ctl, ref), c["limits"])["correct"]


def test_tf32_rounding():
    from gnnbench.reference.common import to_tf32
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-10), 3.0])
    assert to_tf32(x).tolist() == [1.0, 1.0 + 2**-9, -(1.0 + 2**-10), 3.0]
