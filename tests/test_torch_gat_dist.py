"""GAT trained distributed on the stacked workers (``DistributedTrainer``
through ``build_session``) against the plain reference
``gnnbench/reference/gat_dist.py``, which attends over the raw edge list
and reads each halo in-edge's source from the rows its stage delivers.

Cases: a flat fp32 exchange and the hierarchical 2x4 one with an Int2
inter wire refreshed every 2 epochs, each with and without ``overlap``,
on the ``ell`` and ``coo`` backends (the attention takes the plans' COO
arrays on both; the send gather differs), at 2,048 nodes with 4 heads. Then a
layer's output at fp32 with ``cd`` 1 against the single-graph
``gat_aggregate`` over the whole graph, and the refusals: the strategies
whose plans hold pre-aggregated halo rows, and the one-process-per-worker
modes.

Tolerance. fp32: rounding alone (sums in other orders; AdamW's first
steps move a near-zero gradient's leaf by round-off, hence the looser
change). Int2: the first loss precedes every rounding decision but the
forward's, so it holds to fp32; after it, a value that the two sides
round to different levels (``floor(... + u)`` near an integer) moves by a
whole level, and GAT's softmax backward, a difference of near-equal
terms, makes such flips likely in the backward wire of a larger graph
(at the benchmark's widths on 2,048 nodes they move the third loss by
up to 1%): the later numbers are held to a tenth of what leaving the
halo out moves (the first loss by 4-6%).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gnnbench import compare, harness, inputs, trees  # noqa: E402
from gnnbench.programs import sage_session  # noqa: E402
from gnnbench.reference import gat_dist  # noqa: E402

from repro_torch.core import layers as TL  # noqa: E402
from repro_torch.core import model as TM  # noqa: E402
from repro_torch.core.trainer import (GAT_NOT_DISTRIBUTED, DistributedTrainer,  # noqa: E402
                                      _dist_forward, prepare_single)
from repro_torch.graph.structure import Graph  # noqa: E402
from repro_torch.run import RunSpec, build_session  # noqa: E402

NODES, SEED = 2048, 2**31 + 91
CFG = {
    "model": {"model": "gat", "num_layers": 3, "in_dim": 16, "hidden_dim": 32,
              "num_classes": 8, "heads": 4, "norm": "layer", "dropout": 0.5,
              "label_prop": True, "lp_rate": 0.5},
    "optimizer": {"lr": 0.005},
    "graph": {"num_nodes": NODES, "mean_degree": 12.0},
}
GRAPH = {"kind": "sbm", "structure_seed": 2411163, "homophily": 0.8, "feat_noise": 2.5}
SCHEDULES = {
    "flat-fp32": ({"nparts": 8, "groups": 0}, {"bits": 0, "cd": 1}),
    "hier-int2-cd2": ({"nparts": 8, "groups": 2},
                      {"bits": 0, "cd": 1, "intra_bits": 0, "inter_bits": 2,
                       "intra_cd": 1, "inter_cd": 2}),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traffic(schedule: str, overlap: bool, backend: str) -> dict:
    part, sched = SCHEDULES[schedule]
    return {"graph": GRAPH,
            "partition": {**part, "strategy": "post", "refine": "none", "seed": 2411163},
            "schedule": {**sched, "overlap": overlap, "agg_backend": backend}}


@pytest.fixture(scope="module")
def raw():
    return inputs.make_graph({**CFG["graph"], **GRAPH}, 8, 16, SEED)


@pytest.mark.parametrize("backend", ["ell", "coo"])
@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_stacked_gat_matches_the_plain_reference(raw, schedule, overlap, backend):
    traffic = _traffic(schedule, overlap, backend)
    params0 = inputs.make_params(CFG["model"], SEED, "cpu")
    prog = sage_session.Program(CFG, traffic, raw, trees.clone(params0), inputs.Draws(SEED),
                                SEED, torch.device("cpu"))
    assert prog.session.trainer.cfg.model == "gat"
    got = harness.checked_readings(prog, params0)
    placement = prog.placement()
    prog.close()
    ref = gat_dist.run(CFG, traffic, raw, params0, inputs.Draws(SEED), SEED,
                       torch.device("cpu"), placement=placement)
    n = compare.numbers(got, ref)
    assert n["edges_off"] == 0
    assert n["loss1_gap"] < 1e-5, n
    if schedule == "flat-fp32":
        assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-5, n
        assert n["change_gap_median"] < 1e-3 and n["change_gap"] < 1e-2, n
    else:
        assert n["loss_gap"] < 1e-3 and n["grad_gap"] < 1e-3, n
        assert n["change_gap_median"] < 1e-2 and n["change_gap"] < 5e-2, n


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_fp32_layer_equals_the_single_graph_layer(schedule):
    """At fp32 with cd 1 one distributed layer is the single-graph
    ``gat_aggregate`` over the whole graph, row for row."""
    part, _ = SCHEDULES[schedule]
    spec = RunSpec.from_dict({
        "exec": {"mode": "vmap"},
        "graph": {"source": "sbm", "nodes": NODES, "classes": 8, "feat_dim": 16,
                  "avg_degree": 12, "norm": "mean", "seed": 3},
        "model": {"model": "gat", "hidden_dim": 32, "num_layers": 1, "norm": "none",
                  "dropout": 0.0, "label_prop": False},
        "partition": {**part, "strategy": "post"},
        "schedule": {"bits": 0, "cd": 1, **({"inter_bits": 0} if part["groups"] else {})},
    }).validate()
    s = build_session(spec, device="cpu")
    tr = s.trainer
    with torch.no_grad():
        out, _ = _dist_forward(tr.params, tr.cfg, tr.dc, s.wd,
                               torch.zeros_like(s.wd.train_mask))
        g = s.graph                  # normalized: self loops added
        keep = g.src != g.dst
        data = prepare_single(Graph(g.num_nodes, g.src[keep], g.dst[keep], labels=g.labels,
                                    train_mask=g.train_mask), s.x,
                              layouts=("dense",), device="cpu")
        full = TL.gat_aggregate(tr.params["layers"][0], data.x, data.ell_idx,
                                data.ell_valid, tr.cfg.gat_heads)
    for p, owned in enumerate(s.pg.owned):
        np.testing.assert_allclose(out[p, :len(owned)].numpy(), full[owned].numpy(),
                                   rtol=1e-5, atol=1e-6)


FLAGSHIP = RunSpec.load(ROOT / "specs" / "flagship_hier_int2_overlap.json").with_overrides(
    ["exec.mode=vmap", "model.model=gat", "graph.nodes=512"])


@pytest.mark.parametrize("strategy", ["hybrid", "pre"])
def test_pre_aggregated_rows_are_refused(strategy):
    with pytest.raises(NotImplementedError, match="pre-aggregated"):
        build_session(FLAGSHIP.with_overrides([f"partition.strategy={strategy}"]),
                      device="cpu")


def test_a_plan_with_pre_aggregated_slots_is_refused_by_the_trainer():
    """The trainer itself holds to its plans, whatever built them."""
    sage = build_session(FLAGSHIP.with_overrides(["model.model=sage",
                                                  "partition.strategy=hybrid"]), device="cpu")
    cfg = TM.GCNConfig(**{**sage.trainer.cfg.__dict__, "model": "gat"})
    with pytest.raises(NotImplementedError) as e:
        DistributedTrainer(cfg, sage.trainer.dc, sage.wd)
    assert str(e.value) == GAT_NOT_DISTRIBUTED


@pytest.mark.parametrize("mode", ["multiproc", "shard_map"])
def test_per_rank_modes_refuse_gat_naming_the_mode(mode):
    with pytest.raises(NotImplementedError, match=f"exec.mode={mode!r}"):
        build_session(FLAGSHIP.with_overrides([f"exec.mode={mode}",
                                               "partition.strategy=post"]), device="cpu")


def test_halo_span_holds_the_halo_forward_and_backward():
    """Under torch's profiler each layer's stage opens ``gnn.gat.halo``
    forward, and its backward opens it again over the same ops: as many
    of its gathers' backward spans as its forward made, and no other."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import record

    s = build_session(FLAGSHIP.with_overrides(["partition.strategy=post"]), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        s.train_epoch()
    rec = record.traced_steps()[-1]
    halo = [(i, sp) for i, sp in enumerate(rec.spans) if sp.name == "gnn.gat.halo"]
    gathers = lambda i: sorted(rec.spans[j].which for j in rec.descendants(i)
                               if rec.spans[j].name == "gnn.gat.gather")
    for direction in ("forward", "backward"):
        assert sorted((sp.layer, sp.level) for _, sp in halo if sp.direction == direction) \
            == sorted((l, lv) for l in range(s.trainer.cfg.num_layers)
                      for lv in ("intra", "inter"))
    fwd = {(sp.layer, sp.level): gathers(i) for i, sp in halo if sp.direction == "forward"}
    bwd = {(sp.layer, sp.level): gathers(i) for i, sp in halo if sp.direction == "backward"}
    assert fwd == bwd and all(fwd.values())
    assert all(rec.spans[i].host_s > 0 for i, _ in halo)
