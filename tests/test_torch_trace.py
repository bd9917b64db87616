"""The port's spans (``core.record``): named ranges at the training step's
and the set-up's call sites.

With torch's profiler off, a step registers no backward hook and keeps no
record; under a CPU ``torch.profiler`` every site is a host event that is
not a user annotation (so it casts no range onto a device timeline), the
spans nest as the step runs, the hooked backward spans carry their
forward's scope, and the losses and parameters are bitwise those of the
run with the profiler off. The set-up spans time ``build_partition`` as a
host clock around it does.

Two programs: the small flagship session (8 workers stacked, hierarchical
2x4, Int2 inter wire every 2 epochs, overlap) and a GAT single-device step.
"""

import contextlib
import time
from pathlib import Path
from typing import NamedTuple

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.train_products_paper import FLAGSHIP
from repro_torch.core import record
from repro_torch.core.model import GCNConfig, init_params
from repro_torch.core.randomness import GeneratorRandomness
from repro_torch.core.trainer import prepare_single, single_train_step
from repro_torch.graph import sbm_graph
from repro_torch.graph.generators import sbm_features
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import tree_leaves
from repro_torch.run import RunSpec, build_session
from repro_torch.run import session as session_mod

ROOT = Path(__file__).resolve().parents[1]
EPOCHS = 3
PROGRAMS = ["hier", "gat"]
GAT = GCNConfig(model="gat", in_dim=16, hidden_dim=32, num_classes=4, num_layers=2,
                dropout=0.5, label_prop=True)

STEP = {"gnn.step", "gnn.forward", "gnn.loss", "gnn.backward", "gnn.adamw",
        "gnn.lp_embed", "gnn.layer"}
SITES = {
    "hier": STEP | {"gnn.aggregate.local"} | {
        f"gnn.exchange.{s}" for s in (
            "issue", "finalize", "send", "assemble", "send_gather", "pre_aggregate",
            "wire", "pre_wire", "a2a", "quantized", "quantize", "dequantize",
            "post_wire", "scatter")},
    "gat": STEP | {"gnn.gat.gather"},
}
# The spans whose backward a hook on the index op's own node opens.
HOOKED = {"hier": ("gnn.exchange.send_gather", "gnn.lp_embed"),
          "gat": ("gnn.gat.gather", "gnn.lp_embed")}


@pytest.fixture(autouse=True, scope="module")
def deterministic():
    """One intra-op thread, and deterministic algorithms: PyTorch's
    multi-threaded backward of advanced indexing adds with atomics on the
    CPU, so two runs compare bitwise only with them."""
    n, det = torch.get_num_threads(), torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(det)
    torch.set_num_threads(n)


class Run(NamedTuple):
    losses: list
    params: list
    prof: object          # the profiler, or None
    steps: list           # the step records kept meanwhile
    hooks: int            # backward hooks registered meanwhile


def _hier():
    session = build_session(RunSpec.from_dict(FLAGSHIP), device="cpu")
    return (lambda: session.train_epoch()["loss"]), (lambda: session.trainer.params)


def _gat():
    g = sbm_graph(300, 4, avg_degree=8, homophily=0.85, seed=0)
    x, _ = sbm_features(g, 16, noise=1.5, seed=1)
    data = prepare_single(g, x, layouts=("bucketed",), device="cpu")
    state = {"params": init_params(GAT, torch.Generator().manual_seed(0)), "epoch": 0}
    state["opt"] = adamw_init(state["params"])
    draws = GeneratorRandomness(0)

    def step():
        state["params"], state["opt"], m = single_train_step(
            state["params"], state["opt"], GAT, data, draws, state["epoch"])
        state["epoch"] += 1
        return float(m["loss"])
    return step, (lambda: state["params"])


def _run(program: str, profiled: bool) -> Run:
    step, params = {"hier": _hier, "gat": _gat}[program]()
    record.SPANS.steps.clear()
    hooked, real = [], record._hook_backward

    def count(node, fwd):
        hooked.append(node)
        real(node, fwd)

    record._hook_backward = count
    ctx = profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext()
    try:
        with ctx as prof:
            losses = [step() for _ in range(EPOCHS)]
    finally:
        record._hook_backward = real
    return Run(losses, [t.clone() for t in tree_leaves(params())], prof,
               record.traced_steps(), len(hooked))


@pytest.fixture(scope="module")
def runs():
    return {(p, profiled): _run(p, profiled) for p in PROGRAMS for profiled in (False, True)}


@pytest.mark.parametrize("program", PROGRAMS)
def test_off_registers_no_hook_and_keeps_no_record(runs, program):
    off = runs[(program, False)]
    assert off.hooks == 0 and off.steps == []
    assert runs[(program, True)].hooks > 0


@pytest.mark.parametrize("program", PROGRAMS)
def test_spans_change_no_value(runs, program):
    off, on = runs[(program, False)], runs[(program, True)]
    assert on.losses == off.losses
    assert len(on.params) == len(off.params)
    assert all(torch.equal(a, b) for a, b in zip(on.params, off.params))


@pytest.mark.parametrize("program", PROGRAMS)
def test_one_record_per_profiled_step(runs, program):
    on = runs[(program, True)]
    assert [r.epoch for r in on.steps] == list(range(EPOCHS))
    for r in on.steps:
        assert r.spans[0].name == "gnn.step" and r.spans[0].parent is None
        assert [r.spans[i].name for i in r.children(0)] == [
            "gnn.forward", "gnn.loss", "gnn.backward", "gnn.adamw"]
        assert not r.cuda and all(s.device_s is None for s in r.spans)


@pytest.mark.parametrize("program", PROGRAMS)
def test_self_time_is_duration_minus_children(runs, program):
    for r in runs[(program, True)].steps:
        for i, s in enumerate(r.spans):
            kids = sum(r.spans[j].host_s for j in r.children(i))
            assert s.self_host_s == pytest.approx(s.host_s - kids, rel=1e-12, abs=1e-15)
            assert s.self_host_s >= -1e-6 and s.host_s > 0


@pytest.mark.parametrize("program", PROGRAMS)
def test_sites_are_host_events_not_annotations(runs, program):
    events = [e for e in runs[(program, True)].prof.events()
              if e.name.startswith("gnn.")]
    assert {e.name for e in events} == SITES[program]
    assert not any(e.is_user_annotation for e in events)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in events)
    kept = {s.name for r in runs[(program, True)].steps for s in r.spans}
    assert kept == SITES[program]


def _ancestors(r, i):
    out = []
    while r.spans[i].parent is not None:
        i = r.spans[i].parent
        out.append(r.spans[i])
    return out


def test_send_gather_nests_in_issue_in_its_layer(runs):
    r = runs[("hier", True)].steps[0]            # a refresh epoch: both stages' wires
    gathers = [(i, s) for i, s in enumerate(r.spans)
               if s.name == "gnn.exchange.send_gather" and s.direction == "forward"]
    assert sorted((s.layer, s.level) for _, s in gathers) == [
        (l, v) for l in range(2) for v in ("inter", "intra")]
    for i, s in gathers:
        up = _ancestors(r, i)
        assert [a.name for a in up] == ["gnn.exchange.assemble", "gnn.exchange.send",
                                        "gnn.exchange.issue", "gnn.layer", "gnn.forward",
                                        "gnn.step"]
        assert up[1].level == s.level and up[3].layer == s.layer
    stale = runs[("hier", True)].steps[1]        # inter_cd = 2: the inter wire is skipped
    assert {s.level for s in stale.spans if s.name == "gnn.exchange.send_gather"} == {"intra"}


@pytest.mark.parametrize("program", PROGRAMS)
def test_hooked_backward_spans_carry_their_forward_scope(runs, program):
    for r in runs[(program, True)].steps:
        for name in HOOKED[program]:
            scope = lambda d: sorted((s.layer, s.level, s.role, s.which)
                                     for s in r.spans if s.name == name and s.direction == d)
            assert scope("backward") and scope("backward") == scope("forward")
            for i, s in enumerate(r.spans):
                if s.name == name and s.direction == "backward":
                    assert "gnn.backward" in [a.name for a in _ancestors(r, i)]


def test_gat_gathers_are_named_by_which(runs):
    r = runs[("gat", True)].steps[0]
    which = {s.which for s in r.spans if s.name == "gnn.gat.gather"}
    assert which == {"e_dst", "e_src", "whh"}


@pytest.mark.parametrize("program", PROGRAMS)
def test_backward_of_autograd_functions_is_spanned(runs, program):
    """The aggregation's (and in hier the wire's) autograd Functions, hooked
    at their call sites, open their forward's span around their backward."""
    r = runs[(program, True)].steps[0]
    back = {(s.name, s.role) for s in r.spans if s.direction == "backward"}
    if program == "gat":
        assert ("gnn.aggregate.local", "local") not in back
        return
    assert {("gnn.aggregate.local", "local"), ("gnn.exchange.pre_aggregate", "send"),
            ("gnn.exchange.scatter", "recv"), ("gnn.exchange.a2a", ""),
            ("gnn.exchange.quantized", "")} <= back


def test_device_means_need_the_card_and_enough_steps(runs):
    assert runs[("hier", True)].steps
    assert record.step_device_ms(EPOCHS, "gnn.lp_embed") is None      # the CPU
    assert record.step_device_ms(len(record.SPANS.steps) + 1, "gnn.lp_embed") is None
    r = runs[("hier", True)].steps[0]
    outer = r.outermost("gnn.exchange.")
    assert outer == [s for s in r.spans if s.name in ("gnn.exchange.issue",
                                                      "gnn.exchange.finalize")
                     or (s.name.startswith("gnn.exchange.") and s.parent is not None
                         and r.spans[s.parent].name == "gnn.backward")]
    assert {s.direction for s in outer} == {"forward", "backward"}


def test_names_hold_no_kernel_name_and_are_checked():
    for name in record.STEP_SPANS + record.SETUP_SPANS:
        assert not any(k in name for k in ("seg_aggregate", "quant_pack", "dequant_unpack"))
    with pytest.raises(ValueError):
        record.setup_span("setup.elsewhere")
    assert record.span("gnn.elsewhere") is record._OFF         # off: not even checked
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            record.span("gnn.elsewhere")


@pytest.mark.parametrize("spec", ["flagship", "flat_fp32"])
def test_setup_partition_matches_a_host_clock(spec):
    if spec == "flagship":
        s = RunSpec.from_dict(FLAGSHIP).with_overrides(["graph.nodes=2048"])
    else:
        s = RunSpec.load(ROOT / "specs" / "flat_fp32.json").with_overrides(["graph.nodes=2048"])
    g, _ = session_mod.build_graph(s)
    t0 = time.perf_counter()
    session_mod.build_partition(s, g)
    clock = time.perf_counter() - t0
    assert record.setup_seconds("setup.partition") == pytest.approx(clock, rel=0.05)
    rec = record.setup_spans()[-1]
    assert rec.spans[0].name == "setup.partition"
    names = [rec.spans[j].name for j in rec.descendants(0)]
    assert names == ["setup.partition.labels"]
    labels = record.setup_seconds("setup.partition.labels", within="setup.partition")
    assert 0 < labels < rec.spans[0].host_s


def test_a_session_build_is_one_setup_record():
    record.SPANS.setups.clear()
    build_session(RunSpec.from_dict(FLAGSHIP), device="cpu")
    recs = record.setup_spans()
    assert [[s.name for s in r.spans] for r in recs] == [
        ["setup.partition", "setup.partition.labels"]]
    assert recs[0].children(0) == [1] and 0 < recs[0].spans[1].host_s < recs[0].spans[0].host_s
