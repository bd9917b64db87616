"""A ``shard_map`` step lowered as its ranks' own programs
(``ShardMapRuntime.lower_step``, ``Session.lower()``), against the JAX
package's lowered ``shard_map`` program on the virtual devices
``conftest.py`` sets up, and the audit rules on rank programs.

Two specs: the flat P = 4 ``specs/shard_map.json`` and the hierarchical
2x2 Int2 ``inter_cd=2`` overlap spec of ``test_torch_multiproc.HIER``.
Each JAX program is lowered and compiled once for the module
(``repro.analysis.rules.AuditContext``); the port's ranks are recorded on
the CPU on torch's ``fake`` backend, with one intra-op thread.

The JAX module lists its collectives in program order with no layer or
direction, so they are split here by its structure: the exchange's
collectives before the first all-reduce are the forward's, layer by layer
in equal shares, the rest the backward's, last layer first; within a
layer a grouped (inter) stage runs from its reduce-scatter to its
all-gather, and every other all-to-all is the a2a stage's (flat or
intra). Differences from the JAX program, reckoned by name:

* the gradient sum: the JAX program all-reduces each loss scalar and each
  gradient leaf; a rank all-gathers one vector of its loss count before
  the forward and one of its flat gradient and three loss scalars after
  the backward, and sums in rank order (``launch.spmd``). Both are over
  all P workers;
* the bytes of a quantized all-to-all: the JAX program carries one int32
  holder per value, a rank the packed words (ROADMAP C-ref18);
* the (zero, scale) pair of a quantized all-to-all: the JAX program moves
  the zeros and the scales in two float all-to-alls, a rank both in one
  ``[rows / 4, 2]`` buffer, one collective fewer with the same bytes
  (ROADMAP C-ref19); ``_rank_exchange`` counts that buffer twice;
* the order: a rank's all_gather of a grouped stage follows its local
  aggregation (it needs the all_to_all's data), where the JAX program's
  precedes it;
* the JAX package's audit reports INFO notes on a 2x2 mesh, where the
  intra and inter groups have one size, and its retrace-guard counts
  compiled executables, which some JAX versions do not keep to one
  (ROADMAP C-ref5): both are left out of its bar.
"""

import dataclasses

import pytest
import torch

import repro.analysis.hlo_rules  # noqa: F401  (registers the JAX package's rules)
from repro.analysis.ir import compiled_collectives
from repro.analysis.rules import AuditContext as JAuditContext
from repro.analysis.rules import run_rules as jrun_rules
from repro.run.spec import RunSpec as JRunSpec

import repro_torch.analysis  # noqa: F401  (registers the step rules)
from repro_torch.analysis.audit import audit_spec
from repro_torch.analysis.ir import LoweredStep, RankPrograms, StepOp, _klass
from repro_torch.analysis.rules import AuditContext, run_rules
from repro_torch.launch import spmd
from repro_torch.quant.stochastic import words_per_row
from repro_torch.run import RunSpec, build_session

from test_torch_multiproc import HIER
from test_torch_train import ROOT

SM = ["exec.mode=shard_map", "exec.nprocs=0"]
SPECS = {"flat": lambda cls: cls.load(ROOT / "specs" / "shard_map.json"),
         "hier": lambda cls: cls().with_overrides(HIER + SM)}
FLAGSHIP = ROOT / "specs" / "flagship_hier_int2_overlap.json"
JAX_KIND = {"all-to-all": "all-to-all", "reduce-scatter": "psum_scatter",
            "all-gather": "all_gather", "all-reduce": "psum"}
STRUCTURAL = ("overlap-order", "wire-dtype", "replica-groups", "predicted-bytes")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def programs():
    """Per spec: the JAX package's audit context (lowered module, compiled
    collectives, rule results) and the port's session and rank programs."""
    out = {}
    for name, make in SPECS.items():
        jctx = JAuditContext(make(JRunSpec), spec_name=name)
        sess = build_session(make(RunSpec), device="cpu")
        out[name] = {
            "jmodule": jctx.module,
            "jbytes": compiled_collectives(jctx.compiled_text),
            "jpredicted": jctx.session.predicted_hlo_wire_bytes(),
            "jaudit": jrun_rules(jctx, list(STRUCTURAL)),
            "session": sess, "lowered": sess.lower(),
        }
    yield out
    for rec in out.values():
        rec["session"].close()


def _jax_exchange(module, layers: int):
    """{(layer, direction, level): [(kind, group size, groups, float)]} of
    the JAX module's exchange collectives (module docstring)."""
    ops = module.collectives()
    first_psum = next(i for i, o in enumerate(ops) if o.op == "all-reduce")
    wire = [o for o in ops if o.op != "all-reduce"]
    fwd = [o for o in wire if o.line < ops[first_psum].line]
    bwd = [o for o in wire if o.line > ops[first_psum].line]
    assert len(fwd) == len(bwd) and len(fwd) % layers == 0
    n = len(fwd) // layers
    out = {}
    for direction, seq, order in (("forward", fwd, range(layers)),
                                  ("backward", bwd, reversed(range(layers)))):
        for chunk, layer in zip(range(0, len(seq), n), order):
            grouped = False
            for o in seq[chunk:chunk + n]:
                grouped = grouped or o.op == "reduce-scatter"
                level = "inter" if grouped else "a2a"
                out.setdefault((layer, direction, level), []).append(
                    (JAX_KIND[o.op], o.replica_groups.group_size,
                     o.replica_groups.num_groups, o.is_float))
                grouped = grouped and o.op != "all-gather"
    return out


def _rank_exchange(lowered):
    """The same view of the ranks' programs: every rank's op at one
    position, with its group size and the number of distinct groups. The
    one (zero, scale) all-to-all stands for the JAX program's two
    (C-ref19)."""
    out = {}
    for ops in zip(*(p.collectives() for p in lowered.programs)):
        o = ops[0]
        if o.kind == "psum":
            continue
        level = "inter" if o.level == "inter" else "a2a"
        groups = {tuple(sorted(x.group)) for x in ops}
        assert o.role != "params" or o.shape[-1] == 2
        out.setdefault((o.layer, o.direction, level), []).extend(
            [(o.kind, len(o.group), len(groups), o.is_float)] * (2 if o.role == "params" else 1))
    return out


@pytest.mark.parametrize("name", list(SPECS))
def test_collectives_per_layer_and_direction_match_jax(programs, name):
    rec = programs[name]
    lowered = rec["lowered"]
    layers = rec["session"].trainer.cfg.num_layers
    assert isinstance(lowered, RankPrograms) and len(lowered.programs) == 4
    assert [p.rank for p in lowered.programs] == [0, 1, 2, 3]
    assert _rank_exchange(lowered) == _jax_exchange(rec["jmodule"], layers)
    # The gradient sum: all-reduces over all P workers in the JAX program,
    # two psums (loss count, then gradients and loss scalars) on a rank.
    jpsum = {(JAX_KIND[o.op], o.replica_groups.group_size, o.replica_groups.num_groups)
             for o in rec["jmodule"].collectives("all-reduce")}
    for prog in lowered.programs:
        psums = [o for o in prog.collectives() if o.kind == "psum"]
        assert len(psums) == 2 and psums[0].index == 0
        assert {(o.kind, len(o.group), 1) for o in psums} == jpsum == {("psum", 4, 1)}


@pytest.mark.parametrize("name", list(SPECS))
def test_groups_partition_the_workers(programs, name):
    lowered = programs[name]["lowered"]
    for ops in zip(*(p.collectives() for p in lowered.programs)):
        groups = {tuple(sorted(o.group)) for o in ops}
        assert len(groups) * len(ops[0].group) == 4
        assert sorted(r for g in groups for r in g) == [0, 1, 2, 3]
        assert all(p.rank in o.group for p, o in zip(lowered.programs, ops))


@pytest.mark.parametrize("name", list(SPECS))
def test_all_to_all_bytes_equal_the_predictions(programs, name):
    """Per rank, the recorded all-to-all bytes equal the port's prediction
    exactly; the JAX program's compiled count is the same but for the
    quantized payloads' int32 holders (C-ref18)."""
    rec = programs[name]
    sess, lowered = rec["session"], rec["lowered"]
    predicted = sess.predicted_hlo_wire_bytes()["total"]
    dims = sess.trainer.cfg.dims()
    jax_bytes = rec["jbytes"]["all-to-all"]["operand_bytes"]
    assert jax_bytes == rec["jpredicted"]["total"]
    for prog in lowered.programs:
        a2a = prog.collectives("all-to-all")
        assert sum(o.bytes for o in a2a) == predicted
        holders = sum(o.shape[0] * dims[o.layer] * 4 - o.bytes for o in a2a
                      if o.role == "payload" and not o.is_float)
        assert holders == sum(o.shape[0] * (dims[o.layer] - words_per_row(dims[o.layer], 2)) * 4
                              for o in a2a if o.role == "payload" and not o.is_float)
        assert predicted + holders == jax_bytes
    assert (holders > 0) == (name == "hier")


@pytest.mark.parametrize("name", list(SPECS))
def test_overlap_flags_equal_jax(programs, name):
    """The overlap flags are the JAX program's. The stated exception: a
    rank's all_gather follows its local aggregation, the JAX program's
    precedes its first dot."""
    rec = programs[name]
    jorder = rec["jmodule"].collective_order()
    order = rec["lowered"].collective_order()
    for key in ("wire_before_compute", "inter_wire_before_compute"):
        assert order[key] == jorder[key], key
    assert order["inter_a2a_before_compute"] == (name == "hier")
    if name == "hier":
        assert rec["jmodule"].collectives("all-gather")[0].line < jorder["first_compute"]["line"]
        for prog in rec["lowered"].programs:
            for layer in (0, 1):
                fwd = [o for o in prog.ops if o.layer == layer and o.direction == "forward"]
                local = next(o.index for o in fwd if o.role == "local")
                a2a = [o.index for o in fwd if o.kind == "all-to-all" and o.level == "inter"]
                gather = [o.index for o in fwd if o.kind == "all_gather"]
                assert max(a2a) < local < min(gather)


@pytest.mark.parametrize("name", list(SPECS))
def test_both_audits_are_clean(programs, name):
    jres = programs[name]["jaudit"]
    assert jres["rule_errors"] == []
    assert [str(f) for f in jres["findings"] if f.severity != "info"] == []
    res = audit_spec(SPECS[name](RunSpec), spec_name=name, steps=2, device="cpu")
    assert res["rule_errors"] == [] and [str(f) for f in res["findings"]] == []
    assert res["skipped"] == ([] if name == "hier" else ["wire-dtype"])   # fp32
    assert res["ranks"] == 4


def test_flagship_audits_clean_as_rank_programs():
    res = audit_spec(RunSpec.load(FLAGSHIP), spec_name="flagship", steps=2, device="cpu")
    assert res["rule_errors"] == [] and [str(f) for f in res["findings"]] == []
    assert len(res["ran"]) == 5 and res["skipped"] == [] and res["ranks"] == 8


def test_ranks_that_disagree_make_lower_step_raise(programs, monkeypatch):
    lower = spmd._LowerRank.lower

    def lower_one_op_short(self, epoch, wrap=None):
        prog = lower(self, epoch, wrap)
        return dataclasses.replace(prog, ops=prog.ops[:-1]) if self.rank == 2 else prog

    monkeypatch.setattr(spmd._LowerRank, "lower", lower_one_op_short)
    with pytest.raises(RuntimeError, match="rank 2 records"):
        programs["flat"]["session"].lower()


# -- mutants of hand-built rank programs -------------------------------------

P, G, W = 8, 2, 4
ROWS = {"intra": 112, "inter": 56}       # per worker, at the wire


def _node(r):
    return tuple(r // W * W + v for v in range(W))


def _across(r):
    return tuple(b * W + r % W for b in range(G))


def _rank_rows(r, layer, f, direction="forward"):
    """One layer's ops of rank ``r`` as ``CollectiveWire`` issues them: the
    inter stage (psum_scatter, Int2 words, (zero, scale) pairs), the intra
    stage, the local aggregation, the receives and the inter all_gather."""
    words = -(-f // 16)
    ri, re = ROWS["intra"], ROWS["inter"]
    fwd = [
        ("seg_aggregate", "inter", "send", "float32", (1, re * W, f), None, ()),
        ("psum_scatter", "inter", "", "float32", (re, f), W, _node(r)),
        ("quant_pack", "inter", "", "int32", (re, words), None, ()),
        ("all-to-all", "inter", "payload", "int32", (re, words), G, _across(r)),
        ("all-to-all", "inter", "params", "float32", (re // 4, 2), G, _across(r)),
        ("seg_aggregate", "intra", "send", "float32", (1, ri, f), None, ()),
        ("all-to-all", "intra", "payload", "float32", (ri, f), W, _node(r)),
        ("seg_aggregate", "", "local", "float32", (1, 41, f), None, ()),
        ("seg_aggregate", "intra", "recv", "float32", (1, 41, f), None, ()),
        ("dequant_unpack", "inter", "", "float32", (re, f), None, ()),
        ("all_gather", "inter", "", "float32", (W, re, f), W, _node(r)),
        ("seg_aggregate", "inter", "recv", "float32", (1, 41, f), None, ()),
    ]
    if direction == "forward":
        return [(direction, layer) + row for row in fwd]
    return [(direction, layer) + row for row in fwd
            if row[0] in ("psum_scatter", "all-to-all", "all_gather")]


def _rank_program(r, rows=None):
    rows = rows if rows is not None else (
        [("forward", None, "psum", "", "", "float32", (1,), P, tuple(range(P)))]
        + _rank_rows(r, 0, 16) + _rank_rows(r, 1, 32)
        + _rank_rows(r, 1, 32, "backward") + _rank_rows(r, 0, 16, "backward")
        + [("forward", None, "psum", "", "", "float32", (2000,), P, tuple(range(P)))])
    ops = []
    for direction, layer, kind, level, role, dtype, shape, chunks, group in rows:
        n = 1
        for d in shape:
            n *= d
        ops.append(StepOp(kind=kind, klass=_klass(kind), index=len(ops),
                          direction=direction, layer=layer, level=level, role=role,
                          dtype=dtype, shape=shape, bytes=4 * n, chunks=chunks,
                          group=group))
    return LoweredStep(ops=ops, epoch=0, nparts=P, rank=r)


def _programs(mutate=None):
    progs = [_rank_program(r) for r in range(P)]
    if mutate is not None:
        progs = [mutate(p) for p in progs]
    return RankPrograms(ranks=progs, epoch=0, nparts=P)


def _a2a_total(prog):
    return float(sum(o.bytes for o in prog.collectives("all-to-all")))


PRISTINE = _programs()


def _rank_ctx(lowered):
    ctx = AuditContext(RunSpec.load(FLAGSHIP), spec_name="fixture", device="cpu")
    ctx._lowered = lowered
    total = _a2a_total(PRISTINE.ranks[0])
    ctx._predicted = {"intra": sum(o.bytes for o in PRISTINE.ranks[0].collectives("all-to-all")
                                   if o.level == "intra"),
                      "total": total}
    ctx._predicted["inter"] = total - ctx._predicted["intra"]
    return ctx


def _findings(lowered):
    res = run_rules(_rank_ctx(lowered), list(STRUCTURAL))
    assert res["rule_errors"] == [] and sorted(res["ran"]) == sorted(STRUCTURAL)
    return res["findings"]


def _on_rank(rank, pred, **changes):
    def mutate(prog):
        if prog.rank != rank:
            return prog
        return dataclasses.replace(prog, ops=[
            dataclasses.replace(o, **changes) if pred(o) else o for o in prog.ops])
    return mutate


def test_pristine_rank_programs_are_clean():
    assert _findings(PRISTINE) == []
    assert PRISTINE.collective_order()["inter_a2a_before_compute"]


def test_group_of_the_wrong_size_fires_replica_groups_only():
    wrong = lambda o: o.level == "intra" and o.kind == "all-to-all" and o.layer == 1
    three = lambda r: tuple(sorted({r, (r + 1) % P, (r + 2) % P}))
    found = _findings(_programs(lambda p: _on_rank(p.rank, wrong, group=three(p.rank))(p)))
    assert {f.rule for f in found} == {"replica-groups"}
    assert {f.data.get("group_size") for f in found} >= {3}


@pytest.mark.parametrize("fault", ["overlap", "miss"])
def test_groups_that_overlap_or_miss_a_worker_fire_replica_groups_only(fault):
    node = lambda o: o.level == "intra" and o.kind == "all-to-all" and o.layer == 0
    if fault == "overlap":      # ranks 4..7 over (2, 3, 4, 5)
        mutate = lambda p: (_on_rank(p.rank, node, group=(2, 3, 4, 5))(p)
                            if p.rank >= 4 else p)
    else:                       # ranks 1 and 5 take ranks 0 and 4's group
        inter = lambda o: o.level == "inter" and o.kind == "all-to-all"
        mutate = lambda p: (_on_rank(p.rank, inter, group=(0, 4))(p)
                            if p.rank in (1, 5) else p)
    found = _findings(_programs(mutate))
    assert {f.rule for f in found} == {"replica-groups"}
    partition = [f for f in found if "total" in f.data]
    assert partition and all(f.data["nparts"] == P for f in partition)
    if fault == "miss":
        assert all(f.data["missing"] == [1, 5] for f in partition)


def test_float_payload_on_a_quantized_stage_fires_wire_dtype_only():
    mutate = _on_rank(3, lambda o: o.level == "inter" and o.role == "payload"
                      and o.direction == "backward" and o.layer == 0, dtype="float32")
    found = _findings(_programs(mutate))
    assert [f.rule for f in found] == ["wire-dtype"]
    assert "rank 3" in found[0].message and found[0].location.startswith("rank 3 step:")


def test_all_to_all_bytes_twenty_percent_off_fire_predicted_bytes_only():
    extra = 0.2 * _a2a_total(PRISTINE.ranks[0])
    first = lambda o: o.kind == "all-to-all" and o.level == "intra" and o.layer == 0 \
        and o.direction == "forward"
    op = next(o for o in PRISTINE.ranks[6].ops if first(o))
    found = _findings(_programs(_on_rank(6, first, bytes=op.bytes + int(extra))))
    assert [f.rule for f in found] == ["predicted-bytes"]
    assert found[0].data["rank"] == 6 and "20.0% off" in found[0].message


def test_inter_all_to_all_after_the_local_aggregation_fires_overlap_order_only():
    """The issue order the rank had before its repair: the wire between
    groups posted in ``collect``, after the local aggregation."""
    def late(prog):
        if prog.rank != 2:
            return prog
        ops = list(prog.ops)
        moved = [o for o in ops if o.layer == 1 and o.direction == "forward"
                 and o.level == "inter" and o.kind in ("quant_pack", "all-to-all")]
        rest = [o for o in ops if o not in moved]
        local = next(i for i, o in enumerate(rest) if o.layer == 1 and o.role == "local")
        ops = rest[:local + 1] + moved + rest[local + 1:]
        return dataclasses.replace(prog, ops=[dataclasses.replace(o, index=i)
                                              for i, o in enumerate(ops)])

    lowered = _programs(late)
    found = _findings(lowered)
    assert [f.rule for f in found] == ["overlap-order"]
    assert found[0].data["rank"] == 2 and found[0].location.startswith("rank 2 ")
    order = lowered.collective_order()
    assert order["inter_wire_before_compute"] and not order["inter_a2a_before_compute"]
    assert [r["inter_a2a_before_compute"] for r in order["ranks"]] == [
        r != 2 for r in range(P)]
