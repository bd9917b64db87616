"""The port's audit gate (``repro_torch.analysis``) and the recorded step it
reads, on the CPU.

The rule tests mirror ``tests/test_analysis_rules.py``: each mutant of a
pristine flagship-topology step (G=2 groups x W=4 workers, Int2 inter
wire, inter_cd=2, overlap) injects one invariant violation and must fire
its rule and no other; the step is built by hand, so no session is built.
The end-to-end tests record real steps of the checked-in specs (256
nodes) and hold them to ``Session.predicted_hlo_wire_bytes``, to the JAX
package's byte prediction, and to training without recording, bitwise."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.run.session as jsession
from repro.run.spec import RunSpec as JRunSpec

import repro_torch.analysis  # noqa: F401  (registers the step rules)
from repro_torch.analysis import audit as taudit
from repro_torch.analysis.ast_lint import lint_paths, lint_source
from repro_torch.analysis.audit import audit_spec, exit_code
from repro_torch.analysis.hlo_rules import epoch_phases, stage_wire_summary
from repro_torch.analysis.ir import LoweredStep, StepOp, _klass
from repro_torch.analysis.rules import (
    RULES,
    AuditContext,
    Finding,
    Severity,
    run_rules,
    worst_severity,
)
from repro_torch.core import exchange as X
from repro_torch.optim.adamw import tree_leaves
from repro_torch.run import RunSpec, build_session
from repro_torch.run import matrix as tmatrix

ROOT = Path(__file__).resolve().parents[1]
SPECS = ROOT / "specs"
FLAGSHIP = SPECS / "flagship_hier_int2_overlap.json"
ALL_RULES = ("overlap-order", "predicted-bytes", "replica-groups",
             "retrace-guard", "wire-dtype")
STRUCTURAL = ("overlap-order", "wire-dtype", "replica-groups")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test runner runs several workers side by
    side, and PyTorch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


# -- a hand-built flagship step ------------------------------------------------

P, W = 8, 4
WIRE_ROWS = {"intra": 112, "inter": 56}       # per worker, at the wire


def _ops(layer, f, direction="forward"):
    """One layer's recorded ops as the stacked trainer issues them: the
    inter stage (psum_scatter, Int2 words, (zero, scale)), the intra stage
    (fp32), then the local aggregation and both receive scatters."""
    words = -(-f // 16)
    ri, re = WIRE_ROWS["intra"], WIRE_ROWS["inter"]
    fwd = [
        ("seg_aggregate", "inter", "send", "float32", (P, re * W, f), None),
        ("psum_scatter", "inter", "", "float32", (P, re, f), W),
        ("quant_pack", "inter", "", "int32", (P, re, words), None),
        ("all-to-all", "inter", "payload", "int32", (P, re, words), 2),
        ("all-to-all", "inter", "params", "float32", (P, re // 4, 1), 2),
        ("all-to-all", "inter", "params", "float32", (P, re // 4, 1), 2),
        ("dequant_unpack", "inter", "", "float32", (P, re, f), None),
        ("all_gather", "inter", "", "float32", (P, re * W, f), W),
        ("seg_aggregate", "intra", "send", "float32", (P, ri, f), None),
        ("all-to-all", "intra", "payload", "float32", (P, ri, f), W),
        ("seg_aggregate", "", "local", "float32", (P, 41, f), None),
        ("seg_aggregate", "intra", "recv", "float32", (P, 41, f), None),
        ("seg_aggregate", "inter", "recv", "float32", (P, 41, f), None),
    ]
    bwd = [row for row in fwd if row[0] == "all-to-all"]
    return [(direction, layer) + row for row in (fwd if direction == "forward" else bwd)]


def _step(rows=None):
    rows = rows if rows is not None else (
        _ops(0, 16) + _ops(1, 32) + _ops(1, 32, "backward") + _ops(0, 16, "backward"))
    ops = []
    for direction, layer, kind, level, role, dtype, shape, chunks in rows:
        size = 4 * int(np.prod(shape[1:]))
        ops.append(StepOp(kind=kind, klass=_klass(kind), index=len(ops),
                          direction=direction, layer=layer, level=level,
                          role=role, dtype=dtype, shape=shape, bytes=size,
                          chunks=chunks))
    return LoweredStep(ops=ops, epoch=0, nparts=P)


def _a2a_bytes(step, level):
    return float(sum(o.bytes for o in step.collectives("all-to-all") if o.level == level))


PRISTINE = _step()
PREDICTED = {lv: _a2a_bytes(PRISTINE, lv) for lv in ("intra", "inter")}
PREDICTED["total"] = sum(PREDICTED.values())


class _StubSession:
    """What retrace-guard touches: fit, the trainer's epoch, the count."""

    def __init__(self, signatures):
        self.signatures = signatures
        self.trainer = type("T", (), {"epoch": 0})()
        self.fitted = 0

    def fit(self, epochs, log_every=None):
        self.fitted += epochs

    def step_cache_size(self):
        return self.signatures

    def close(self):
        pass


def _ctx(step, signatures=2, spec_path=FLAGSHIP):
    """A context for a stacked step: the spec's vmap variant (a
    shard_map spec is audited on its ranks' programs,
    ``tests/test_torch_shard_map_lower.py``)."""
    spec = RunSpec.load(spec_path).with_overrides(["exec.mode=vmap", "exec.nprocs=0"])
    ctx = AuditContext(spec, spec_name="fixture", device="cpu")
    ctx._lowered = step
    ctx._predicted = PREDICTED
    ctx._session = _StubSession(signatures)
    return ctx


def _run(step, signatures=2):
    res = run_rules(_ctx(step, signatures))
    assert res["rule_errors"] == []
    assert sorted(res["ran"]) == sorted(ALL_RULES)
    return res


def _replace(step, pred, **changes):
    ops = [dataclasses.replace(o, **changes) if pred(o) else o for o in step.ops]
    return dataclasses.replace(step, ops=ops)


class TestMutants:
    def test_pristine_flagship_step_is_clean(self):
        res = _run(PRISTINE)
        assert res["findings"] == []

    def test_wire_after_the_local_aggregation_fires_overlap_order_only(self):
        ops = list(PRISTINE.ops)
        local = next(i for i, o in enumerate(ops)
                     if o.layer == 1 and o.role == "local" and o.direction == "forward")
        first = next(i for i, o in enumerate(ops)
                     if o.layer == 1 and o.direction == "forward")
        ops.insert(first, ops.pop(local))
        step = LoweredStep(ops=[dataclasses.replace(o, index=i) for i, o in enumerate(ops)],
                           nparts=P)
        res = _run(step)
        assert [f.rule for f in res["findings"]] == ["overlap-order"]
        f = res["findings"][0]
        assert f.severity == Severity.ERROR and "overlap" in f.message and f.fix_hint
        order = step.collective_order()
        assert [d["wire_before_compute"] for d in order["layers"]] == [True, False]
        assert order["first_compute"]["layer"] == 1

    def test_float_payload_on_the_int2_stage_fires_wire_dtype_only(self):
        # The words' bytes shipped as fp32: the dtype is wrong, the bytes not.
        step = _replace(PRISTINE, lambda o: o.level == "inter" and o.role == "payload"
                        and o.direction == "forward" and o.layer == 1, dtype="float32")
        res = _run(step)
        assert [f.rule for f in res["findings"]] == ["wire-dtype"]
        f = res["findings"][0]
        assert f.severity == Severity.ERROR and "float32" in f.message
        assert f.location.startswith("step:")

    def test_vanished_quantized_wire_fires_wire_dtype(self):
        step = _replace(PRISTINE, lambda o: o.level == "inter" and o.role == "payload",
                        dtype="float32")
        res = run_rules(_ctx(step), rule_ids=["wire-dtype"])
        assert any("vanished" in f.message for f in res["findings"])

    def test_wrong_chunk_count_fires_replica_groups_only(self):
        step = _replace(PRISTINE, lambda o: o.index == 9, chunks=3)
        res = _run(step)
        assert [f.rule for f in res["findings"]] == ["replica-groups"]
        f = res["findings"][0]
        assert f.severity == Severity.ERROR
        assert f.data["group_size"] == 3 and f.data["allowed"] == [4]

    def test_collective_over_too_few_workers_fires_replica_groups(self):
        step = _replace(PRISTINE, lambda o: o.index == 1, shape=(4, 56, 16))
        res = run_rules(_ctx(step), rule_ids=["replica-groups"])
        assert [f.data.get("total") for f in res["findings"]] == [4]

    def test_bytes_off_by_more_than_ten_percent_fire_predicted_bytes_only(self):
        ops = [dataclasses.replace(o, bytes=2 * o.bytes)
               if o.level == "intra" and o.kind == "all-to-all" else o
               for o in PRISTINE.ops]              # the intra payload shipped twice
        res = _run(dataclasses.replace(PRISTINE, ops=ops))
        assert [f.rule for f in res["findings"]] == ["predicted-bytes"]
        assert res["findings"][0].data["recorded_bytes"] > PREDICTED["total"]

    def test_bytes_within_ten_percent_pass(self):
        step = _replace(PRISTINE, lambda o: o.index == 3, bytes=224 + 100)
        assert run_rules(_ctx(step), rule_ids=["predicted-bytes"])["findings"] == []

    def test_signature_per_epoch_fires_retrace_guard_only(self):
        res = _run(PRISTINE, signatures=3)      # 3 epochs, 3 signatures
        assert [f.rule for f in res["findings"]] == ["retrace-guard"]
        f = res["findings"][0]
        assert f.data == {"epochs": 3, "signatures": 3, "expected": 2}

    def test_quant_params_are_not_payload(self):
        """The fp32 (zero, scale) all-to-alls of the Int2 stage ride as
        params, so they never read as dequant-before-wire."""
        params = [o for o in PRISTINE.collectives("all-to-all")
                  if o.level == "inter" and o.is_float]
        assert len(params) == 8 and all(o.role == "params" for o in params)
        assert all(o.trailing_dim == 1 for o in params)

    def test_stale_inter_stage_is_not_a_vanished_wire(self):
        fresh = [o for o in PRISTINE.ops if o.level != "inter"]
        step = LoweredStep(ops=[dataclasses.replace(o, index=i) for i, o in enumerate(fresh)],
                           epoch=1, nparts=P, stale_levels=("inter",))
        res = run_rules(_ctx(step), rule_ids=["wire-dtype", "predicted-bytes",
                                              "replica-groups"])
        assert res["findings"] == []


class TestSkipsAndContext:
    def test_vmap_spec_runs_the_step_rules(self):
        """The port records its stacked step, so a vmap spec runs the rules
        the JAX package can only run under shard_map."""
        d = json.loads(FLAGSHIP.read_text())
        d["exec"]["mode"] = "vmap"
        ctx = AuditContext(RunSpec.from_dict(d), device="cpu")
        ctx._lowered = PRISTINE
        res = run_rules(ctx, rule_ids=STRUCTURAL)
        assert sorted(res["ran"]) == sorted(STRUCTURAL)
        assert res["skipped"] == [] and res["findings"] == []
        assert ctx.lowered.rank is None and ctx.lowered.programs == (ctx.lowered,)

    def test_shard_map_spec_builds_its_stacked_variant(self):
        """No longer: a shard_map spec's context builds the spec itself and
        reads its ranks' own programs, with their process groups."""
        ctx = AuditContext(RunSpec.load(FLAGSHIP), device="cpu")
        try:
            assert ctx.session.trainer.mode == "shard_map"
            progs = ctx.lowered.programs
            assert [p.rank for p in progs] == list(range(8))
            assert all(o.group for p in progs for o in p.collectives())
            assert not ctx.session.trainer._started       # no fleet
        finally:
            ctx.close()

    def test_multiproc_spec_skips_all_step_rules(self):
        d = json.loads(FLAGSHIP.read_text())
        d["exec"]["mode"] = "multiproc"
        d["exec"]["nprocs"] = d["partition"]["nparts"]
        ctx = AuditContext(RunSpec.from_dict(d), device="cpu")
        res = run_rules(ctx)
        assert res["rule_errors"] == [] and res["ran"] == []
        assert sorted(res["skipped"]) == sorted(ALL_RULES)
        assert ctx._session is None  # no build (or spawn) happened

    def test_all_five_rules_registered(self):
        assert sorted(RULES) == sorted(ALL_RULES)

    def test_schedule_resolves_from_spec_alone(self):
        ctx = AuditContext(RunSpec.load(FLAGSHIP), device="cpu")
        assert stage_wire_summary(ctx) == {"inter": 2, "intra": 4}
        assert ctx._session is None

    def test_epoch_phases(self):
        sched = lambda **kw: RunSpec.load(FLAGSHIP).with_overrides(
            [f"schedule.{k}={v}" for k, v in kw.items()]).schedule.to_dist_config(
            RunSpec.load(FLAGSHIP).partition).schedule()
        assert epoch_phases(sched(inter_cd=1), range(5)) == 1
        assert epoch_phases(sched(inter_cd=2), range(1)) == 1
        assert epoch_phases(sched(inter_cd=2), range(3)) == 2
        assert epoch_phases(sched(inter_cd=3), range(3)) == 2    # refresh, stale, stale
        assert epoch_phases(sched(intra_cd=2, inter_cd=3), range(6)) == 4

    def test_crashing_rule_reports_error_finding(self):
        class Boom:
            id = "boom"

            def applies(self, ctx):
                return True

            def check(self, ctx):
                raise RuntimeError("kaboom")

        RULES.add("boom", Boom())
        try:
            res = run_rules(_ctx(PRISTINE), rule_ids=["boom"])
            assert res["rule_errors"] == ["boom"]
            assert res["findings"][0].severity == Severity.ERROR
            assert "kaboom" in res["findings"][0].message
        finally:
            del RULES._entries["boom"]


class TestAstLint:
    def test_breakpoint_and_pdb_flagged_anywhere(self):
        src = ("import pdb\n"
               "def f():\n"
               "    breakpoint()\n"
               "    pdb.set_trace()\n")
        findings = lint_source(src, "src/repro_torch/run/cli.py")
        assert [f.rule for f in findings] == ["debug-stmt", "debug-stmt"]
        assert findings[0].location.endswith("cli.py:3")

    @pytest.mark.parametrize("call", ["y.item()", "y.cpu()", "y.numpy()",
                                      "y.tolist()", "np.asarray(y)", "np.array(y)"])
    def test_host_sync_in_hot_tensor_function_flagged(self, call):
        src = ("import numpy as np\n"
               "import torch\n"
               "def step(x):\n"
               "    y = torch.relu(x)\n"
               f"    return {call}\n")
        findings = lint_source(src, "src/repro_torch/core/trainer.py")
        assert [f.rule for f in findings] == ["host-sync"]
        assert findings[0].location.endswith("trainer.py:5")

    def test_host_sync_ignored_outside_hot_files(self):
        src = ("import torch\n"
               "def summarize(x):\n"
               "    return torch.sum(x).item()\n")
        assert lint_source(src, "src/repro_torch/launch/report.py") == []

    def test_plan_building_in_hot_file_ok(self):
        """numpy plans turned into device tensors (torch.as_tensor and
        dtypes only) are host-side plan building, not a hot-path sync."""
        src = ("import numpy as np\n"
               "import torch\n"
               "def stack_plan(idx, device):\n"
               "    def t(a, dtype):\n"
               "        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)\n"
               "    return t(idx, torch.int64)\n")
        assert lint_source(src, "src/repro_torch/core/exchange.py") == []

    def test_item_with_args_not_flagged(self):
        src = ("import torch\n"
               "def step(d):\n"
               "    torch.zeros(3)\n"
               "    return d.item('key')\n")
        assert lint_source(src, "src/repro_torch/core/trainer.py") == []

    def test_syntax_error_is_a_finding_not_a_crash(self):
        findings = lint_source("def f(:\n", "src/repro_torch/broken.py")
        assert len(findings) == 1 and findings[0].severity == Severity.ERROR

    def test_the_port_lints_clean(self):
        assert lint_paths([ROOT / "src" / "repro_torch"]) == []


class TestExitCodes:
    @staticmethod
    def _report(worst):
        return {"summary": {"worst": worst}}

    def test_clean_is_zero(self):
        assert exit_code(self._report(None)) == 0

    def test_info_is_zero_at_any_threshold(self):
        assert exit_code(self._report("info")) == 0
        assert exit_code(self._report("info"), fail_on="warning") == 0

    def test_warning_below_default_threshold(self):
        assert exit_code(self._report("warning")) == 0
        assert exit_code(self._report("warning"), fail_on="warning") == 1

    def test_error_is_two(self):
        assert exit_code(self._report("error")) == 2
        assert exit_code(self._report("error"), fail_on="warning") == 2

    def test_worst_severity_ordering(self):
        fs = [Finding(rule="r", severity=s, message="")
              for s in ("info", "error", "warning")]
        assert worst_severity(fs) == "error"
        assert worst_severity(fs[:1]) == "info"
        assert worst_severity([]) is None


# -- recorded steps of real sessions --------------------------------------------


def test_flagship_audits_clean_end_to_end():
    res = audit_spec(RunSpec.load(FLAGSHIP), spec_name="flagship", steps=2,
                     device="cpu")
    assert res["rule_errors"] == []
    assert [str(f) for f in res["findings"]] == []
    assert sorted(res["ran"]) == sorted(ALL_RULES)
    assert res["skipped"] == [] and res["ranks"] == 8      # the rank programs


@pytest.mark.parametrize("name", ["flat_fp32", "hier_int2_inter",
                                  "flagship_hier_int2_overlap"])
def test_recorded_bytes_equal_the_prediction(name):
    spec = RunSpec.load(SPECS / f"{name}.json").with_overrides(["exec.mode=vmap"])
    sess = build_session(spec, device="cpu")
    step = sess.lower()
    pred = sess.predicted_hlo_wire_bytes()
    for stage in sess.schedule.stages:
        assert _a2a_bytes(step, stage.level) == pred[stage.level], stage.level
    assert sum(o.bytes for o in step.collectives("all-to-all")) == pred["total"]


def test_prediction_against_the_reference():
    """fp32 stages ship what the JAX package predicts; a quantized stage
    ships packed words where the JAX package counts one int32 a value."""
    from repro_torch.quant.stochastic import words_per_row

    jsess = jsession.build_session(JRunSpec.load(SPECS / "hier_int2_inter.json"))
    tsess = build_session(RunSpec.load(SPECS / "hier_int2_inter.json"), device="cpu")
    want, got = jsess.predicted_hlo_wire_bytes(), tsess.predicted_hlo_wire_bytes()
    assert got["intra"] == want["intra"]
    dims = tsess.trainer.cfg.dims()[:tsess.trainer.cfg.num_layers]
    params = want["inter"] - sum(2.0 * WIRE * f * 4 for f in dims
                                 for WIRE in [_inter_rows(tsess)])
    assert got["inter"] == params + sum(2.0 * _inter_rows(tsess) * words_per_row(f, 2) * 4
                                        for f in dims)


def _inter_rows(sess):
    stage = sess.schedule.stages[1]
    topo = sess.schedule.topo(stage)
    return sess.schedule.plan_for(stage, sess.wd).send_gather_idx.shape[-1] // topo.shard_size


def _state(tr):
    leaves = [v for p in tr.params["layers"] for v in p.values()]
    leaves += [tr.params["lp_embed"]]
    leaves += [t for layer in (tr._cache or []) for t in layer]
    return leaves


def test_lower_leaves_fit_bitwise_unchanged(deterministic):
    spec = RunSpec.load(FLAGSHIP).with_overrides(["exec.mode=vmap"])
    plain, lowered = build_session(spec, device="cpu"), build_session(spec, device="cpu")
    step = lowered.lower()
    assert step.epoch == 0 and lowered.trainer._cache is None
    la = [plain.train_epoch()["loss"] for _ in range(2)]
    lb = [lowered.train_epoch()["loss"]]
    stale = lowered.lower()                      # epoch 1: inter stage stale
    assert stale.epoch == 1 and stale.stale_levels == ("inter",)
    assert not [o for o in stale.ops if o.level == "inter" and o.klass != "compute"]
    lb.append(lowered.train_epoch()["loss"])
    assert la == lb and lowered.trainer.epoch == 2
    for a, b in zip(_state(plain.trainer), _state(lowered.trainer)):
        assert torch.equal(a, b)
    assert all(p.grad is None for p in _state(lowered.trainer))
    oa, ob = plain.trainer.opt_state, lowered.trainer.opt_state
    assert oa.step == ob.step
    for a, b in zip(tree_leaves([oa.mu, oa.nu]), tree_leaves([ob.mu, ob.nu])):
        assert torch.equal(a, b)
    assert plain.evaluate() == lowered.evaluate()
    assert X.RECORDER is None


def test_lowered_step_records_both_directions_per_layer():
    spec = RunSpec.load(SPECS / "hier_int2_inter.json")
    step = build_session(spec, device="cpu").lower()
    for direction in ("forward", "backward"):
        for layer in (0, 1):
            levels = {o.level for o in step.collectives("all-to-all")
                      if o.direction == direction and o.layer == layer}
            assert levels == {"intra", "inter"}, (direction, layer)
    assert "quant_pack" in step.as_text() and "backward" in step.as_text()
    order = step.collective_order()
    assert order["wire_before_compute"] and order["inter_wire_before_compute"]


@pytest.mark.parametrize("name,want", [("flat_fp32", 1), ("flat_cd2", 2)])
def test_retrace_count_is_the_epoch_phases(name, want):
    sess = build_session(RunSpec.load(SPECS / f"{name}.json"), device="cpu")
    sess.fit(epochs=3, log_every=0)                 # recorder off: nothing counted
    assert sess.step_cache_size() == 0
    with X.recording():
        sess.fit(epochs=3, log_every=0)
    assert sess.step_cache_size() == want


@pytest.mark.parametrize("topo", [
    X.StageTopo("a2a", "workers", 4, lead=(1, 4), wire_dim=1),
    X.StageTopo("a2a", "node", 4, lead=(2, 4), wire_dim=1),
    X.StageTopo("grouped", "group", 2, "node", 4, lead=(2, 4), wire_dim=0),
], ids=["flat", "intra", "inter"])
def test_wrapped_fp32_all_to_all_gradients_are_bitwise(topo):
    rng = np.random.default_rng(0)
    p = topo.lead[0] * topo.lead[1]
    v0 = torch.from_numpy(rng.normal(size=(p, 8 * topo.wire_chunks, 5)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=tuple(v0.shape)).astype(np.float32))
    a, b = v0.clone().requires_grad_(True), v0.clone().requires_grad_(True)
    ya = X._WireA2A.apply(a, topo)
    yb = b.reshape(*topo.lead, topo.wire_chunks, -1, 5).transpose(topo.wire_dim, 2).reshape(b.shape)
    assert torch.equal(ya, yb)
    ya.backward(g)
    yb.backward(g)
    assert torch.equal(a.grad, b.grad)
    with X.recording() as rec:
        X._WireA2A.apply(v0.clone().requires_grad_(True), topo).backward(g)
    assert [o.direction for o in rec.ops] == ["forward", "backward"]


def test_multiproc_session_has_no_lowered_step():
    sess = build_session(RunSpec.load(SPECS / "multiproc_p4.json"), device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="no\\s+single lowered step"):
            sess.lower()
        assert sess.step_cache_size() is None
    finally:
        sess.close()


@pytest.fixture(scope="module")
def matrix_cli():
    """``python -m repro_torch.run.matrix specs --device cpu``, run once for
    the module: (exit code, standard output, the records ``run_matrix``
    returned inside it)."""
    import contextlib
    import io

    orig, recs, out = tmatrix.run_matrix, [], io.StringIO()

    def run_matrix(*args, **kwargs):
        recs.extend(orig(*args, **kwargs))
        return recs

    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(tmatrix, "run_matrix", run_matrix)
        with pytest.raises(SystemExit) as e:
            tmatrix.main([str(SPECS), "--device", "cpu"])
    return e.value.code, out.getvalue(), recs


def test_matrix_on_cpu(matrix_cli):
    _, _, recs = matrix_cli
    assert [r["status"] for r in recs] == ["ok"] * 8, [r.get("error") for r in recs]
    by = {r["spec"]: r for r in recs}
    assert {n: r["ranks"] for n, r in by.items() if "ranks" in r} == \
        {"flagship_hier_int2_overlap.json": 8, "shard_map.json": 4}
    assert not any("lowered_as" in r for r in recs)
    assert by["multiproc_p4.json"]["store"]["store_bytes"] > 0
    assert by["serve_flagship.json"]["served"] == 4
    for r in recs:
        if "ranks" in r:        # a rank program's own op count per rank
            assert len(r["lowered_ops"]) == r["ranks"] and min(r["lowered_ops"]) > 0
        elif "lowered_ops" in r:
            assert r["lowered_ops"] > 0


def test_audit_and_matrix_clis_exit_zero_on_cpu(tmp_path, matrix_cli):
    out = tmp_path / "audit.json"
    with pytest.raises(SystemExit) as e:
        taudit.main(["--spec", str(SPECS), "--device", "cpu", "--out", str(out),
                     "--lint-path", str(ROOT / "src" / "repro_torch")])
    assert e.value.code == 0
    report = json.loads(out.read_text())
    assert len(report["specs"]) == 8 and report["summary"]["findings"] == 0
    assert report["device"] == "cpu"
    code, out, _ = matrix_cli
    assert code == 0
    assert "8 ok / 0 error" in out


def test_core_layer_imports_no_layer_above_it():
    """The recorder and the recorded step live in ``core.record``; the core
    modules import nothing of analysis, run, launch or serve, and
    ``analysis.ir`` re-exports the very classes the trainer builds."""
    import ast

    import repro_torch.analysis.ir as ir
    import repro_torch.core.record as record

    above = ("repro_torch.analysis", "repro_torch.run", "repro_torch.launch",
             "repro_torch.serve")
    for path in sorted((ROOT / "src" / "repro_torch" / "core").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad = [n for n in names if n.startswith(above)]
            assert not bad, f"{path.name} imports {bad}"
    assert (ir.LoweredStep, ir.StepOp, ir.StepRecorder) == (
        record.LoweredStep, record.StepOp, record.StepRecorder)
    with X.recording() as rec:
        assert isinstance(rec, ir.StepRecorder)
