"""The paper-invariant step rules (counterpart of ``repro.analysis.hlo_rules``;
the name is kept so each rule is found where the JAX package has it).

The JAX package reads its rules off the lowered StableHLO module. The
port has no module: it records one training step as it runs
(``analysis.ir``), and the same five invariants are read off that record:

  ``overlap-order``    overlap-scheduled specs post every layer's wire
                       (the inter stage's first) before that layer's local
                       aggregation (the two-phase LayerProgram);
  ``wire-dtype``       a quantized stage ships integer words: a float
                       all-to-all payload on its stage means something
                       dequantized before the wire;
  ``replica-groups``   every all-to-all splits a worker's buffer into the
                       stage's ``topo.wire_chunks`` chunks, every
                       psum_scatter / all_gather spans the group's
                       ``shard_size`` workers, and every op covers all P
                       workers;
  ``predicted-bytes``  the recorded all-to-all bytes per worker (forward +
                       backward) match ``Session.predicted_hlo_wire_bytes``
                       (model-vs-executed drift detector);
  ``retrace-guard``    N training epochs show no more distinct step
                       signatures (the ops' kinds, shapes and dtypes) than
                       the schedule has epoch phases: eager PyTorch compiles
                       nothing, so the signature count is what a compiled
                       step would have cached. The port skips a stale
                       stage's wire (the JAX package runs it and selects
                       with ``where``, one program), so a delayed schedule
                       has one signature per distinct set of refreshed
                       stages.

The step rules apply to stacked specs (``vmap``, and ``shard_map`` lowered
as its stacked variant): that is the port's only recorded step. They skip
multiproc, as the JAX package's do.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

from repro_torch.analysis.rules import (
    AuditContext,
    Finding,
    Rule,
    Severity,
    register_rule,
)


def _wire_group_size(schedule, stage) -> int:
    """The chunk count of a stage's all-to-all: nparts (flat), group_size
    (intra), num_groups (inter) — exactly ``topo.wire_chunks``."""
    return schedule.topo(stage).wire_chunks


def epoch_phases(schedule, epochs: Iterable[int]) -> int:
    """Distinct sets of refreshed delayed stages over ``epochs``: the step
    signatures a run of those epochs shows. Over a whole period (the lcm of
    the delayed stages' ``cd``) this is the schedule's number of epoch
    phases: 1 without delayed stages, 2 for one delayed stage."""
    delayed = [s for s in schedule.stages if s.delayed]
    return len({tuple(e % s.cd == 0 for s in delayed) for e in epochs})


def _loc(op) -> str:
    return f"step:{op.index}"


@register_rule
class OverlapOrderRule(Rule):
    """Wire ops precede the local aggregation when the schedule says
    overlap."""

    id = "overlap-order"
    description = ("overlap-scheduled specs post every layer's (inter) wire "
                   "before its local aggregation in the recorded step")

    def applies(self, ctx: AuditContext) -> bool:
        return ctx.stacked

    def check(self, ctx: AuditContext) -> List[Finding]:
        sched = ctx.schedule
        order = ctx.lowered.collective_order()
        want_overlap = any(s.overlap for s in sched.stages)
        findings: List[Finding] = []
        first_compute = (order["first_compute"] or {}).get("line", 0)
        if want_overlap:
            ok = order["wire_before_compute"] and (
                order["inter_wire_before_compute"]
                or not sched.is_hierarchical)
            if not ok:
                findings.append(self.finding(
                    "schedule requests overlap but the recorded step does "
                    "not post the wire before the local aggregation "
                    f"(first_wire={order['first_wire']}, "
                    f"first_inter_wire={order['first_inter_wire']}, "
                    f"first_compute={order['first_compute']})",
                    location=f"step:{first_compute}",
                    fix_hint="the trainer must sequence LayerProgram.issue "
                             "-> _local_aggregate -> finalize; check that "
                             "issue posts every overlap=True stage's wire "
                             "(inter first) before the local aggregation",
                    order={k: order[k] for k in
                           ("wire_before_compute",
                            "inter_wire_before_compute")}))
        elif order["wire_before_compute"]:
            findings.append(self.finding(
                "schedule is sequential (no stage overlaps) but the wire "
                "is posted before the local aggregation — the step does "
                "not match the declared schedule",
                severity=Severity.WARNING,
                location=f"step:{(order['first_wire'] or {}).get('line', 0)}",
                fix_hint="overlap=False stages must post their wire in "
                         "LayerProgram.finalize"))
        return findings


@register_rule
class WireDtypeRule(Rule):
    """No float all-to-all payload on a quantized stage."""

    id = "wire-dtype"
    description = ("specs with Int2/4/8 stages must ship integer wire "
                   "payloads; a float all-to-all payload on such a stage is "
                   "a dequant-before-wire regression")

    def applies(self, ctx: AuditContext) -> bool:
        return ctx.stacked and any(s.bits for s in ctx.schedule.stages)

    def check(self, ctx: AuditContext) -> List[Finding]:
        step = ctx.lowered
        findings: List[Finding] = []
        a2as = step.collectives("all-to-all")
        for stage in ctx.schedule.stages:
            if not stage.bits or stage.level in step.stale_levels:
                continue
            # The fp32 (zero, scale) params ride along as role "params".
            payloads = [o for o in a2as
                        if o.level == stage.level and o.role == "payload"]
            for op in payloads:
                if op.is_float:
                    findings.append(self.finding(
                        f"Int{stage.bits} {stage.level} stage ships a float "
                        f"payload: {op.dtype}{list(op.shape)} all-to-all "
                        f"({op.direction}, layer {op.layer})",
                        location=_loc(op),
                        fix_hint="the wire must carry quant_pack's int32 "
                                 "words; dequantize only after the "
                                 "all_to_all (exchange._quantized_wire)",
                        dtype=op.dtype, shape=list(op.shape)))
            if not any(not o.is_float for o in payloads):
                findings.append(self.finding(
                    f"Int{stage.bits} {stage.level} stage recorded no "
                    "integer all-to-all payload — the quantized wire "
                    "vanished",
                    fix_hint="check that StackedWire routes bits>0 through "
                             "quantized_exchange",
                    location=ctx.spec_name))
        return findings


@register_rule
class ReplicaGroupsRule(Rule):
    """Collectives must realize the spec's topology."""

    id = "replica-groups"
    description = ("every all-to-all splits into its stage's wire_chunks, "
                   "every psum_scatter/all_gather spans shard_size workers, "
                   "and every collective covers all workers")

    def applies(self, ctx: AuditContext) -> bool:
        return ctx.stacked

    def check(self, ctx: AuditContext) -> List[Finding]:
        sched = ctx.schedule
        nparts = ctx.spec.partition.nparts
        stages = {s.level: s for s in sched.stages}
        findings: List[Finding] = []
        for op in ctx.lowered.collectives():
            stage = stages.get(op.level)
            if stage is None:
                findings.append(self.finding(
                    f"{op.kind} on stage {op.level!r}, which the schedule "
                    f"does not have ({sorted(stages)})",
                    location=_loc(op), level=op.level))
                continue
            topo = sched.topo(stage)
            want = (topo.wire_chunks if op.kind == "all-to-all"
                    else topo.shard_size)
            if op.chunks != want:
                findings.append(self.finding(
                    f"{op.kind} on the {op.level} stage spans "
                    f"{op.chunks} workers; the spec's topology gives {want}",
                    location=_loc(op),
                    fix_hint="a collective over the wrong axis moves the "
                             "wrong bytes; check the schedule's StageTopo",
                    group_size=op.chunks, allowed=[want]))
            elif op.shape and op.shape[0] != nparts:
                findings.append(self.finding(
                    f"{op.kind} covers {op.shape[0]} workers; the spec runs "
                    f"{nparts}",
                    location=_loc(op), total=op.shape[0], nparts=nparts))
        return findings


@register_rule
class PredictedBytesRule(Rule):
    """Recorded all-to-all bytes per worker match the plan-derived
    prediction."""

    id = "predicted-bytes"
    description = ("all-to-all bytes per worker recorded in one step match "
                   "Session.predicted_hlo_wire_bytes within tolerance")
    tolerance = 0.10

    def applies(self, ctx: AuditContext) -> bool:
        return ctx.stacked

    def check(self, ctx: AuditContext) -> List[Finding]:
        step = ctx.lowered
        predicted = ctx.predicted_bytes
        expect = sum(predicted[s.level] for s in ctx.schedule.stages
                     if s.level not in step.stale_levels)
        recorded = float(sum(o.bytes for o in step.collectives("all-to-all")))
        if expect <= 0:
            return []
        rel = abs(recorded - expect) / expect
        if rel <= self.tolerance:
            return []
        return [self.finding(
            f"the recorded step moves {recorded:.0f} all-to-all bytes per "
            f"worker; the session's device plans predict {expect:.0f} "
            f"({rel:.1%} off, tolerance {self.tolerance:.0%})",
            location=ctx.spec_name,
            fix_hint="either the exchange changed (extra or missing wire, "
                     "dequant-before-wire multiplies payload bytes) or "
                     "predicted_hlo_wire_bytes went stale — reconcile "
                     "before trusting either number",
            recorded_bytes=recorded, predicted=predicted)]


@register_rule
class RetraceGuardRule(Rule):
    """N training epochs show one step signature per epoch phase."""

    id = "retrace-guard"
    description = ("Session.fit's epochs show exactly as many distinct step "
                   "signatures as the schedule has epoch phases among them "
                   "— a leaked host value in a shape changes it every epoch")

    def applies(self, ctx: AuditContext) -> bool:
        # multiproc executes across processes: no single step to record.
        return ctx.spec.exec.mode != "multiproc"

    def check(self, ctx: AuditContext) -> List[Finding]:
        from repro_torch.core.exchange import recording

        n = max(2, min(ctx.steps, ctx.spec.exec.epochs or 2))
        session = ctx.session
        e0 = session.trainer.epoch
        with recording():
            session.fit(epochs=n, log_every=0)
        size = session.step_cache_size()
        if size is None:
            return [self.finding(
                "the session counts no step signatures",
                severity=Severity.INFO, location="runtime")]
        want = epoch_phases(ctx.schedule, range(e0, e0 + n))
        if size == want:
            return []
        return [self.finding(
            f"{n} training epochs showed {size} step signatures (expected "
            f"{want}, one per epoch phase among them)",
            location="runtime",
            fix_hint="something in the step changes shape or dtype per "
                     "epoch — keep host values out of tensor shapes and the "
                     "schedule's stale skips the only variation",
            epochs=n, signatures=size, expected=want)]


def stage_wire_summary(ctx: AuditContext) -> Dict[str, int]:
    """Per-stage expected all-to-all chunk counts (a debugging helper)."""
    sched = ctx.schedule
    return {s.level: _wire_group_size(sched, s) for s in sched.stages}
