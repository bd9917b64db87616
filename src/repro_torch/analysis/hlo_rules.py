"""The paper-invariant step rules (counterpart of ``repro.analysis.hlo_rules``;
the name is kept so each rule is found where the JAX package has it).

The JAX package reads its rules off the lowered StableHLO module. The
port has no module: it records one training step as it runs
(``analysis.ir``), and the same five invariants are read off that record.
A ``vmap`` spec's record is the stacked step of all workers; a
``shard_map`` spec's is every rank's own program (``RankPrograms``), and
each rule then holds on every rank:

  ``overlap-order``    overlap-scheduled specs post every layer's wire
                       (the inter stage's psum_scatter and its all-to-all
                       between groups too) before that layer's local
                       aggregation (the two-phase LayerProgram);
  ``wire-dtype``       a quantized stage ships integer words: a float
                       all-to-all payload on its stage means something
                       dequantized before the wire;
  ``replica-groups``   every all-to-all splits a worker's buffer into the
                       stage's ``topo.wire_chunks`` chunks and every
                       psum_scatter / all_gather spans the group's
                       ``shard_size`` workers; a stacked op covers all P
                       workers; a rank's collective runs over a process
                       group whose size is one of the spec's axis sizes
                       (G, W or P; P when flat) and holds the rank, and
                       the distinct groups of one op across the ranks are
                       disjoint and cover all P workers (the JAX rule);
  ``predicted-bytes``  the recorded all-to-all bytes per worker (forward +
                       backward; on every rank) match
                       ``Session.predicted_hlo_wire_bytes`` (model-vs-
                       executed drift detector);
  ``retrace-guard``    N training epochs show no more distinct step
                       signatures (the ops' kinds, shapes and dtypes) than
                       the schedule has epoch phases: eager PyTorch compiles
                       nothing, so the signature count is what a compiled
                       step would have cached. The port skips a stale
                       stage's wire (the JAX package runs it and selects
                       with ``where``, one program), so a delayed schedule
                       has one signature per distinct set of refreshed
                       stages. A stacked spec counts the epochs ``fit``
                       trains; a ``shard_map`` spec each rank's programs
                       lowered at those epochs.

They skip multiproc, as the JAX package's do.
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


def _where(prog, op) -> str:
    """An op's location: ``step:N``, prefixed with the rank in a rank
    program."""
    return _loc(op) if prog.rank is None else f"rank {prog.rank} {_loc(op)}"


@register_rule
class OverlapOrderRule(Rule):
    """Wire ops precede the local aggregation when the schedule says
    overlap."""

    id = "overlap-order"
    description = ("overlap-scheduled specs post every layer's (inter) wire "
                   "before its local aggregation in the recorded step")

    def applies(self, ctx: AuditContext) -> bool:
        return ctx.recorded

    def check(self, ctx: AuditContext) -> List[Finding]:
        sched = ctx.schedule
        want_overlap = any(s.overlap for s in sched.stages)
        findings: List[Finding] = []
        for prog in ctx.lowered.programs:
            order = prog.collective_order()
            who = "" if prog.rank is None else f"rank {prog.rank} "
            first_compute = (order["first_compute"] or {}).get("line", 0)
            if want_overlap:
                ok = order["wire_before_compute"] and (
                    (order["inter_wire_before_compute"]
                     and order["inter_a2a_before_compute"])
                    or not sched.is_hierarchical)
                if not ok:
                    findings.append(self.finding(
                        "schedule requests overlap but the recorded step does "
                        "not post the wire before the local aggregation "
                        f"(first_wire={order['first_wire']}, "
                        f"first_inter_wire={order['first_inter_wire']}, "
                        f"inter_a2a_before_compute={order['inter_a2a_before_compute']}, "
                        f"first_compute={order['first_compute']})",
                        location=f"{who}step:{first_compute}",
                        fix_hint="the trainer must sequence LayerProgram.issue "
                                 "-> _local_aggregate -> finalize; check that "
                                 "issue posts every overlap=True stage's wire "
                                 "(inter first, its all-to-all between groups "
                                 "included) before the local aggregation",
                        rank=prog.rank,
                        order={k: order[k] for k in
                               ("wire_before_compute", "inter_wire_before_compute",
                                "inter_a2a_before_compute")}))
            elif order["wire_before_compute"]:
                findings.append(self.finding(
                    "schedule is sequential (no stage overlaps) but the wire "
                    "is posted before the local aggregation — the step does "
                    "not match the declared schedule",
                    severity=Severity.WARNING,
                    location=f"{who}step:{(order['first_wire'] or {}).get('line', 0)}",
                    fix_hint="overlap=False stages must post their wire in "
                             "LayerProgram.finalize", rank=prog.rank))
        return findings


@register_rule
class WireDtypeRule(Rule):
    """No float all-to-all payload on a quantized stage."""

    id = "wire-dtype"
    description = ("specs with Int2/4/8 stages must ship integer wire "
                   "payloads; a float all-to-all payload on such a stage is "
                   "a dequant-before-wire regression")

    def applies(self, ctx: AuditContext) -> bool:
        return ctx.recorded and any(s.bits for s in ctx.schedule.stages)

    def check(self, ctx: AuditContext) -> List[Finding]:
        findings: List[Finding] = []
        for prog in ctx.lowered.programs:
            a2as = prog.collectives("all-to-all")
            who = "" if prog.rank is None else f" on rank {prog.rank}"
            for stage in ctx.schedule.stages:
                if not stage.bits or stage.level in prog.stale_levels:
                    continue
                # The fp32 (zero, scale) params ride along as role "params".
                payloads = [o for o in a2as
                            if o.level == stage.level and o.role == "payload"]
                for op in payloads:
                    if op.is_float:
                        findings.append(self.finding(
                            f"Int{stage.bits} {stage.level} stage ships a float "
                            f"payload{who}: {op.dtype}{list(op.shape)} all-to-all "
                            f"({op.direction}, layer {op.layer})",
                            location=_where(prog, op),
                            fix_hint="the wire must carry quant_pack's int32 "
                                     "words; dequantize only after the "
                                     "all_to_all (exchange._quantized_wire, "
                                     "CollectiveWire._wire_post)",
                            dtype=op.dtype, shape=list(op.shape), rank=prog.rank))
                if not any(not o.is_float for o in payloads):
                    findings.append(self.finding(
                        f"Int{stage.bits} {stage.level} stage recorded no "
                        f"integer all-to-all payload{who} — the quantized wire "
                        "vanished",
                        fix_hint="check that the stage's transport routes "
                                 "bits>0 through the quantizer",
                        location=ctx.spec_name, rank=prog.rank))
        return findings


@register_rule
class ReplicaGroupsRule(Rule):
    """Collectives must realize the spec's topology."""

    id = "replica-groups"
    description = ("every all-to-all splits into its stage's wire_chunks, "
                   "every psum_scatter/all_gather spans shard_size workers, "
                   "and every collective covers all workers (a rank's: over "
                   "process groups of the spec's axis sizes that partition "
                   "the workers)")

    def applies(self, ctx: AuditContext) -> bool:
        return ctx.recorded

    def check(self, ctx: AuditContext) -> List[Finding]:
        sched = ctx.schedule
        p = ctx.spec.partition
        nparts = p.nparts
        if p.hierarchical:
            allowed = {p.groups, p.resolved_group_size(), nparts}
            topo_name = f"{p.groups}x{p.resolved_group_size()}"
        else:
            allowed = {nparts}
            topo_name = f"flat {nparts}"
        stages = {s.level: s for s in sched.stages}
        progs = ctx.lowered.programs
        findings: List[Finding] = []
        for prog in progs:
            for op in prog.collectives():
                where = _where(prog, op)
                if op.kind == "psum":
                    want = nparts
                else:
                    stage = stages.get(op.level)
                    if stage is None:
                        findings.append(self.finding(
                            f"{op.kind} on stage {op.level!r}, which the schedule "
                            f"does not have ({sorted(stages)})",
                            location=where, level=op.level))
                        continue
                    topo = sched.topo(stage)
                    want = (topo.wire_chunks if op.kind == "all-to-all"
                            else topo.shard_size)
                if op.chunks != want:
                    findings.append(self.finding(
                        f"{op.kind} on the {op.level or 'whole'} stage spans "
                        f"{op.chunks} workers; the spec's topology gives {want}",
                        location=where,
                        fix_hint="a collective over the wrong axis moves the "
                                 "wrong bytes; check the schedule's StageTopo",
                        group_size=op.chunks, allowed=[want]))
                elif prog.rank is None:
                    if op.shape and op.shape[0] != nparts:
                        findings.append(self.finding(
                            f"{op.kind} covers {op.shape[0]} workers; the spec "
                            f"runs {nparts}",
                            location=where, total=op.shape[0], nparts=nparts))
                elif len(op.group) not in allowed or prog.rank not in op.group:
                    findings.append(self.finding(
                        f"{op.kind} over a process group of size {len(op.group)} "
                        f"({list(op.group)}) does not match the spec topology "
                        f"({topo_name}: allowed sizes {sorted(allowed)}, holding "
                        f"rank {prog.rank})",
                        location=where,
                        fix_hint="a collective spanning the wrong axis moves "
                                 "the wrong bytes; check launch.mesh.mesh_groups",
                        group_size=len(op.group), allowed=sorted(allowed)))
        if progs and progs[0].rank is not None:
            findings += self._partition(progs, nparts)
        return findings

    def _partition(self, progs, nparts: int) -> List[Finding]:
        """The distinct groups of each op across the ranks are disjoint and
        cover all ``nparts`` workers. One op is the n-th collective of one
        kind, role, layer, level and direction on each rank."""
        same: Dict[tuple, List] = {}
        for prog in progs:
            seen: Dict[tuple, int] = {}
            for op in prog.collectives():
                key = (op.direction, op.layer, op.level, op.kind, op.role)
                seen[key] = seen.get(key, 0) + 1
                same.setdefault(key + (seen[key],), []).append(op)
        findings: List[Finding] = []
        for i, ops in enumerate(same.values()):
            groups = sorted({tuple(sorted(o.group)) for o in ops})
            covered = sorted({r for g in groups for r in g})
            total = sum(len(g) for g in groups)
            if total != nparts or covered != list(range(nparts)):
                op = ops[0]
                findings.append(self.finding(
                    f"{op.kind} ({op.direction}, layer {op.layer}, {op.level or 'whole'}) "
                    f"over groups {[list(g) for g in groups]}: they cover {total} "
                    f"workers{' and overlap' if total != len(covered) else ''}; the "
                    f"spec runs {nparts}, each in one group",
                    location=f"collective {i}",
                    fix_hint="every rank must create the same process groups "
                             "(launch.mesh.mesh_groups) and join its own",
                    total=total, nparts=nparts,
                    missing=sorted(set(range(nparts)) - set(covered))))
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
        return ctx.recorded

    def check(self, ctx: AuditContext) -> List[Finding]:
        step = ctx.lowered
        predicted = ctx.predicted_bytes
        expect = sum(predicted[s.level] for s in ctx.schedule.stages
                     if s.level not in step.stale_levels)
        if expect <= 0:
            return []
        findings: List[Finding] = []
        for prog in step.programs:
            recorded = float(sum(o.bytes for o in prog.collectives("all-to-all")))
            rel = abs(recorded - expect) / expect
            if rel <= self.tolerance:
                continue
            who = "" if prog.rank is None else f" on rank {prog.rank}"
            findings.append(self.finding(
                f"the recorded step moves {recorded:.0f} all-to-all bytes per "
                f"worker{who}; the session's device plans predict {expect:.0f} "
                f"({rel:.1%} off, tolerance {self.tolerance:.0%})",
                location=ctx.spec_name,
                fix_hint="either the exchange changed (extra or missing wire, "
                         "dequant-before-wire multiplies payload bytes) or "
                         "predicted_hlo_wire_bytes went stale — reconcile "
                         "before trusting either number",
                recorded_bytes=recorded, predicted=predicted, rank=prog.rank))
        return findings


@register_rule
class RetraceGuardRule(Rule):
    """N training epochs show one step signature per epoch phase."""

    id = "retrace-guard"
    description = ("Session.fit's epochs (a shard_map rank's lowered "
                   "epochs) show exactly as many distinct step signatures "
                   "as the schedule has epoch phases among them — a leaked "
                   "host value in a shape changes it every epoch")

    def applies(self, ctx: AuditContext) -> bool:
        # multiproc executes across processes: no single step to record.
        return ctx.recorded

    def check(self, ctx: AuditContext) -> List[Finding]:
        from repro_torch.core.exchange import recording

        n = max(2, min(ctx.steps, ctx.spec.exec.epochs or 2))
        session = ctx.session
        e0 = session.trainer.epoch
        ranks = None
        if ctx.spec.exec.mode == "shard_map":
            lowered = [ctx.lowered_at(e) for e in range(e0, e0 + n)]
            ranks = [len({tuple(o.signature() for o in prog.ranks[r].ops)
                          for prog in lowered})
                     for r in range(len(lowered[0].ranks))]
            size = max(ranks) if ranks else None
        else:
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
        data = {"epochs": n, "signatures": size, "expected": want}
        if ranks is not None:
            data["per_rank"] = ranks
        return [self.finding(
            f"{n} training epochs showed {size} step signatures (expected "
            f"{want}, one per epoch phase among them)",
            location="runtime",
            fix_hint="something in the step changes shape or dtype per "
                     "epoch — keep host values out of tensor shapes and the "
                     "schedule's stale skips the only variation",
            **data)]


def stage_wire_summary(ctx: AuditContext) -> Dict[str, int]:
    """Per-stage expected all-to-all chunk counts (a debugging helper)."""
    sched = ctx.schedule
    return {s.level: _wire_group_size(sched, s) for s in sched.stages}
