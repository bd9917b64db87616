"""Dry-run of the distributed GCN trainer over its recorded step
(counterpart of the ``--gcn`` half of ``repro.launch.dryrun``).

The JAX package lowers and compiles the production shard_map trainer
against the full 256- (or 512-) device mesh and reads the compiled HLO.
One card holds no mesh (ROADMAP A2), so here the workers run stacked on
the device (``exec.mode=vmap``; a ``shard_map`` spec is recorded as
``lowered_as: "vmap"``, as ``run.matrix`` does) and the "lowered module"
is one recorded forward and backward, ``Session.lower()``
(``core.record.LoweredStep``). The record keeps the JAX package's fields:
the spec and its content hash, the schedule, the predicted wire bytes per
stage, the collective order (the overlap evidence), the recorded
collectives by the ring table (``launch.hlo_stats``), the partition's
``CommStats``, and ``cost`` (matmul FLOPs and bytes of the same forward
and backward, ``hlo_stats.analyze_step``). It adds
``predicted_hlo_wire_bytes``, the all-to-all bytes the recorded step must
carry (``Session.predicted_hlo_wire_bytes``). ``memory`` is the peak
``torch.cuda.max_memory_allocated`` of the session's build and recorded
step above what was allocated before it, on the card; ``None`` on the
CPU. ``compile_s`` is absent (nothing is compiled ahead of the run).
``--assert-overlap`` fails the record (exit 1) unless a stage overlaps and
the port's ``overlap-order`` audit rule finds no error.

Records land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(or ``--out``), never in the JAX package's ``experiments/dryrun/``.

The LM half (``--arch``/``--shape``/``--all``) is not ported yet (ROADMAP
A8(d3)): it raises ``NotImplementedError``.

Usage:
  python -m repro_torch.launch.dryrun --gcn [--groups G --bits B --cd N \\
      --agg-backend ell|coo --overlap|--no-overlap --scale S --chips P \\
      --assert-overlap --out DIR --device cpu] [--spec F.json --set K=V]
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Optional

import torch

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES
from repro_torch.launch.hlo_stats import analyze_step, collective_order, parse_collectives
from repro_torch.run import RunSpec, add_spec_args, build_session, spec_from_args

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
LM_NOT_PORTED = ("the LM half of the dry-run (--arch/--shape/--all) is not "
                 "ported yet (ROADMAP A8(d3)); use --gcn")


def gcn_base_spec(nparts: int, scale: int = 13) -> RunSpec:
    """The dry-run's base RunSpec: a structural R-MAT stand-in graph lowered
    through the production shard_map trainer with the paper's Table-2
    GraphSAGE shape and an Int2 wire (the JAX package's, unchanged)."""
    return RunSpec().with_overrides([
        "graph.source=rmat", f"graph.scale={scale}", "graph.edge_factor=8",
        "graph.seed=7", "graph.feat_dim=128", "graph.classes=40",
        f"partition.nparts={nparts}", "partition.seed=0",
        "schedule.bits=2", "model.hidden_dim=256", "model.num_layers=3",
        "exec.mode=shard_map", "exec.seed=0",
    ])


def _finish(rec: dict, t0: float, save: bool,
            out_dir: Optional[Path] = None) -> dict:
    out_dir = Path(out_dir) if out_dir else OUT_DIR
    rec["total_s"] = round(time.time() - t0, 2)
    if save:
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        path.write_text(json.dumps(rec, indent=1, default=str))
    tag = rec["status"].upper()
    print(f"[{tag}] {rec['arch']} x {rec['shape']} on {rec['mesh']} "
          f"({rec['total_s']}s)" + (f" :: {rec.get('error','')}" if tag == "ERROR" else ""),
          flush=True)
    return rec


def _check_overlap(rec: dict, spec, session, lowered, shape_name: str,
                   device) -> None:
    """The ``--assert-overlap`` gate: some stage must overlap, and the
    audit's ``overlap-order`` rule (same invariant, same framework as the
    audit CLI) must find no error in this run's recorded step. The rule's
    findings go in ``rec["audit_findings"]`` before an error raises."""
    from repro_torch.analysis.hlo_rules import OverlapOrderRule
    from repro_torch.analysis.rules import AuditContext, Severity

    if not any(s.overlap for s in session.schedule.stages):
        raise AssertionError(
            "overlap check failed: no stage of the resolved "
            f"schedule overlaps ({session.schedule.describe()}) — "
            "pass --overlap (or a hierarchical topology, whose "
            "schedule overlaps by default)")
    ctx = AuditContext(spec, spec_name=shape_name, device=device)
    ctx._session = session
    ctx._lowered = lowered
    findings = OverlapOrderRule().check(ctx)
    rec["audit_findings"] = [f.as_dict() for f in findings]
    errors = [f for f in findings if f.severity == Severity.ERROR]
    if errors:
        raise AssertionError("overlap check failed: " + "; ".join(
            f.message for f in errors))


def run_gcn_dryrun(spec: RunSpec, mesh_name: str = None, save: bool = True,
                   assert_overlap: bool = False,
                   out_dir: Optional[Path] = None, device="cuda") -> dict:
    """Dry-run the paper's distributed GCN trainer: ``build_session`` on
    ``device`` (the card unless the caller asks for the CPU), one recorded
    forward and backward (``Session.lower()``), and the analyses of it.

    ``partition.groups=0`` is 1-D graph-parallel over all workers (flat
    schedule); ``groups=G`` the two-level (group, node) exchange on a
    G x (nparts/G) layout. The schedule section threads straight through.
    ``assert_overlap`` flips the record to error status unless the
    recorded step posts the wire before the local aggregation."""
    from repro_torch.analysis.rules import STACKED_OVERRIDES

    groups = spec.partition.groups
    nparts = spec.partition.nparts
    gs = spec.graph
    size = gs.scale if gs.source == "rmat" else gs.nodes
    shape_name = (f"{gs.source}{size}-fullbatch"
                  + (f"-g{groups}" if groups else ""))
    rec = {"arch": "supergcn-graphsage", "shape": shape_name,
           "mesh": mesh_name or f"{nparts}chips", "chips": nparts,
           "status": "ok", "spec": spec.to_dict(),
           "spec_hash": spec.content_hash()}
    t0 = time.time()
    try:
        dev = torch.device(device)
        build_spec = spec
        if spec.exec.mode == "shard_map":
            build_spec = spec.with_overrides(list(STACKED_OVERRIDES))
            rec["lowered_as"] = "vmap"
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        session = build_session(build_spec, device=dev)
        try:
            rec["device"] = torch.cuda.get_device_name(dev) if on_card else str(dev)
            rec["agg_backend"] = spec.schedule.agg_backend
            rec["schedule"] = session.schedule.describe()
            rec["predicted_wire_bytes"] = session.predicted_wire_bytes()
            # Epoch 0 of a new session refreshes every stage: its recorded
            # all-to-alls carry every stage's wire, "total" of these.
            rec["predicted_hlo_wire_bytes"] = session.predicted_hlo_wire_bytes()
            t1 = time.time()
            lowered = session.lower()
            if on_card:
                torch.cuda.synchronize(dev)
            rec["lower_s"] = round(time.time() - t1, 3)
            # The session's state and its step, above what was allocated
            # before the session was built (by the caller's earlier work).
            rec["memory"] = (torch.cuda.max_memory_allocated(dev) - held
                             if on_card else None)
            order = collective_order(lowered)
            rec["collective_order"] = dict(order, events=order["events"][:64],
                                           num_events=len(order["events"]))
            rec["collectives"] = parse_collectives(lowered)
            rec["comm_stats"] = session.pg.stats.as_dict()
            cost = analyze_step(session.lower, lowered.epoch)
            rec["cost"] = {"flops": cost["dot_flops"],
                           "bytes accessed": cost["traffic_bytes"]}
            print(f"  collective order: wire_before_compute="
                  f"{order['wire_before_compute']} inter_wire_before_compute="
                  f"{order['inter_wire_before_compute']}", flush=True)
            if assert_overlap:
                _check_overlap(rec, spec, session, lowered, shape_name, dev)
        finally:
            session.close()
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    return _finish(rec, t0, save, out_dir)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES,
                    help="the LM half: not ported yet (ROADMAP A8(d3))")
    ap.add_argument("--shape", choices=list(INPUT_SHAPES),
                    help="the LM half: not ported yet (ROADMAP A8(d3))")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="the LM half: not ported yet (ROADMAP A8(d3))")
    ap.add_argument("--gcn", action="store_true",
                    help="dry-run the SuperGCN distributed trainer")
    add_spec_args(ap)
    # Legacy --gcn flags: aliases onto the RunSpec (default=None = "not
    # passed"; the base spec supplies the dry-run defaults, incl. bits=2).
    ap.add_argument("--groups", type=int, default=None,
                    help="with --gcn: num_groups for the hierarchical "
                         "(group, node) trainer (0 = flat 1-D); alias for "
                         "--set partition.groups=G")
    ap.add_argument("--bits", type=int, default=None, choices=(0, 2, 4, 8),
                    help="with --gcn: wire format for the exchange "
                         "schedule (base spec: 2); alias for "
                         "--set schedule.bits=B")
    ap.add_argument("--cd", type=int, default=None,
                    help="with --gcn: delayed-comm refresh period; alias "
                         "for --set schedule.cd=N")
    ap.add_argument("--agg-backend", default=None, choices=("coo", "ell"),
                    help="with --gcn: aggregation realization (bucketed "
                         "ELL kernel vs COO scatter-add); alias for "
                         "--set schedule.agg_backend=B")
    ap.add_argument("--overlap", dest="overlap", action="store_true",
                    default=None,
                    help="with --gcn: force two-phase wire/compute overlap "
                         "(default: on for hierarchical, off for flat)")
    ap.add_argument("--no-overlap", dest="overlap", action="store_false",
                    help="with --gcn: force the sequential parity schedule")
    ap.add_argument("--scale", type=int, default=None,
                    help="with --gcn: R-MAT scale of the stand-in graph "
                         "(base spec: 13); alias for --set graph.scale=N")
    ap.add_argument("--chips", type=int, default=0,
                    help="with --gcn: worker count (0 = the full production "
                         "mesh's 256, 512 with --multi-pod)")
    ap.add_argument("--assert-overlap", action="store_true",
                    help="with --gcn: exit non-zero unless the recorded "
                         "step posts the wire before the aggregation")
    ap.add_argument("--out", default="",
                    help=f"record directory (default: {OUT_DIR})")
    ap.add_argument("--device", default="cuda",
                    help="torch device the workers run on (default: cuda)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out) if args.out else None

    if args.gcn:
        nparts = args.chips or (512 if args.multi_pod else 256)
        spec = spec_from_args(
            args, base=gcn_base_spec(nparts, scale=args.scale or 13))
        # Label the production mesh only when the resolved spec still
        # targets it (a --spec/--set override of nparts wins over --chips).
        mesh_name = (("2x16x16" if args.multi_pod else "16x16")
                     if not args.chips and spec.partition.nparts == nparts
                     else None)
        rec = run_gcn_dryrun(spec, mesh_name=mesh_name,
                             assert_overlap=args.assert_overlap,
                             out_dir=out_dir, device=args.device)
        raise SystemExit(0 if rec["status"] == "ok" else 1)
    if args.all or args.arch or args.shape:
        raise NotImplementedError(LM_NOT_PORTED)
    ap.error(f"need --gcn: {LM_NOT_PORTED}")


if __name__ == "__main__":
    main()
