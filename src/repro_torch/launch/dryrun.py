"""Dry-run of every (arch × input shape) on the production meshes, and of
the distributed GCN trainer over its recorded step (counterpart of
``repro.launch.dryrun``).

**The LM half** (``--arch/--shape``, ``--all``). The JAX package lowers and
compiles each step function against ``ShapeDtypeStruct`` inputs on the
16x16 (or 2x16x16) TPU mesh and reads XLA's memory and cost analyses. On
one card "lower and compile" becomes a trace of the port's real step
functions under ``torch._subclasses.fake_tensor.FakeTensorMode``: tensors
carry shapes, dtypes and a device, and nothing is allocated or computed.

  * train_4k     -> ``models.train_step`` at ``input_specs``' micro-batch
    count (all three outputs kept)
  * prefill_32k  -> ``forward_train`` logits
  * decode_32k / long_500k -> ``serve_step`` (one token; ``long_500k``
    with ``effective_window``)

The inputs are ``launch.input_specs``' meta tensors on the production
mesh, made anew as fake tensors on ``device`` for each record (one
``FakeTensorMode`` a record: tensors of two modes do not mix). The trace
runs ``launch.hlo_stats.trace_step``: ``FlopCounterMode`` for the matmul
FLOPs, the traffic counter for the bytes of every op, and ``LiveBytes``
for the peak of live storages. A record keeps the JAX package's keys:

  * ``hlo_analysis`` = ``{dot_flops, traffic_bytes}`` and ``cost`` =
    ``{flops, "bytes accessed"}``, per device: the global count / chips, an
    even split (``flops_basis``; the port cannot see GSPMD's redundant
    compute). By default they come from :func:`cost_extrapolate` (L1- and
    L2-layer variants, train at one micro-batch scaled by the count);
    ``--exact`` traces the full depth instead.
  * ``memory`` (``memory_basis``): ``argument_size_in_bytes``, the exact
    sum of every input leaf's shard bytes (parameters, AdamW state, batch
    or cache and tokens); ``output_size_in_bytes``, each output that
    updates an input at that input's shard shape, logits and the loss at
    their tokens' batch spec; ``temp_size_in_bytes``, the trace's peak of
    live bytes above its arguments / chips, extrapolated over layers as
    the FLOPs are.
  * ``collectives``: one card runs no mesh, so nothing is recorded and the
    record does not guess what GSPMD would insert (``unrecorded``).
  * ``trace_s`` replaces ``compile_s``; there is no ``hlo_bytes``.
    ``--hlo-out`` writes ``<arch>__<shape>__<mesh>.ops.json`` (FLOPs by
    operator and bytes by operator of the trace the numbers came from),
    the port's nearest artifact to an HLO dump.

**The GCN half** (``--gcn``). The JAX package lowers the production
shard_map trainer against the full 256- (or 512-) device mesh. The
port's shard_map is one process per worker (``launch.spmd``); its
"lowered module" is every rank's own program, ``Session.lower()``
(``core.record.RankPrograms``): each rank built in turn in this process
and one forward, backward and gradient sum recorded on a world of the
``fake`` backend, with no fleet started. A ``vmap`` spec records its
stacked step instead. The record keeps the JAX package's fields: the
spec and its content hash, the schedule, the predicted wire bytes per
stage, the collective order (the overlap evidence; on every rank), the
recorded collectives by the ring table (``launch.hlo_stats``; per
worker, every collective a rank issues, so nothing is ``unrecorded``),
the partition's ``CommStats``, and ``cost`` (matmul FLOPs and bytes of
the same forward and backward, ``hlo_stats.analyze_step``: per worker,
the mean over the ranks' steps; ``cost_basis`` says which). It adds
``predicted_hlo_wire_bytes``, the all-to-all bytes each worker's record
must carry (``Session.predicted_hlo_wire_bytes``), ``ranks`` and
``all_to_all_bytes_per_rank`` (one entry for a stacked step). ``memory``
is the peak ``torch.cuda.max_memory_allocated`` of the session's build and
recorded steps above what was allocated before it, on the card; ``None``
on the CPU. ``--assert-overlap`` fails the record (exit 1) unless a stage
overlaps and the port's ``overlap-order`` audit rule finds no error.

Records land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``
(or ``--out``), never in the JAX package's ``experiments/dryrun/``.

Usage:
  python -m repro_torch.launch.dryrun --arch whisper-small --shape decode_32k \\
      [--exact --hlo-out --multi-pod --out DIR --device cpu]
  python -m repro_torch.launch.dryrun --all [--multi-pod --out DIR --device cpu]
  python -m repro_torch.launch.dryrun --gcn [--groups G --bits B --cd N \\
      --agg-backend ell|coo --overlap|--no-overlap --scale S --chips P \\
      --assert-overlap --out DIR --device cpu] [--spec F.json --set K=V]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_arch
from repro_torch.launch import input_specs as IS
from repro_torch.launch.hlo_stats import (analyze_step, collective_order, parse_collectives,
                                          trace_step)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common as MC
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import AdamWState
from repro_torch.run import RunSpec, add_spec_args, build_session, spec_from_args
from repro_torch.sharding import specs as SP
from repro_torch.utils.trees import tree_leaves, tree_map

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

FLOPS_BASIS = ("FlopCounterMode over the port's step traced under FakeTensorMode at "
               "global shapes, divided evenly by chips: GSPMD's redundant compute is "
               "not seen")
MEMORY_BASIS = ("argument: sum over input leaves of prod(shard shape) * itemsize; "
                "output: an output that updates an input at that input's shard shape, "
                "logits and the loss at their tokens' batch spec; temp: the trace's "
                "peak of live storage bytes above its arguments (LiveBytes) / chips, "
                "extrapolated over layers as the FLOPs are")
COLLECTIVES_UNRECORDED = ("one card runs no mesh: the collectives GSPMD would insert "
                          "on the production mesh are not recorded")


# ------------------------------------------------------------------ LM half


def _mem_dict(spec: Dict[str, Any], vocab_size: int, temp_bytes: float, mesh,
              chips: int) -> dict:
    """``memory`` of a record (``MEMORY_BASIS``): argument and output bytes
    per device from the input specs' shard shapes, temp from the trace."""
    def shard_bytes(tree) -> int:
        return sum(math.prod(s.shard_shape) * s.tensor.element_size()
                   for s in tree_leaves(tree))

    kind = spec["shape"].kind
    if kind == "train":
        args = [spec["params"], spec["opt_state"], spec["batch"]]
        # new params and AdamW state as their inputs; the loss, a scalar.
        out = shard_bytes(spec["params"]) + shard_bytes(spec["opt_state"]) + 4
    else:
        tokens = spec["batch"]["tokens"] if kind == "prefill" else spec["tokens"]
        args = ([spec["params"], spec["batch"]] if kind == "prefill"
                else [spec["params"], spec["cache"], spec["tokens"]])
        # logits [B, S, V] in the compute dtype, laid out as their tokens.
        logits = tokens.shape + (vocab_size,)
        lspec = tokens.spec + (None,)
        out = (math.prod(SP.shard_shape(logits, lspec, mesh))
               * torch.empty((), dtype=MC.COMPUTE_DTYPE).element_size())
        if kind != "prefill":
            out += shard_bytes(spec["cache"])
    return {"argument_size_in_bytes": int(sum(shard_bytes(a) for a in args)),
            "output_size_in_bytes": int(out),
            "temp_size_in_bytes": int(round(temp_bytes / chips))}


def _cost_dict(traced: dict) -> dict:
    """Global ``{flops, "bytes accessed", "peak_live_bytes"}`` of a trace."""
    return {"flops": traced["dot_flops"], "bytes accessed": traced["traffic_bytes"],
            "peak_live_bytes": float(traced["peak_live_bytes"])}


def _layer_quantum(arch) -> int:
    """Smallest layer-count step that keeps the arch structure valid."""
    if arch.family == "hybrid":
        return arch.attn_every
    if arch.family == "ssm":
        return arch.xlstm_group
    return 1


def reduced_arch(arch, num_layers: int):
    kw = {"num_layers": num_layers}
    if arch.family == "audio":
        kw["enc_layers"] = num_layers
    return dataclasses.replace(arch, **kw)


def cost_extrapolate(arch_name: str, shape_name: str, mesh, device="cuda") -> dict:
    """Global FLOPs, bytes and peak live bytes of the full model from L1- and
    L2-layer traces, extrapolated linearly to the full depth (the layer
    stacks are homogeneous). Train shapes are traced at one micro-batch of
    ``global_batch // nm`` and their FLOPs and bytes scaled by ``nm`` (the
    optimizer's share is O(parameters)); the peak live bytes are not
    scaled. A full-depth trace (``run_one(..., exact=True)``) is the check
    on this."""
    arch = get_arch(arch_name)
    q = _layer_quantum(arch)
    l1, l2 = q, 2 * q
    if arch.num_layers <= l2:
        l1, l2 = None, arch.num_layers  # tiny model: measure directly
    shape = INPUT_SHAPES[shape_name]
    spec_probe = IS.input_specs(arch, shape_name, mesh)
    nm = spec_probe.get("num_microbatches") or 1

    def measure(layers):
        a = reduced_arch(arch, layers)
        return _cost_dict(_lower(a, _one_microbatch(a, shape, mesh, nm), device))

    c2 = measure(l2)
    out = {"L2": l2, "cost_L2": c2, "num_microbatches": nm}
    keys = list(c2)
    if l1 is not None:
        c1 = measure(l1)
        out["L1"] = l1
        out["cost_L1"] = c1
        out["per_layer"] = {k: (c2[k] - c1[k]) / (l2 - l1) for k in keys}
        est = {k: c2[k] + (arch.num_layers - l2) * out["per_layer"][k] for k in keys}
    else:
        est = {k: c2[k] for k in keys}
    if shape.kind == "train" and nm > 1:
        est = {k: v * nm if k != "peak_live_bytes" else v for k, v in est.items()}
    out["estimated_full"] = est
    return out


def _one_microbatch(arch, shape, mesh, nm: int):
    """``_specs_for`` at one micro-batch: a train shape at ``global_batch //
    nm`` rows."""
    if shape.kind == "train" and nm > 1:
        shape = dataclasses.replace(shape, global_batch=shape.global_batch // nm)
    return _specs_for(arch, shape, mesh, num_microbatches=1)


def _specs_for(arch, shape, mesh, num_microbatches=None):
    """``input_specs`` for an already-materialized (possibly reduced) arch
    and shape object."""
    reason = IS.skip_reason(arch, shape)
    if reason:
        return {"skip": reason}
    window = IS.effective_window(arch, shape)
    params, pspecs = IS.param_input_specs(arch, mesh, fsdp=(shape.kind == "train"))
    out = {"params": params, "param_specs": pspecs, "window": window, "shape": shape}
    if shape.kind == "train":
        out["opt_state"] = IS.opt_input_specs(params, mesh)
        out["batch"] = IS.batch_input_specs(arch, shape, mesh)
        out["num_microbatches"] = (num_microbatches if num_microbatches
                                   else IS.num_microbatches(arch, shape, mesh))
    elif shape.kind == "prefill":
        out["batch"] = IS.batch_input_specs(arch, shape, mesh)
    else:
        cache, tokens = IS.decode_input_specs(arch, shape, mesh)
        out["cache"] = cache
        out["tokens"] = tokens
    return out


def _lower(arch, spec, device="cuda") -> dict:
    """The port's "lower and compile": the step function of ``spec``'s shape
    traced once under a fresh ``FakeTensorMode``, its inputs made as fake
    tensors on ``device`` from the specs' shapes (``hlo_stats.trace_step``'s
    dict)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    dev = torch.device(device)
    window = spec["window"]
    kind = spec["shape"].kind

    def fake(s):
        return torch.empty(s.shape, dtype=s.dtype, device=dev)

    with FakeTensorMode():
        params = tree_map(fake, spec["params"])
        if kind == "train":
            # The port's AdamW counts steps in a Python int.
            opt = AdamWState(step=0, mu=tree_map(fake, spec["opt_state"].mu),
                             nu=tree_map(fake, spec["opt_state"].nu))
            batch = tree_map(fake, spec["batch"])
            held = tree_leaves((params, opt.mu, opt.nu, batch))

            def fn():
                return T.train_step(params, opt, batch, arch, lr=3e-4,
                                    num_microbatches=spec["num_microbatches"],
                                    window=window)
        elif kind == "prefill":
            batch = tree_map(fake, spec["batch"])
            extra = {k: v for k, v in batch.items() if k != "tokens"}
            held = tree_leaves((params, batch))

            def fn():
                with torch.no_grad():
                    return T.forward_train(params, arch, batch["tokens"], extra or None,
                                           window)
        else:
            cache = tree_map(fake, spec["cache"])
            tokens = fake(spec["tokens"])
            held = tree_leaves((params, cache, tokens))

            def fn():
                with torch.no_grad():
                    return T.serve_step(params, cache, tokens, arch, window)
        return trace_step(fn, held=held)


def build_lowered(arch_name: str, shape_name: str, mesh, device="cuda"):
    """(trace, meta) of the full-depth step, or (None, skip reason)."""
    arch = get_arch(arch_name)
    spec = IS.input_specs(arch, shape_name, mesh)
    if "skip" in spec:
        return None, spec["skip"]
    traced = _lower(arch, spec, device)
    meta = {"num_microbatches": spec.get("num_microbatches"),
            "window": spec["window"], "kind": spec["shape"].kind}
    return traced, meta


def _ops_record(traced: dict, depth) -> dict:
    return {"layers": depth, "flop_counts": traced["flop_counts"],
            "bytes_by_op": traced["bytes_by_op"]}


def run_one(arch_name: str, shape_name: str, multi_pod: bool,
            save: bool = True, hlo_out: bool = False,
            out_dir: Optional[Path] = None, device="cuda",
            exact: bool = False) -> dict:
    """One (arch × shape) record on the production mesh (module docstring):
    FLOPs, bytes and peak live bytes from :func:`cost_extrapolate`, or with
    ``exact`` from a full-depth trace."""
    out_dir = Path(out_dir) if out_dir else OUT_DIR
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = 512 if multi_pod else 256
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
           "chips": chips, "status": "ok"}
    t0 = time.time()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        arch = get_arch(arch_name)
        spec = IS.input_specs(arch, shape_name, mesh)
        if "skip" in spec:
            rec["status"] = "skip"
            rec["skip_reason"] = spec["skip"]
            return _finish(rec, t0, save, out_dir)
        rec.update({"num_microbatches": spec.get("num_microbatches"),
                    "window": spec["window"], "kind": spec["shape"].kind,
                    "device": str(torch.device(device))})
        t1 = time.time()
        if exact:
            traced, _ = build_lowered(arch_name, shape_name, mesh, device)
            glob = _cost_dict(traced)
            ops = _ops_record(traced, arch.num_layers)
        else:
            ext = cost_extrapolate(arch_name, shape_name, mesh, device=device)
            glob = ext["estimated_full"]
            rec["extrapolation"] = ext
            ops = None
        if hlo_out and ops is None:
            # The L2 variant's trace, whose counts the extrapolation read.
            a2 = reduced_arch(arch, ext["L2"])
            sp2 = _one_microbatch(a2, spec["shape"], mesh, ext["num_microbatches"])
            ops = _ops_record(_lower(a2, sp2, device), ext["L2"])
        rec["trace_s"] = round(time.time() - t1, 2)
        rec["flops_basis"] = FLOPS_BASIS + (" (full-depth trace)" if exact else
                                            " (cost_extrapolate)")
        rec["hlo_analysis"] = {"dot_flops": glob["flops"] / chips,
                               "traffic_bytes": glob["bytes accessed"] / chips}
        rec["cost"] = {"flops": glob["flops"] / chips,
                       "bytes accessed": glob["bytes accessed"] / chips}
        rec["memory"] = _mem_dict(spec, arch.vocab_size, glob["peak_live_bytes"], mesh,
                                  chips)
        rec["memory_basis"] = MEMORY_BASIS
        rec["collectives"] = {"total": {"count": 0, "operand_bytes": None,
                                        "result_bytes": None, "wire_bytes": None},
                              "unrecorded": COLLECTIVES_UNRECORDED}
        if hlo_out:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"{arch_name}__{shape_name}__{mesh_name}.ops.json").write_text(
                json.dumps(ops, indent=1))
        m = rec["memory"]
        print(f"  flops={rec['cost']['flops']:.3e} bytes={rec['cost']['bytes accessed']:.3e} "
              f"per device; argument={m['argument_size_in_bytes']:.3e} "
              f"output={m['output_size_in_bytes']:.3e} temp={m['temp_size_in_bytes']:.3e} B",
              flush=True)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
    return _finish(rec, t0, save, out_dir)


# ----------------------------------------------------------------- GCN half


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
        on_card = dev.type == "cuda"
        if on_card:
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        session = build_session(spec, device=dev)
        try:
            rec["device"] = torch.cuda.get_device_name(dev) if on_card else str(dev)
            rec["agg_backend"] = spec.schedule.agg_backend
            rec["schedule"] = session.schedule.describe()
            rec["predicted_wire_bytes"] = session.predicted_wire_bytes()
            # Epoch 0 of a new session refreshes every stage: its recorded
            # all-to-alls carry every stage's wire, "total" of these.
            rec["predicted_hlo_wire_bytes"] = session.predicted_hlo_wire_bytes()
            t1 = time.time()
            if spec.exec.mode == "shard_map":
                # One lowering: each rank's step is recorded and counted.
                costs = []

                def counted(step):
                    box = []
                    costs.append(analyze_step(lambda: box.append(step())))
                    return box[0]

                lowered = session.trainer.lower_step(wrap=counted)
                cost = {k: sum(c[k] for c in costs) / len(costs) for k in costs[0]}
                rec["ranks"] = len(costs)
                rec["cost_basis"] = "per worker: the mean of the rank programs' steps"
            else:
                lowered = session.lower()
                cost = analyze_step(session.lower, lowered.epoch)
                rec["cost_basis"] = "all workers: the stacked step"
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
            rec["all_to_all_bytes_per_rank"] = [
                sum(o.bytes for o in p.collectives("all-to-all")) for p in lowered.programs]
            rec["comm_stats"] = session.pg.stats.as_dict()
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
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every arch x shape on one production mesh")
    ap.add_argument("--exact", action="store_true",
                    help="trace the full depth for FLOPs and bytes instead of "
                         "cost_extrapolate's L1/L2 layers")
    ap.add_argument("--hlo-out", action="store_true",
                    help="also write <arch>__<shape>__<mesh>.ops.json (FLOPs and "
                         "bytes by operator)")
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
                    help="torch device the GCN workers run on, or the LM trace's "
                         "fake tensors lie on (default: cuda)")
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
    if args.all:
        results = []
        for a in ARCH_NAMES:
            for s in INPUT_SHAPES:
                results.append(run_one(a, s, args.multi_pod, hlo_out=args.hlo_out,
                                       out_dir=out_dir, device=args.device,
                                       exact=args.exact))
        ok = sum(r["status"] == "ok" for r in results)
        skip = sum(r["status"] == "skip" for r in results)
        err = sum(r["status"] == "error" for r in results)
        print(f"\n== dry-run summary: {ok} ok / {skip} skip / {err} error ==")
        raise SystemExit(1 if err else 0)
    if not (args.arch and args.shape):
        ap.error("need --arch and --shape (or --all / --gcn)")
    rec = run_one(args.arch, args.shape, args.multi_pod, hlo_out=args.hlo_out,
                  out_dir=out_dir, device=args.device, exact=args.exact)
    raise SystemExit(0 if rec["status"] in ("ok", "skip") else 1)


if __name__ == "__main__":
    main()
