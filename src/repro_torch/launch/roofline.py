"""Roofline analysis of the LM dry-run records (counterpart of
``repro.launch.roofline``), against one NVIDIA H100.

Per (arch × shape) on a production mesh, the three terms, all per device
and step, in seconds (a record's FLOPs and bytes are per device already):

  compute    = dot FLOPs / PEAK_FLOPS        (989 TFLOP/s bf16 dense, H100 SXM)
  memory     = HBM bytes / HBM_BW            (3.35 TB/s, H100 SXM)
  collective = collective wire bytes / LINK_BW  (450 GB/s a direction, NVLink 4)

FLOPs are the record's ``hlo_analysis.dot_flops`` (``launch.dryrun``:
``FlopCounterMode`` over the port's step, extrapolated over layers by
``cost_extrapolate`` or traced at full depth). The port computes attention
scores in fp32 (the reference prescribes it); they are counted against the
bf16 peak all the same, as the JAX package and ``PERF.md`` count them, so
the compute term is a lower bound for those products. HBM bytes are the
compiled footprint's proxy: arguments read + outputs written + 2 × temp
(``memory``). MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill) /
2·N_active·B (decode) per device; MODEL/HLO flags recompute and redundancy.

One card runs no mesh, so a record's collective wire bytes are ``None``
(``launch.dryrun``): the collective term is then ``None``, ``dominant`` is
chosen between compute and memory, and the table prints "—" for it.

  python -m repro_torch.launch.roofline [--records DIR] [--mesh 16x16] [--json]

Reads ``experiments/dryrun_torch/`` (or ``--records``) and writes
``roofline_<mesh>.json`` into the same directory.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_arch, get_shape

PEAK_FLOPS = 989e12   # bf16 dense tensor-core FLOP/s, H100 SXM data sheet
HBM_BW = 3.35e12      # HBM3 bytes/s, H100 SXM data sheet
LINK_BW = 450e9       # NVLink 4 bytes/s a direction (900 GB/s both), H100 SXM data sheet

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def n_active_params(arch) -> tuple:
    """(total, active) params; active discounts non-routed experts."""
    n_total = arch.param_count()
    if arch.moe is None:
        return n_total, n_total
    per_expert = 3 * arch.d_model * arch.moe.d_ff_expert
    routed = arch.num_layers * arch.moe.num_experts * per_expert
    active = arch.num_layers * arch.moe.top_k * per_expert
    return n_total, n_total - routed + active


def model_flops_per_device(arch, shape, chips: int) -> float:
    n_total, n_active = n_active_params(arch)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / chips
    return 2.0 * n_active * shape.global_batch / chips  # decode: 1 token/seq


def analyze_record(rec: dict) -> dict:
    arch = get_arch(rec["arch"])
    shape = get_shape(rec["shape"])
    chips = rec["chips"]
    ana = rec.get("hlo_analysis", {})
    flops = ana.get("dot_flops", rec.get("cost", {}).get("flops", 0.0))
    # HBM bytes: the per-device footprint (arguments read + outputs written
    # + 2x temp), as the JAX package takes it: a traffic walk counts every
    # op's operands, sliced stacks and recomputation included, so the
    # footprint is the defensible per-step lower bound.
    mem = rec.get("memory", {})
    bytes_ = (mem.get("argument_size_in_bytes", 0)
              + mem.get("output_size_in_bytes", 0)
              + 2 * mem.get("temp_size_in_bytes", 0))
    wire: Optional[float] = rec.get("collectives", {}).get("total", {}).get("wire_bytes")

    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_ / HBM_BW
    t_coll = None if wire is None else wire / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory}
    if t_coll is not None:
        terms["collective"] = t_coll
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(arch, shape, chips)
    ratio = mf / flops if flops else 0.0

    advice = {
        "compute": "compute-bound: raise tensor-core utilization (bf16 "
                   "throughout, fused attention) or shrink redundant FLOPs "
                   "(recompute policy)",
        "memory": "HBM-bound: fuse elementwise chains, cut activation "
                  "round-trips (saved-tensor policy), use bf16 saves",
        "collective": "collective-bound: re-place shardings to remove "
                      "all-gathers, or quantize the transfer (paper §6, "
                      "sharding.quantized_collectives)",
    }[dominant]
    peak_t = max(terms.values())
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "status": rec["status"], "kind": rec.get("kind", shape.kind),
        "hlo_flops": flops, "hlo_bytes": bytes_, "coll_wire_bytes": wire,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": mf, "model_over_hlo": ratio,
        "roofline_fraction": (t_compute / peak_t) if peak_t else 0.0,
        "temp_bytes": mem.get("temp_size_in_bytes"),
        "advice": advice,
    }


def load_records(mesh: str = "16x16", records: Optional[Path] = None):
    rec_dir = Path(records) if records else OUT_DIR
    recs = []
    for a in ARCH_NAMES:
        for s in INPUT_SHAPES:
            p = rec_dir / f"{a}__{s}__{mesh}.json"
            if p.exists():
                recs.append(json.loads(p.read_text()))
    return recs


def _secs(v) -> str:
    return "—" if v is None else f"{v:.3e}"


def fmt_table(rows) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant | "
           "6ND/HLO | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|\n")
    body = []
    for r in rows:
        if r["status"] == "skip":
            body.append(f"| {r['arch']} | {r['shape']} | — | — | — | SKIP | — | — |")
            continue
        if r["status"] != "ok":
            body.append(f"| {r['arch']} | {r['shape']} | — | — | — | ERROR | — | — |")
            continue
        body.append(
            f"| {r['arch']} | {r['shape']} | {_secs(r['t_compute_s'])} | "
            f"{_secs(r['t_memory_s'])} | {_secs(r['t_collective_s'])} | "
            f"**{r['dominant']}** | {r['model_over_hlo']:.2f} | "
            f"{r['roofline_fraction']:.2f} |")
    return hdr + "\n".join(body) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--records", default="",
                    help=f"dry-run record directory (default: {OUT_DIR})")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rec_dir = Path(args.records) if args.records else OUT_DIR
    recs = load_records(args.mesh, rec_dir)
    rows = []
    for rec in recs:
        if rec["status"] == "ok":
            rows.append(analyze_record(rec))
        else:
            rows.append({"arch": rec["arch"], "shape": rec["shape"],
                         "mesh": rec["mesh"], "status": rec["status"]})
    if args.json:
        print(json.dumps(rows, indent=1))
    else:
        print(f"H100 SXM: {PEAK_FLOPS:.3e} FLOP/s bf16, {HBM_BW:.3e} B/s HBM, "
              f"{LINK_BW:.3e} B/s NVLink a direction")
        print(fmt_table(rows))
        ok = [r for r in rows if r["status"] == "ok"]
        if ok:
            worst = min(ok, key=lambda r: r["roofline_fraction"])
            print(f"\nworst roofline fraction: {worst['arch']} x {worst['shape']}"
                  f" ({worst['roofline_fraction']:.3f})")
            coll = [r for r in ok if r["t_collective_s"] is not None]
            if coll:
                collbound = max(coll, key=lambda r: r["t_collective_s"])
                print(f"most collective-bound: {collbound['arch']} x "
                      f"{collbound['shape']} ({collbound['t_collective_s']:.3e}s)")
            else:
                print("collective term: not recorded (one card runs no mesh)")
    rec_dir.mkdir(parents=True, exist_ok=True)
    out = rec_dir / f"roofline_{args.mesh}.json"
    out.write_text(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
