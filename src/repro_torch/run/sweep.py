"""Sweep engine: override-sets over a base :class:`RunSpec`.

``benchmarks/comm_volume.py --sweep`` hardcoded one G x W loop; this
module is the general form the ROADMAP auto-scheduler item asks for. A
sweep is a base spec plus a list of *override-sets* (each a list of
``section.field=value`` assignments — the same ``--set`` grammar every
CLI shares). Axes expand to their cartesian product
(:func:`product_overrides`), a :class:`~repro_torch.run.session.BuildCache`
shares the expensive graph/partition stages across candidates that agree
on them, and every row is keyed by the candidate's ``content_hash()`` so
recorded numbers name their exact configuration.

Each row carries the partition's health (``partition_stats`` incl.
``agg_slot_imbalance`` and the stacked executed slots), the schedule's
per-stage predicted wire bytes, and the ``perf_model.hier_epoch_time``
modelled epoch seconds on a named :class:`HardwareSpec` (``--hw
measured`` targets the machine actually running the sweep). Candidates
whose overrides don't validate are recorded under ``invalid`` — a sweep
over a support matrix documents its holes instead of crashing on them.

  PYTHONPATH=src python -m repro_torch.run.sweep --spec base.json \\
      --axis "partition.refine=none,bucket-max" \\
      --axis "schedule.inter_bits=0,2" [--hw measured] [--out sweep.json]

``repro_torch.run.tune`` ranks these rows, audits the leaders, and probes them
measured — the closed loop.
"""

from __future__ import annotations

import itertools
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.perf_model import (
    FUGAKU_A64FX,
    HardwareSpec,
    hier_epoch_time,
)
from repro_torch.run.session import BuildCache
from repro_torch.run.spec import RunSpec, SpecError


def parse_axis(text: str) -> Tuple[str, List[Any]]:
    """``"schedule.inter_bits=0,2,null"`` -> ("schedule.inter_bits",
    [0, 2, None]). Values parse as JSON scalars, falling back to bare
    strings (``bucket-max``)."""
    if "=" not in text:
        raise SpecError(f"axis {text!r}: expected PATH=V1,V2,...")
    path, raw = text.split("=", 1)
    values: List[Any] = []
    for tok in raw.split(","):
        tok = tok.strip()
        try:
            values.append(json.loads(tok))
        except json.JSONDecodeError:
            values.append(tok)
    if not values:
        raise SpecError(f"axis {text!r}: no values")
    return path.strip(), values


def product_overrides(axes: Iterable[str]) -> List[List[str]]:
    """Cartesian product of ``PATH=V1,V2,...`` axes as override-sets."""
    parsed = [parse_axis(a) for a in axes]
    sets: List[List[str]] = []
    for combo in itertools.product(*(vals for _, vals in parsed)):
        sets.append([f"{path}={json.dumps(v)}"
                     for (path, _), v in zip(parsed, combo)])
    return sets


def overlap_resolved(spec: RunSpec) -> bool:
    """The schedule's overlap tri-state resolved to the topology default
    (hierarchical schedules overlap, flat stays sequential)."""
    if spec.schedule.overlap is not None:
        return spec.schedule.overlap
    return spec.partition.hierarchical


_PSTAT_KEYS = ("cut_fraction", "load_imbalance", "agg_padding_ratio",
               "agg_slot_imbalance", "agg_stacked_slots",
               "agg_stacked_overhead")


def sweep_one(spec: RunSpec, cache: BuildCache,
              hw: HardwareSpec = FUGAKU_A64FX,
              overrides: Sequence[str] = (),
              include_spec: bool = True) -> Dict[str, Any]:
    """One candidate's modelled row (no training, no processes)."""
    g, _ = cache.graph(spec)
    pg = cache.partition(spec, g)
    pstats = cache.partition_stats(spec, g)
    sched = spec.schedule.to_dist_config(spec.partition).schedule()
    stage_bytes = sched.wire_volume_bytes(pg.stats, spec.graph.feat_dim)
    intra = stage_bytes.get("intra", 0.0)
    inter = stage_bytes.get("inter", stage_bytes.get("flat", 0.0))
    model = hier_epoch_time(
        intra, inter,
        local_nnz=[c.nnz for c in pg.local_csr],
        owned_rows=[len(o) for o in pg.owned],
        feat_dim=spec.graph.feat_dim, hidden_dim=spec.model.hidden_dim,
        num_layers=spec.model.num_layers, hw=hw)
    overlap = overlap_resolved(spec)
    row: Dict[str, Any] = {
        "spec_hash": spec.content_hash(),
        "overrides": list(overrides),
        "describe": spec.describe(),
        "hw": hw.name,
        "partition_stats": {k: pstats[k] for k in _PSTAT_KEYS},
        "stage_rows": {st.level: pg.stats.stage_rows(st.level)
                       for st in sched.stages},
        "predicted_wire_bytes": stage_bytes,
        "overlap": overlap,
        "modelled": {k: model[k] for k in
                     ("aggr", "nn", "intra", "inter",
                      "sequential", "overlap", "inter_hidden_fraction")},
        "modelled_epoch_s": model["overlap" if overlap else "sequential"],
    }
    if include_spec:
        row["spec"] = spec.to_dict()
    return row


def sweep_rows(base: RunSpec,
               override_sets: Sequence[Sequence[str]],
               cache: Optional[BuildCache] = None,
               hw: HardwareSpec = FUGAKU_A64FX,
               include_spec: bool = True,
               verbose: bool = False,
               ) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Expand + model every candidate. Returns ``(rows, invalid)``;
    ``invalid`` records override-sets the spec schema rejects (with the
    one-line SpecError), so a grid may cover combinations that only exist
    in part of the matrix."""
    cache = cache or BuildCache()
    rows: List[Dict[str, Any]] = []
    invalid: List[Dict[str, Any]] = []
    seen: Dict[str, int] = {}
    for ovs in override_sets:
        try:
            spec = base.with_overrides(list(ovs))
        except SpecError as e:
            invalid.append({"overrides": list(ovs), "error": str(e)})
            continue
        h = spec.content_hash()
        if h in seen:  # distinct overrides collapsing to one config
            rows[seen[h]]["aliases"] = (rows[seen[h]].get("aliases", [])
                                        + [list(ovs)])
            continue
        row = sweep_one(spec, cache, hw, overrides=ovs,
                        include_spec=include_spec)
        seen[h] = len(rows)
        rows.append(row)
        if verbose:
            print(f"# {row['spec_hash']} modelled={row['modelled_epoch_s']:.6g}s "
                  f"slot_imb={row['partition_stats']['agg_slot_imbalance']:.3f} "
                  f"{' '.join(ovs)}", flush=True)
    return rows, invalid


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import sys

    from repro_torch.core.perf_model import HARDWARE, get_hardware
    from repro_torch.run.cli import add_spec_args, spec_from_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_spec_args(ap)
    ap.add_argument("--axis", action="append", default=[],
                    metavar="PATH=V1,V2,...",
                    help="sweep axis (repeatable; axes expand to their "
                         "cartesian product of --set override-sets)")
    ap.add_argument("--hw", default=FUGAKU_A64FX.name,
                    choices=sorted(HARDWARE) + ["measured"],
                    help="hardware model for the epoch-time rows "
                         "('measured' probes this machine)")
    ap.add_argument("--out", default="",
                    help="write the sweep artifact JSON here "
                         "(default: stdout)")
    ap.add_argument("--no-spec", action="store_true",
                    help="omit the full spec dict from each row "
                         "(hash-only rows)")
    args = ap.parse_args(argv)
    base = spec_from_args(args)
    if not args.axis:
        ap.error("need at least one --axis PATH=V1,V2,...")
    hw = get_hardware(args.hw)
    rows, invalid = sweep_rows(base, product_overrides(args.axis),
                               hw=hw, include_spec=not args.no_spec,
                               verbose=True)
    artifact = {
        "benchmark": "run_sweep",
        "base_spec_hash": base.content_hash(),
        "base_spec": base.to_dict(),
        "hw": {"name": hw.name, "bw_comm": hw.bw_comm,
               "latency": hw.latency, "th_cal": hw.th_cal},
        "axes": list(args.axis),
        "rows": rows,
        "invalid": invalid,
    }
    payload = json.dumps(artifact, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
        print(f"# wrote {len(rows)} rows ({len(invalid)} invalid) "
              f"to {args.out}", file=sys.stderr)
    else:
        print(payload)


if __name__ == "__main__":
    main()
