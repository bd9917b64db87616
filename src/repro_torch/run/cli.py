"""The shared ``--spec file.json`` + ``--set key=value`` CLI layer.

Every RunSpec-driven driver composes its configuration the same way, in
priority order (later wins):

  1. built-in defaults (``RunSpec()`` or a driver-supplied base),
  2. ``--spec file.json`` (a serialized RunSpec),
  3. legacy explicit flags (``--nparts 8`` ...), each a deprecation alias
     for a ``--set`` path via :data:`LEGACY_ALIASES`,
  4. ``--set section.field=value`` overrides.

so old invocations keep working while the spec file is the durable,
shareable artifact. :func:`spec_from_args` implements the merge.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.run.spec import RunSpec

# Legacy GCN launcher flags -> RunSpec override path(s). One flag may fan
# out to several paths (--seed seeds every stage, the historical behavior).
LEGACY_ALIASES: Dict[str, Union[str, Tuple[str, ...]]] = {
    "nodes": "graph.nodes",
    "classes": "graph.classes",
    "degree": "graph.avg_degree",
    "feat_dim": "graph.feat_dim",
    "scale": "graph.scale",
    "nparts": "partition.nparts",
    "strategy": "partition.strategy",
    "groups": "partition.groups",
    "bits": "schedule.bits",
    "cd": "schedule.cd",
    "intra_bits": "schedule.intra_bits",
    "inter_bits": "schedule.inter_bits",
    "intra_cd": "schedule.intra_cd",
    "inter_cd": "schedule.inter_cd",
    "overlap": "schedule.overlap",
    "agg_backend": "schedule.agg_backend",
    "model": "model.model",
    "hidden": "model.hidden_dim",
    "lp": "model.label_prop",
    "mode": "exec.mode",
    "nprocs": "exec.nprocs",
    "epochs": "exec.epochs",
    "lr": "exec.lr",
    "ckpt_every": "exec.ckpt_every",
    "max_restarts": "exec.max_restarts",
    "heartbeat_s": "exec.heartbeat_s",
    "seed": ("graph.seed", "partition.seed", "exec.seed"),
}


def add_spec_args(ap: argparse.ArgumentParser) -> None:
    """Attach the shared spec plumbing to a driver's parser."""
    ap.add_argument("--spec", type=str, default=None, metavar="FILE.json",
                    help="load the full RunSpec from a JSON file "
                         "(explicit flags and --set override it)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="SECTION.FIELD=VALUE",
                    help="override one spec field, e.g. "
                         "--set schedule.inter_bits=2 (repeatable; "
                         "values parse as JSON, bare strings allowed)")
    ap.add_argument("--save-spec", type=str, default=None, metavar="FILE.json",
                    help="serialize the resolved RunSpec here before "
                         "running (the shareable artifact)")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved RunSpec JSON and exit")


def legacy_overrides(args: argparse.Namespace,
                     aliases: Optional[Dict] = None) -> List[str]:
    """Translate explicitly-passed legacy flags (non-None dests) into
    ``--set`` assignments. Drivers declare legacy flags with
    ``default=None`` so only user-supplied values override the spec."""
    out: List[str] = []
    for dest, paths in (aliases or LEGACY_ALIASES).items():
        v = getattr(args, dest, None)
        if v is None:
            continue
        if isinstance(paths, str):
            paths = (paths,)
        for p in paths:
            out.append(f"{p}={json.dumps(v)}")
    return out


def spec_from_args(args: argparse.Namespace,
                   base: Optional[RunSpec] = None,
                   aliases: Optional[Dict] = None) -> RunSpec:
    """Resolve the driver's final RunSpec (defaults < --spec < legacy
    flags < --set), honoring --save-spec / --print-spec side effects.

    Invalid combinations exit with the one-line SpecError message (CLI
    ergonomics), not a traceback — library callers use ``with_overrides``
    directly and get the raisable :class:`SpecError`."""
    from repro_torch.run.spec import SpecError
    try:
        spec = (RunSpec.load(args.spec) if getattr(args, "spec", None)
                else (base or RunSpec()))
        spec = spec.with_overrides(legacy_overrides(args, aliases))
        spec = spec.with_overrides(getattr(args, "overrides", []) or [])
    except SpecError as e:
        raise SystemExit(f"invalid run configuration: {e}") from None
    if getattr(args, "save_spec", None):
        spec.save(args.save_spec)
        print(f"wrote spec {spec.content_hash()} to {args.save_spec}")
    if getattr(args, "print_spec", False):
        print(spec.to_json())
        raise SystemExit(0)
    return spec
