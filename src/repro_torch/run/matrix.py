"""Spec-matrix runner: keep every supported configuration buildable
(counterpart of ``repro.run.matrix``).

Iterates a directory of canonical RunSpec JSONs (``specs/`` holds the
support matrix: flat/fp32, hierarchical Int2-inter, delayed comm, the COO
fallback, shard_map execution, multiproc, a serving spec) and drives each
through the port on ``--device`` (the card by default; ``--device cpu``
runs the plain PyTorch path):

* a stacked spec: ``build_session(spec).lower()`` — partition, plans,
  trainer, and one recorded forward and backward on the device;
* a ``shard_map`` spec: ``build_session(spec).lower()``, every rank's
  own program recorded in this process (no fleet; ``ranks`` in the
  record, and ``lowered_ops`` a count per rank);
* a multiproc spec: the shared store and mailbox accounting
  (``dry_plan``), no processes;
* a serving spec: ``build_server`` and a burst of 4 requests, the served
  logits held to the full-batch forward at full fanout.

Any failure fails the matrix, naming the spec and its hash.

``--compile`` (``compile_step``) is accepted for the reference's command
lines and does nothing: the reference then compiles each lowered module,
while here every stacked spec already runs its recorded step on the
device (the kernels build at their first launch).

  PYTHONPATH=src python -m repro_torch.run.matrix [specs/] [--device cpu] \\
      [--compile] [--list] [--audit]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

from repro_torch.run.session import build_session
from repro_torch.run.spec import RunSpec


def _is_serve_path(path: Path) -> bool:
    from repro_torch.serve.spec import is_serve_spec_dict
    try:
        return is_serve_spec_dict(json.loads(path.read_text()))
    except (OSError, ValueError):
        return False


def _smoke_serve(path: Path, rec: dict, device) -> None:
    """Drive a ServeSpec through build_server + a tiny request burst —
    the serving analogue of build_session().lower()."""
    import numpy as np

    from repro_torch.serve import ServeSpec, build_server

    spec = ServeSpec.load(path)
    rec["hash"] = spec.content_hash()
    rec["describe"] = spec.describe()
    server = build_server(spec, device=device)
    n = server.graph.num_nodes
    targets = [[int(v)] for v in
               np.random.default_rng(0).integers(0, n, size=4)]
    server.serve_batch(targets)
    rec["served"] = server.requests_served
    rec["shape_classes"] = server.shape_classes()
    if server.fanouts is None and not server.check_parity(targets[0]):
        raise AssertionError("full-fanout served logits diverged from "
                             "the full-batch forward")


def run_matrix(spec_dir: Path, compile_step: bool = False, device="cuda",
               verbose: bool = True) -> list:
    """One record per spec in ``spec_dir`` (status ``ok`` or ``error``).
    ``compile_step`` is accepted for the reference's signature and changes
    nothing (module docstring)."""
    paths = sorted(spec_dir.glob("*.json"))
    if not paths:
        raise SystemExit(f"no *.json specs found in {spec_dir}")
    results = []
    for path in paths:
        t0 = time.time()
        rec = {"spec": path.name, "status": "ok"}
        try:
            if _is_serve_path(path):
                _smoke_serve(path, rec, device)
            else:
                spec = RunSpec.load(path)
                rec["hash"] = spec.content_hash()
                rec["describe"] = spec.describe()
                session = build_session(spec, device=device)
                try:
                    if spec.exec.mode == "multiproc":
                        # No single step to record: the dry-run equivalent
                        # is the shared-store + mailbox accounting.
                        rec["store"] = session.trainer.dry_plan()
                    else:
                        lowered = session.lower()
                        if spec.exec.mode == "shard_map":
                            # Ops per rank: each rank's own program.
                            rec["ranks"] = len(lowered.programs)
                            rec["lowered_ops"] = [len(p.ops) for p in lowered.programs]
                        else:
                            rec["lowered_ops"] = len(lowered.ops)
                finally:
                    session.close()
        except Exception as e:
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-2000:]
        rec["elapsed_s"] = round(time.time() - t0, 2)
        results.append(rec)
        if verbose:
            tag = rec["status"].upper()
            line = (f"[{tag}] {rec['spec']:32s} {rec.get('hash', '-'):16s} "
                    f"({rec['elapsed_s']}s)")
            if "ranks" in rec:
                line += f" ranks={rec['ranks']}"
            if rec["status"] == "error":
                line += f" :: {rec['error']}"
            print(line, flush=True)
            if rec["status"] == "error":
                print(rec["traceback"], file=sys.stderr)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("spec_dir", nargs="?", default="specs",
                    help="directory of RunSpec JSON files (default: specs/)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the specs run on (default: cuda)")
    ap.add_argument("--compile", action="store_true",
                    help="accepted for the reference's command lines; does "
                         "nothing (each stacked spec runs its recorded step "
                         "on the device with or without it)")
    ap.add_argument("--list", action="store_true",
                    help="just list the specs (name, describe line)")
    ap.add_argument("--audit", action="store_true",
                    help="run the static-analysis gate (repro_torch.analysis: "
                         "all step rules + the AST lint) over every spec "
                         "instead of the build/lower smoke pass")
    ap.add_argument("--out", default="",
                    help="with --audit: write the findings report json")
    args = ap.parse_args(argv)
    spec_dir = Path(args.spec_dir)
    if args.list:
        from repro_torch.serve import ServeSpec
        for path in sorted(spec_dir.glob("*.json")):
            if _is_serve_path(path):
                print(f"{path.name:32s} {ServeSpec.load(path).describe()}")
            else:
                print(f"{path.name:32s} {RunSpec.load(path).describe()}")
        return
    if args.audit:
        from repro_torch.analysis.audit import main as audit_main
        audit_main(["--spec", str(spec_dir), "--device", args.device]
                   + (["--out", args.out] if args.out else []))
        return
    results = run_matrix(spec_dir, compile_step=args.compile,
                         device=args.device)
    errs = [r for r in results if r["status"] == "error"]
    ok = len(results) - len(errs)
    print(f"== spec matrix on {args.device}: {ok} ok / {len(errs)} error ==")
    raise SystemExit(1 if errs else 0)


if __name__ == "__main__":
    main()
