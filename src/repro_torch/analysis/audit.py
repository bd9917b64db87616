"""Audit CLI: run every registered rule + the AST lint over specs
(counterpart of ``repro.analysis.audit``).

  PYTHONPATH=src python -m repro_torch.analysis.audit --spec specs/X.json \\
      [--device cpu] [--out findings.json]

With no ``--spec``, audits every ``*.json`` under ``specs/`` (the
canonical support matrix). Each spec's step is built and recorded on
``--device`` (the card by default; it raises if there is none, and
``--device cpu`` runs the plain PyTorch path). A ``shard_map`` spec is
audited on its ranks' own recorded programs (``Session.lower()``, no
fleet started). Exit codes are severity-aware:

  0  clean, or worst finding below the ``--fail-on`` threshold
  1  worst finding is a WARNING at/above the threshold
  2  worst finding is an ERROR (including a crashed rule or unbuildable
     spec — the auditor failing must not read as the program passing)
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.analysis import hlo_rules  # noqa: F401  (registers the step rules)
from repro_torch.analysis.ast_lint import lint_paths
from repro_torch.analysis.rules import (
    RULES,
    AuditContext,
    Finding,
    Severity,
    run_rules,
    worst_severity,
)

DEFAULT_SPEC_DIR = "specs"
DEFAULT_LINT_PATHS = ("src/repro_torch",)


def _load_run_spec(path: Path):
    """Load a spec file's RunSpec — directly, or the embedded ``run``
    section when the file is a ServeSpec (the rules audit the training
    program a serving deployment's parameters come from)."""
    from repro_torch.run.spec import RunSpec
    from repro_torch.serve.spec import ServeSpec, is_serve_spec_dict
    d = json.loads(Path(path).read_text())
    if is_serve_spec_dict(d):
        return ServeSpec.from_dict(d).run
    return RunSpec.from_dict(d)


def audit_spec(spec, spec_name: str = "",
               rule_ids: Optional[Sequence[str]] = None,
               steps: int = 3, device="cuda") -> Dict[str, Any]:
    """Run the (selected) step rules over one RunSpec built on ``device``.

    Returns ``run_rules``' dict: findings (Finding objects), ran, skipped,
    rule_errors, plus ``ranks`` (the rank programs read) for a
    ``shard_map`` spec. The session is closed before returning.
    """
    ctx = AuditContext(spec, spec_name=spec_name, steps=steps, device=device)
    try:
        res = run_rules(ctx, rule_ids)
        if ctx._lowered is not None and ctx._lowered.programs[0].rank is not None:
            res["ranks"] = len(ctx._lowered.programs)
    finally:
        ctx.close()
    return res


def _resolve_spec_paths(spec_args: Sequence[str]) -> List[Path]:
    paths: List[Path] = []
    for arg in (spec_args or [DEFAULT_SPEC_DIR]):
        p = Path(arg)
        if p.is_dir():
            paths.extend(sorted(p.glob("*.json")))
        else:
            paths.append(p)
    if not paths:
        raise SystemExit(f"no spec json files found in {list(spec_args)}")
    return paths


def audit_paths(spec_paths: Sequence[Path],
                rule_ids: Optional[Sequence[str]] = None,
                steps: int = 3,
                lint: Sequence[str] = DEFAULT_LINT_PATHS,
                verbose: bool = True, device="cuda") -> Dict[str, Any]:
    """Audit each spec file on ``device`` plus the AST lint; return the
    full report."""
    report: Dict[str, Any] = {
        "version": 1,
        "rules": {rid: RULES.get(rid).description for rid in RULES},
        "device": str(device),
        "specs": [],
        "lint": {"paths": list(lint), "findings": []},
    }
    all_findings: List[Finding] = []
    for path in spec_paths:
        t0 = time.time()
        rec: Dict[str, Any] = {"spec": path.name, "path": str(path)}
        try:
            spec = _load_run_spec(path)
            rec["hash"] = spec.content_hash()
            res = audit_spec(spec, spec_name=path.name,
                             rule_ids=rule_ids, steps=steps, device=device)
        except Exception as e:  # unbuildable spec = audit error, not crash
            res = {"findings": [Finding(
                rule="audit", severity=Severity.ERROR,
                message=f"spec failed to load/build: "
                        f"{type(e).__name__}: {e}",
                location=path.name)],
                "ran": [], "skipped": [], "rule_errors": ["audit"]}
        rec["ran"] = res["ran"]
        rec["skipped"] = res["skipped"]
        rec["rule_errors"] = res["rule_errors"]
        if "ranks" in res:
            rec["ranks"] = res["ranks"]
        rec["findings"] = [f.as_dict() for f in res["findings"]]
        rec["elapsed_s"] = round(time.time() - t0, 2)
        report["specs"].append(rec)
        all_findings.extend(res["findings"])
        if verbose:
            n = len(res["findings"])
            tag = "FAIL" if n else "ok"
            as_ = f" ranks={rec['ranks']}" if "ranks" in rec else ""
            print(f"[{tag:4s}] {path.name:34s} ran={len(res['ran'])} "
                  f"skipped={len(res['skipped'])} findings={n}{as_} "
                  f"({rec['elapsed_s']}s)")
            for f in res["findings"]:
                print(f"       {f}")
    if lint:
        lint_findings = lint_paths(lint)
        report["lint"]["findings"] = [f.as_dict() for f in lint_findings]
        all_findings.extend(lint_findings)
        if verbose:
            n = len(lint_findings)
            print(f"[{'FAIL' if n else 'ok':4s}] ast-lint "
                  f"{', '.join(map(str, lint)):24s} findings={n}")
            for f in lint_findings:
                print(f"       {f}")
    counts = {s: 0 for s in Severity.ORDER}
    for f in all_findings:
        counts[f.severity] += 1
    report["summary"] = {
        "findings": len(all_findings),
        "worst": worst_severity(all_findings),
        "by_severity": counts,
    }
    return report


def exit_code(report: Dict[str, Any], fail_on: str = Severity.ERROR) -> int:
    worst = report["summary"]["worst"]
    if worst is None:
        return 0
    if Severity.rank(worst) < Severity.rank(fail_on):
        return 0
    return 2 if worst == Severity.ERROR else 1


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spec", action="append", default=[],
                    help="spec json file or directory of specs "
                         "(repeatable; default: specs/)")
    ap.add_argument("--device", default="cuda",
                    help="torch device each spec's step runs on "
                         "(default: cuda)")
    ap.add_argument("--out", default="",
                    help="write the findings report as json")
    ap.add_argument("--rules", default="",
                    help="comma-separated rule ids (default: all "
                         f"registered: {', '.join(RULES)})")
    ap.add_argument("--steps", type=int, default=3,
                    help="training steps for execution rules "
                         "(retrace-guard; default 3)")
    ap.add_argument("--fail-on", choices=[Severity.WARNING, Severity.ERROR],
                    default=Severity.ERROR,
                    help="lowest severity that fails the gate "
                         "(default: error)")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the Python AST lint pass")
    ap.add_argument("--lint-path", action="append", default=[],
                    help="paths for the AST lint "
                         f"(default: {', '.join(DEFAULT_LINT_PATHS)})")
    args = ap.parse_args(argv)

    rule_ids = ([r.strip() for r in args.rules.split(",") if r.strip()]
                or None)
    lint = () if args.no_lint else tuple(args.lint_path) or DEFAULT_LINT_PATHS
    report = audit_paths(_resolve_spec_paths(args.spec),
                         rule_ids=rule_ids, steps=args.steps, lint=lint,
                         device=args.device)
    if args.out:
        Path(args.out).write_text(json.dumps(report, indent=1))
        print(f"report -> {args.out}")
    s = report["summary"]
    print(f"== audit: {len(report['specs'])} specs on {args.device}, "
          f"{s['findings']} findings (worst: {s['worst'] or 'clean'}) ==")
    raise SystemExit(exit_code(report, fail_on=args.fail_on))


if __name__ == "__main__":
    main()
