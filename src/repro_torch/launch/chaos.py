"""Deterministic chaos harness for the fault-tolerant multiproc runtime.

Counterpart of ``repro/launch/chaos.py``. It injects one fault into a
multiproc training run and checks the supervisor's recovery end to end
against a fault-free baseline:

* ``kill``         — rank R calls ``os._exit(137)`` at the start of the
                     epoch after ``--at-epoch`` completed epochs (a crash;
                     the parent sees a dead process).
* ``stall``        — rank R sleeps without heartbeating; the parent must
                     flag the *live* process hung from its stale heartbeat.
* ``ckpt-corrupt`` — the parent flips bytes in rank R's newest checkpoint
                     arrays after epoch N, then R is killed at the next
                     epoch: the restore must detect the checksum mismatch
                     and fall back to the previous common step.

Faults come through the rank-side environment hook (``REPRO_CHAOS_FAULT``,
``REPRO_CHAOS_RANK``, ``REPRO_CHAOS_EPOCH``; spawn generation 0 only, so a
respawned rank never fires again) and, for ``ckpt-corrupt``, a change on
disk. Nothing is random: every run of the harness gives the same failure
and the same recovery.

A case passes when the faulted run's per-epoch losses match the baseline
to ``--tol`` (default 1e-5; the match is bitwise in practice, since every
draw derives from the epoch number and the gradient sum runs in rank
order), the recovery log shows the expected detection kind, and no
shared-memory segment leaks. ``--out`` writes a JSON report (spec hash,
detection latency, respawn and restore seconds, restore step, loss
deltas per case); the exit code is non-zero when a case fails.

Examples:
  python -m repro_torch.launch.chaos --fault kill --rank 1 --at-epoch 2
  python -m repro_torch.launch.chaos --spec specs/multiproc_p4.json \\
      --fault stall --set exec.heartbeat_s=5
  python -m repro_torch.launch.chaos --fault all --device cpu --out report.json
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

FAULTS = ("kill", "stall", "ckpt-corrupt")
DEFAULT_TOL = 1e-5

_CHAOS_ENV = ("REPRO_CHAOS_FAULT", "REPRO_CHAOS_RANK", "REPRO_CHAOS_EPOCH")

# Default workload: hierarchical P=4, Int2 inter wire with cd=2, overlap
# (two-level exchange, a quantized inter stage, delayed refresh) at a size
# where the whole kill/stall/corrupt matrix runs in minutes on a CPU.
_DEFAULT_BASE = [
    "graph.source=sbm", "graph.nodes=128", "graph.classes=4",
    "graph.feat_dim=16", "graph.feat_noise=2.0", "graph.homophily=0.8",
    "graph.norm=mean",
    "partition.nparts=4", "partition.groups=2",
    "schedule.bits=2", "schedule.inter_bits=2", "schedule.inter_cd=2",
    "schedule.overlap=true", "schedule.agg_backend=ell",
    "model.model=sage", "model.hidden_dim=16", "model.num_layers=2",
    "model.dropout=0.0", "model.label_prop=true",
    "exec.mode=multiproc", "exec.nprocs=4", "exec.epochs=6",
    "exec.ckpt_every=1", "exec.max_restarts=2", "exec.heartbeat_s=5.0",
]


def _default_spec():
    from repro_torch.run import RunSpec
    return RunSpec().with_overrides(_DEFAULT_BASE)


def _clear_chaos_env() -> None:
    for k in _CHAOS_ENV:
        os.environ.pop(k, None)


def _set_chaos_env(fault: str, rank: int, epoch: int) -> None:
    os.environ["REPRO_CHAOS_FAULT"] = fault
    os.environ["REPRO_CHAOS_RANK"] = str(rank)
    os.environ["REPRO_CHAOS_EPOCH"] = str(epoch)


def _corrupt_npz(path: Path, span: int = 64) -> None:
    """Flip a run of bytes in the middle of the arrays file, past the zip
    header, so the change lands in array payload and the manifest's
    sha256 check (not a zip parse error) catches it."""
    data = bytearray(path.read_bytes())
    mid = len(data) // 2
    for i in range(mid, min(mid + span, len(data))):
        data[i] ^= 0xFF
    path.write_bytes(bytes(data))


def run_baseline(spec, device="cuda") -> List[float]:
    """Fault-free per-epoch losses: what every recovery must reproduce."""
    from repro_torch.run import build_session
    _clear_chaos_env()
    s = build_session(spec, device=device)
    losses: List[float] = []
    try:
        for _ in range(spec.exec.epochs):
            losses.append(float(s.train_epoch()["loss"]))
    finally:
        s.close()
    return losses


def run_faulted(spec, fault: str, rank: int, at_epoch: int, ckpt_dir: str,
                device="cuda") -> dict:
    """One faulted run under supervision; returns what it observed
    (losses, recovery events, leaked segments, the abort error if any)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.shm_store import leaked_segments
    from repro_torch.run import build_session

    # ckpt-corrupt has two parts: the parent changes the newest snapshot
    # after epoch N, and the hook kills the same rank one epoch later, so
    # the restore has to meet the corrupted step.
    _set_chaos_env("kill" if fault == "ckpt-corrupt" else fault, rank, at_epoch)
    s = build_session(spec, device=device)
    rt = s.trainer
    rt.configure_ckpt(ckpt_dir, every=max(1, spec.exec.ckpt_every))
    losses: Dict[int, float] = {}
    corrupted_step: Optional[int] = None
    error: Optional[str] = None
    t0 = time.time()
    try:
        while rt.epoch < spec.exec.epochs:
            m = rt.train_epoch()
            losses[rt.epoch] = float(m["loss"])
            if (fault == "ckpt-corrupt" and corrupted_step is None
                    and rt.epoch >= at_epoch):
                mgr = CheckpointManager(Path(ckpt_dir) / f"rank{rank}")
                corrupted_step = mgr.latest()
                _corrupt_npz(mgr.path_for(corrupted_step).with_suffix(".npz"))
    except RuntimeError as e:
        error = str(e)
    finally:
        events = [dict(ev) for ev in rt.recovery_events]
        token = rt.token
        s.close()
        _clear_chaos_env()
    return {
        "losses": losses,
        "events": events,
        "error": error,
        "corrupted_step": corrupted_step,
        "leaked_segments": leaked_segments(token) if token else [],
        "wall_s": round(time.time() - t0, 3),
    }


def evaluate_case(fault: str, rank: int, at_epoch: int, baseline: List[float],
                  obs: dict, tol: float) -> dict:
    """Judge one faulted run against the baseline: the report's case."""
    events = obs["events"]
    expect_kind = "hung" if fault == "stall" else "dead"
    deltas = {e: abs(obs["losses"][e] - baseline[e - 1])
              for e in obs["losses"] if 1 <= e <= len(baseline)}
    max_delta = max(deltas.values()) if deltas else None
    complete = len(obs["losses"]) == len(baseline)
    checks = {
        "recovered": obs["error"] is None and complete,
        "fault_detected": bool(events) and events[0]["kind"] == expect_kind,
        "faulted_rank_flagged": bool(events) and rank in events[0]["ranks"],
        "loss_match": complete and max_delta is not None and max_delta <= tol,
        "no_leaked_segments": obs["leaked_segments"] == [],
    }
    if fault == "ckpt-corrupt":
        # The corrupted snapshot must be skipped: the restore lands on the
        # step before the one the parent changed.
        checks["fallback_past_corrupt"] = bool(events) and (
            obs["corrupted_step"] is not None
            and events[0].get("restore_step") is not None
            and events[0]["restore_step"] < obs["corrupted_step"])
    first = events[0] if events else {}
    return {
        "fault": fault,
        "rank": rank,
        "at_epoch": at_epoch,
        "ok": all(checks.values()),
        "checks": checks,
        "detection_latency_s": first.get("detect_s"),
        "detection_kind": first.get("kind"),
        "respawn_s": first.get("respawn_s"),
        "restore_s": first.get("restore_s"),
        "restarts": max((ev.get("restarts", 0) for ev in events), default=0),
        "restore_step": first.get("restore_step"),
        "resume_epoch": first.get("resume_epoch"),
        "corrupted_step": obs["corrupted_step"],
        "max_loss_delta": max_delta,
        "faulted_losses": [obs["losses"].get(e) for e in range(1, len(baseline) + 1)],
        "leaked_segments": obs["leaked_segments"],
        "error": obs["error"],
        "events": events,
        "wall_s": obs["wall_s"],
    }


def _case_plan(fault: str, rank: int, at_epoch: int, nprocs: int):
    """[(fault, rank, at_epoch)]: one case, or the whole matrix for
    ``all`` (other ranks and epochs, so different ranks and phases are
    hit)."""
    if fault != "all":
        return [(fault, rank, at_epoch)]
    return [
        ("kill", rank, at_epoch),
        ("stall", (rank + 1) % nprocs, at_epoch + 1),
        ("ckpt-corrupt", rank, max(2, at_epoch)),
    ]


def main(argv=None) -> int:
    from repro_torch.run import RunSpec

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.chaos",
        description="deterministic fault injection and recovery check for the "
                    "multiproc runtime")
    ap.add_argument("--spec", default=None, metavar="FILE.json",
                    help="RunSpec JSON (default: hierarchical P=4 toy spec)")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="SECTION.FIELD=VALUE", help="override one spec field")
    ap.add_argument("--device", default="cuda",
                    help="torch device every rank trains on (default: cuda)")
    ap.add_argument("--fault", choices=FAULTS + ("all",), default="all",
                    help="fault to inject (all = kill/stall/ckpt-corrupt "
                         "against one shared baseline)")
    ap.add_argument("--rank", type=int, default=1,
                    help="rank the fault targets (default 1)")
    ap.add_argument("--at-epoch", dest="at_epoch", type=int, default=2,
                    help="completed epochs before the fault fires "
                         "(default 2; must leave >= 1 epoch after recovery)")
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL,
                    help="max per-epoch |loss - baseline| for a pass")
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="checkpoint root (default: a private temporary "
                         "directory per case, removed afterwards)")
    ap.add_argument("--out", type=str, default=None, metavar="REPORT.json",
                    help="write the recovery report here")
    args = ap.parse_args(argv)

    spec = (RunSpec.load(args.spec) if args.spec else _default_spec()
            ).with_overrides(args.overrides)
    if spec.exec.mode != "multiproc":
        raise SystemExit("chaos targets the multiproc runtime; pass "
                         "--set exec.mode=multiproc (and exec.nprocs)")
    fixes = []
    if spec.exec.ckpt_every < 1:
        fixes.append("exec.ckpt_every=1")
    if spec.exec.max_restarts < 1:
        fixes.append("exec.max_restarts=2")
    if spec.exec.heartbeat_s <= 0:
        fixes.append("exec.heartbeat_s=5.0")
    if fixes:
        print(f"chaos: forcing {' '.join(fixes)}")
        spec = spec.with_overrides(fixes)
    nprocs = spec.exec.nprocs or spec.partition.nparts
    plan = _case_plan(args.fault, args.rank, args.at_epoch, nprocs)
    for f, r, at in plan:
        if not (0 <= r < nprocs):
            raise SystemExit(f"--rank {r} out of range for nprocs={nprocs}")
        if not (1 <= at < spec.exec.epochs - (1 if f == "ckpt-corrupt" else 0)):
            raise SystemExit(f"--at-epoch {at} leaves no epoch to recover "
                             f"into (epochs={spec.exec.epochs})")

    print(f"spec: {spec.describe()}")
    print(f"chaos plan: {[(f, r, at) for f, r, at in plan]} on {args.device}")
    t0 = time.time()
    print("baseline: fault-free run ...")
    baseline = run_baseline(spec, device=args.device)
    print("baseline losses: " + " ".join(f"{x:.6f}" for x in baseline))

    cases = []
    for f, r, at in plan:
        print(f"case {f}: rank {r} after epoch {at} ...")
        if args.ckpt_dir:
            d = Path(args.ckpt_dir) / f.replace("-", "_")
            d.mkdir(parents=True, exist_ok=True)
            obs = run_faulted(spec, f, r, at, str(d), device=args.device)
        else:
            with tempfile.TemporaryDirectory(prefix="chaos-ckpt-") as d:
                obs = run_faulted(spec, f, r, at, d, device=args.device)
        case = evaluate_case(f, r, at, baseline, obs, args.tol)
        cases.append(case)
        status = "OK" if case["ok"] else "FAIL " + str(
            [k for k, v in case["checks"].items() if not v])
        print(f"  -> {status}: detected {case['detection_kind']} in "
              f"{case['detection_latency_s']} s, respawn {case['respawn_s']} s, "
              f"restore {case['restore_s']} s, restored step "
              f"{case['restore_step']}, max loss delta {case['max_loss_delta']}")

    report = {
        "bench": "multiproc_fault_recovery",
        "generated_unix": int(t0),
        "device": args.device,
        "spec_hash": spec.content_hash(),
        "spec": spec.describe(),
        "nprocs": nprocs,
        "epochs": spec.exec.epochs,
        "heartbeat_s": spec.exec.heartbeat_s,
        "ckpt_every": max(1, spec.exec.ckpt_every),
        "max_restarts": spec.exec.max_restarts,
        "tol": args.tol,
        "baseline_losses": baseline,
        "cases": cases,
        "ok": all(c["ok"] for c in cases),
        "wall_s": round(time.time() - t0, 3),
    }
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1) + "\n")
        print(f"report -> {out}")
    print(f"chaos: {'ALL OK' if report['ok'] else 'FAILURES'} "
          f"({sum(c['ok'] for c in cases)}/{len(cases)} cases, {report['wall_s']} s)")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
