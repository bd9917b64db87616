"""Audit-gated tuner: pick the fastest spec the auditor will certify
(counterpart of ``repro.run.tune``).

1. **Sweep** — expand the candidate axes over the base spec and model
   every candidate with ``perf_model.hier_epoch_time``
   (:mod:`repro_torch.run.sweep`, host only; graph/partition stages
   shared through a :class:`~repro_torch.run.session.BuildCache`).
2. **Gate** — walk the modelled ranking best-first and run the auditor
   (:func:`repro_torch.analysis.audit.audit_spec`) on each leader until
   ``top_k`` candidates audit clean. The audit records the candidate's
   stacked (vmap) step on ``device``: that is where the step rules fire;
   a multiproc spec would skip them and pass vacuously. A candidate with
   findings is recorded under ``rejected`` and never wins.
3. **Probe** — measure each shortlisted candidate's epochs on ``device``.
   The port skips a delayed stage's wire on a stale epoch, so a candidate
   with ``inter_cd=2`` alternates cheap and dear epochs: the timed epochs
   are rounded up to whole periods of the schedule (the lcm of its
   stages' ``cd``), and ``epoch_s`` is the median over periods of each
   period's mean epoch (``epochs_s`` keeps every epoch). Stacked probes
   hold every shortlist session open and interleave whole periods
   round-robin, so a drift of the machine lands on all candidates;
   multiproc probes stay sequential (an idle fleet polls its mailboxes).
   The measured/modelled ratio per candidate is the calibration.
4. **Pick** — the winner is the measured-fastest audit-clean candidate
   (modelled-fastest under ``--probe-mode none``). The result JSON has the
   JAX package's layout, so either package's ``exec.auto`` reads it.

  PYTHONPATH=src python -m repro_torch.run.tune --spec base.json \\
      [--axis "partition.refine=none,bucket-max"] [--top-k 3] \\
      [--probe-mode multiproc|vmap|none] [--device cpu] [--out tuned.json]

Then run it: ``python -m repro_torch.launch.train --spec base.json --set
exec.auto=tuned.json``.
"""

from __future__ import annotations

import json
import math
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.perf_model import FUGAKU_A64FX, HardwareSpec
from repro_torch.run.session import BuildCache, build_session
from repro_torch.run.spec import RunSpec
from repro_torch.run.sweep import product_overrides, sweep_rows

# Knobs that never change the learning problem, only how it executes:
# the partition post-pass, the inter-stage wire width, the delayed-comm
# period (capped at the flagship's cd=2 staleness budget), and the
# overlap toggle. Graph/model sections are the caller's contract.
DEFAULT_AXES = (
    "partition.refine=none,bucket-max",
    "schedule.inter_bits=0,2",
    "schedule.inter_cd=1,2",
    "schedule.overlap=true,false",
)


def audit_candidate(spec: RunSpec, steps: int = 2,
                    device="cuda") -> Dict[str, Any]:
    """Run the auditor against the candidate's stacked step on ``device``.

    Multiproc specs skip every step rule (nothing is recorded in the
    parent), so the gate audits the vmap variant of the same schedule."""
    from repro_torch.analysis.audit import audit_spec
    from repro_torch.analysis.rules import STACKED_OVERRIDES

    auditable = spec.with_overrides(list(STACKED_OVERRIDES))
    report = audit_spec(auditable, spec_name=spec.content_hash(),
                        steps=steps, device=device)
    findings = [f.as_dict() for f in report.get("findings", [])]
    return {
        "clean": not findings,
        "findings": findings,
        "ran": report.get("ran", []),
        "skipped": report.get("skipped", []),
        "rule_errors": report.get("rule_errors", []),
    }


def schedule_period(spec: RunSpec) -> int:
    """Epochs after which the schedule's refresh pattern repeats: the lcm
    of its stages' ``cd`` (1 without delayed stages)."""
    sched = spec.schedule.to_dist_config(spec.partition).schedule()
    return math.lcm(*(s.cd for s in sched.stages))


def period_epoch_s(times: Sequence[float], period: int) -> float:
    """The median over whole periods of each period's mean epoch seconds
    (``times`` holds a whole number of periods)."""
    means = [float(np.mean(times[i:i + period]))
             for i in range(0, len(times) - period + 1, period)]
    return float(np.median(means))


def _timed_epoch(sess) -> float:
    # train_epoch returns host floats, so the clock stops after the device
    # has finished the epoch (DistributedTrainer.train_epoch's sync).
    t0 = time.perf_counter()
    sess.train_epoch()
    return time.perf_counter() - t0


def _periods(epochs: int, period: int) -> int:
    return max(1, -(-epochs // period))


def measure_epoch_s(spec: RunSpec, epochs: int = 3, warmup: int = 1,
                    cache: Optional[BuildCache] = None,
                    device="cuda") -> Dict[str, Any]:
    """Measured epoch seconds for ``spec`` as given (callers pick the exec
    mode) on ``device``: ``warmup`` epochs absorb table builds and spawns,
    then ``epochs`` rounded up to whole periods are timed."""
    period = schedule_period(spec)
    sess = build_session(spec, device=device, cache=cache)
    try:
        for _ in range(warmup):
            sess.train_epoch()
        times = [_timed_epoch(sess)
                 for _ in range(_periods(epochs, period) * period)]
    finally:
        sess.close()
    return {"epoch_s": period_epoch_s(times, period), "epochs_s": times,
            "warmup": warmup, "period": period}


# Probe runs disable the stale-heartbeat hang detector: a probe epoch's
# workers spend most of it in compute, where heartbeats don't advance, so a
# hiccup past exec.heartbeat_s would abort the whole tune.
_PROBE_OVERRIDES = {
    "multiproc": ["exec.mode=multiproc", "exec.nprocs=0",
                  "exec.heartbeat_s=0"],
    "vmap": ["exec.mode=vmap", "exec.nprocs=0"],
}


def measure_probes(specs: Dict[str, RunSpec], mode: str,
                   epochs: int = 3, warmup: int = 1,
                   cache: Optional[BuildCache] = None,
                   device="cuda") -> Dict[str, Any]:
    """Measured probes for a shortlist, keyed like ``specs``.

    Stacked sessions are inert between epochs, so every session stays open
    and the rounds interleave: each round times one whole period of every
    candidate that still needs one, back to back, and each candidate's
    median sees the same machine. Multiproc sessions cannot overlap (an
    idle fleet polls its mailboxes and would perturb the one under test),
    so those run one after another."""
    if mode != "vmap" or len(specs) < 2:
        return {h: measure_epoch_s(s, epochs=epochs, warmup=warmup,
                                   cache=cache, device=device)
                for h, s in specs.items()}
    periods = {h: schedule_period(s) for h, s in specs.items()}
    rounds = {h: _periods(epochs, p) for h, p in periods.items()}
    sessions: Dict[str, Any] = {}
    times: Dict[str, List[float]] = {h: [] for h in specs}
    try:
        for h, s in specs.items():
            sessions[h] = build_session(s, device=device, cache=cache)
        for sess in sessions.values():
            for _ in range(warmup):
                sess.train_epoch()
        for r in range(max(rounds.values())):
            for h, sess in sessions.items():
                if r < rounds[h]:
                    times[h].extend(_timed_epoch(sess)
                                    for _ in range(periods[h]))
    finally:
        for sess in sessions.values():
            sess.close()
    return {h: {"epoch_s": period_epoch_s(ts, periods[h]), "epochs_s": ts,
                "warmup": warmup, "period": periods[h], "interleaved": True}
            for h, ts in times.items()}


def tune(base: RunSpec,
         axes: Optional[Sequence[str]] = None,
         override_sets: Optional[Sequence[Sequence[str]]] = None,
         cache: Optional[BuildCache] = None,
         hw: HardwareSpec = FUGAKU_A64FX,
         top_k: int = 3,
         probe_mode: str = "multiproc",
         probe_epochs: int = 3,
         probe_warmup: int = 1,
         audit: bool = True,
         audit_steps: int = 2,
         verbose: bool = False,
         device="cuda") -> Dict[str, Any]:
    """Sweep, gate, probe, pick; audits and probes run on ``device``.
    Returns the tuner result dict whose ``winner.spec`` feeds
    ``exec.auto``. The base spec itself is always a candidate (empty
    override-set), so the tuner can only match or beat the configuration
    it started from — modulo measurement noise."""
    if probe_mode not in ("multiproc", "vmap", "none"):
        raise ValueError(f"probe_mode {probe_mode!r} not in "
                         "('multiproc', 'vmap', 'none')")
    cache = cache or BuildCache()
    if override_sets is None:
        override_sets = product_overrides(axes or DEFAULT_AXES)
    override_sets = [[]] + [list(o) for o in override_sets]
    rows, invalid = sweep_rows(base, override_sets, cache=cache, hw=hw,
                               include_spec=False, verbose=verbose)
    ranked = sorted(rows, key=lambda r: r["modelled_epoch_s"])

    shortlist: List[Dict[str, Any]] = []
    rejected: List[Dict[str, Any]] = []
    specs: Dict[str, RunSpec] = {}
    for row in ranked:
        if len(shortlist) >= top_k:
            break
        spec = base.with_overrides(row["overrides"])
        specs[row["spec_hash"]] = spec
        gate = (audit_candidate(spec, steps=audit_steps, device=device)
                if audit
                else {"clean": True, "findings": [], "ran": [],
                      "skipped": ["(audit disabled)"], "rule_errors": []})
        entry = {
            "spec_hash": row["spec_hash"],
            "overrides": row["overrides"],
            "modelled_epoch_s": row["modelled_epoch_s"],
            "partition_stats": row["partition_stats"],
            "audit": gate,
        }
        if gate["clean"]:
            shortlist.append(entry)
            if verbose:
                print(f"# audit clean: {row['spec_hash']} "
                      f"{' '.join(row['overrides']) or '(base)'}", flush=True)
        else:
            rejected.append(entry)
            if verbose:
                print(f"# audit REJECTED: {row['spec_hash']} "
                      f"({len(gate['findings'])} findings)", flush=True)

    if probe_mode != "none" and shortlist:
        probe_specs = {
            c["spec_hash"]: specs[c["spec_hash"]].with_overrides(
                _PROBE_OVERRIDES[probe_mode])
            for c in shortlist}
        probes = measure_probes(probe_specs, probe_mode,
                                epochs=probe_epochs, warmup=probe_warmup,
                                cache=cache, device=device)
        for cand in shortlist:
            probe = probes[cand["spec_hash"]]
            cand["measured_epoch_s"] = probe["epoch_s"]
            cand["probe"] = probe
            cand["calibration"] = (probe["epoch_s"]
                                   / cand["modelled_epoch_s"])
            if verbose:
                print(f"# probe [{probe_mode}]: {cand['spec_hash']} "
                      f"measured={probe['epoch_s']:.4g}s "
                      f"modelled={cand['modelled_epoch_s']:.4g}s",
                      flush=True)

    key = ("measured_epoch_s" if probe_mode != "none"
           else "modelled_epoch_s")
    winner_entry = min(shortlist, key=lambda c: c[key], default=None)
    winner: Optional[Dict[str, Any]] = None
    if winner_entry is not None:
        winner = dict(winner_entry)
        winner["spec"] = specs[winner_entry["spec_hash"]].to_dict()
    calibrations = [c["calibration"] for c in shortlist
                    if "calibration" in c]
    return {
        "tuner": {
            "top_k": top_k, "probe_mode": probe_mode,
            "probe_epochs": probe_epochs, "probe_warmup": probe_warmup,
            "audit": audit, "audit_steps": audit_steps,
            "ranked_by": key, "device": str(device),
        },
        "base": {"spec_hash": base.content_hash(),
                 "spec": base.to_dict()},
        "hw": {"name": hw.name, "bw_comm": hw.bw_comm,
               "latency": hw.latency, "th_cal": hw.th_cal},
        "rows": ranked,
        "invalid": invalid,
        "rejected": rejected,
        "shortlist": shortlist,
        "calibration": (float(np.median(calibrations))
                        if calibrations else None),
        "winner": winner,
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import sys

    from repro_torch.core.perf_model import HARDWARE, get_hardware
    from repro_torch.run.cli import add_spec_args, spec_from_args

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_spec_args(ap)
    ap.add_argument("--axis", action="append", default=[],
                    metavar="PATH=V1,V2,...",
                    help="candidate axis (repeatable; default: the "
                         "execution-only knob set)")
    ap.add_argument("--top-k", type=int, default=3,
                    help="audit-clean candidates to probe measured")
    ap.add_argument("--probe-mode", default="multiproc",
                    choices=["multiproc", "vmap", "none"],
                    help="measured probe backend (none: rank by model)")
    ap.add_argument("--probe-epochs", type=int, default=3,
                    help="timed epochs per probe, rounded up to whole "
                         "periods of the candidate's schedule")
    ap.add_argument("--probe-warmup", type=int, default=1)
    ap.add_argument("--steps", type=int, default=2,
                    help="training steps per audit")
    ap.add_argument("--no-audit", action="store_true",
                    help="skip the auditor gate (debugging only; an "
                         "unaudited winner is not a certified spec)")
    ap.add_argument("--hw", default=FUGAKU_A64FX.name,
                    choices=sorted(HARDWARE) + ["measured"],
                    help="hardware model for the ranking sweep")
    ap.add_argument("--device", default="cuda",
                    help="torch device the audits and probes run on "
                         "(default: cuda)")
    ap.add_argument("--out", default="",
                    help="write the tuner result JSON here (the file "
                         "exec.auto consumes); default: stdout")
    args = ap.parse_args(argv)
    base = spec_from_args(args)
    result = tune(base,
                  axes=args.axis or None,
                  hw=get_hardware(args.hw),
                  top_k=args.top_k,
                  probe_mode=args.probe_mode,
                  probe_epochs=args.probe_epochs,
                  probe_warmup=args.probe_warmup,
                  audit=not args.no_audit,
                  audit_steps=args.steps,
                  verbose=True,
                  device=args.device)
    w = result["winner"]
    if w is None:
        print("tune: no candidate passed the audit gate", file=sys.stderr)
        sys.exit(2)
    payload = json.dumps(result, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
        print(f"# winner {w['spec_hash']} "
              f"({' '.join(w['overrides']) or 'base as-is'}) -> {args.out}",
              file=sys.stderr)
        print(f"# run it: --set exec.auto={args.out}", file=sys.stderr)
    else:
        print(payload)


if __name__ == "__main__":
    main()
