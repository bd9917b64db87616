"""Rule registry + findings for the spec auditor (counterpart of
``repro.analysis.rules``).

A :class:`Rule` checks one invariant of a recorded training step
(``core.record.LoweredStep``) against the :class:`~repro_torch.run.spec.RunSpec`
that produced it, and reports :class:`Finding`\\ s (id, severity, message,
location, fix hint). Rules register into :data:`RULES` via
:func:`register_rule` and run through :func:`run_rules` over an
:class:`AuditContext` — a lazy view of one spec's build artifacts (the
session on its device, the recorded step, the predicted wire bytes) that
only pays for what the selected rules touch.

A ``shard_map`` spec trains as one process per worker
(``launch.spmd``); its context reads every rank's own recorded program
(``core.record.RankPrograms``), with the process group of each
collective, as the JAX package's reads the lowered ``shard_map`` module.
A ``vmap`` spec's is the stacked step of all workers. Multiproc records
none.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.utils.registry import Registry

# The overrides that give a spec's stacked (vmap) variant: what the tuner
# audits, as the JAX package's tuner does.
STACKED_OVERRIDES = ("exec.mode=vmap", "exec.nprocs=0")


class Severity:
    """Finding severities, ordered. ``exit_code`` maps the worst finding
    of an audit onto the audit CLI's exit-code contract (clean/info = 0)."""

    INFO = "info"
    WARNING = "warning"
    ERROR = "error"
    ORDER = (INFO, WARNING, ERROR)

    @classmethod
    def rank(cls, severity: str) -> int:
        return cls.ORDER.index(severity)


def worst_severity(findings: Sequence["Finding"]) -> Optional[str]:
    if not findings:
        return None
    return max((f.severity for f in findings), key=Severity.rank)


@dataclass
class Finding:
    """One rule violation (or informational note) at a location."""

    rule: str
    severity: str
    message: str
    location: str = ""        # "step:17", "src/.../trainer.py:123", ...
    fix_hint: str = ""
    data: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> dict:
        d = {"rule": self.rule, "severity": self.severity,
             "message": self.message, "location": self.location}
        if self.fix_hint:
            d["fix_hint"] = self.fix_hint
        if self.data:
            d["data"] = self.data
        return d

    def __str__(self) -> str:
        loc = f" @ {self.location}" if self.location else ""
        return f"[{self.severity.upper()}] {self.rule}{loc}: {self.message}"


class AuditContext:
    """Lazy build artifacts for one spec under audit, on ``device``.

    ``session`` / ``lowered`` / ``predicted_bytes`` build on first access
    and memoize; rules declare what they touch simply by touching it.
    ``steps`` bounds execution-based rules (retrace-guard). Call
    :meth:`close` to release the session (and its device memory).
    """

    def __init__(self, spec, spec_name: str = "", steps: int = 3,
                 device="cuda"):
        self.spec = spec
        self.spec_name = spec_name or spec.content_hash()
        self.steps = steps
        self.device = device
        self._session = None
        self._schedule = None
        self._lowered = None
        self._later = {}       # lowered programs of epochs after 0
        self._predicted = None

    @property
    def session(self):
        if self._session is None:
            from repro_torch.run.session import build_session
            self._session = build_session(self.spec, device=self.device)
        return self._session

    @property
    def schedule(self):
        """The ExchangeSchedule, derived from the spec alone (topology +
        stage knobs, no graph build), so rules can audit a hand-built step
        without a session."""
        if self._schedule is None:
            dc = self.spec.schedule.to_dist_config(self.spec.partition,
                                                   lr=self.spec.exec.lr)
            self._schedule = dc.schedule()
        return self._schedule

    @property
    def lowered(self):
        """The recorded step of epoch 0, a refresh epoch: every stage's
        wire runs (``core.record.LoweredStep``, or ``RankPrograms`` for a
        ``shard_map`` spec)."""
        if self._lowered is None:
            self._lowered = self.session.lower(epoch=0)
        return self._lowered

    def lowered_at(self, epoch: int):
        """The recorded step of ``epoch`` (memoized)."""
        if epoch == 0:
            return self.lowered
        if epoch not in self._later:
            self._later[epoch] = self.session.lower(epoch=epoch)
        return self._later[epoch]

    @property
    def predicted_bytes(self) -> Dict[str, float]:
        """``Session.predicted_hlo_wire_bytes()``."""
        if self._predicted is None:
            self._predicted = self.session.predicted_hlo_wire_bytes()
        return self._predicted

    @property
    def recorded(self) -> bool:
        """The step rules read a recorded step: the stacked one (vmap) or
        the ranks' (shard_map). Multiproc records none (the rules skip it,
        as the JAX package's skip every mode but shard_map)."""
        return self.spec.exec.mode != "multiproc"

    def close(self) -> None:
        if self._session is not None:
            self._session.close()
        self._session = None


class Rule:
    """One audit rule. Subclasses set the class attributes and implement
    :meth:`check`; :meth:`applies` gates on spec properties (a rule that
    does not apply is recorded as skipped, not passed)."""

    id: str = ""
    description: str = ""
    severity: str = Severity.ERROR

    def applies(self, ctx: AuditContext) -> bool:
        return True

    def check(self, ctx: AuditContext) -> List[Finding]:
        raise NotImplementedError

    def finding(self, message: str, location: str = "",
                fix_hint: str = "", severity: Optional[str] = None,
                **data) -> Finding:
        return Finding(rule=self.id, severity=severity or self.severity,
                       message=message, location=location,
                       fix_hint=fix_hint, data=data)


RULES: Registry = Registry("audit rule")


def register_rule(cls):
    """Class decorator: instantiate and register an audit rule by id."""
    if not cls.id:
        raise ValueError(f"rule {cls.__name__} needs a non-empty id")
    RULES.add(cls.id, cls())
    return cls


def run_rules(ctx: AuditContext,
              rule_ids: Optional[Sequence[str]] = None
              ) -> Dict[str, Any]:
    """Run the selected rules (default: all registered) over ``ctx``.

    Returns ``{"findings": [...], "ran": [...], "skipped": [...],
    "rule_errors": [...]}``. A rule that raises is reported as an ERROR
    finding against the rule itself (an auditor crash must not pass
    silently) and listed in ``rule_errors``.
    """
    ids = list(rule_ids) if rule_ids is not None else list(RULES)
    findings: List[Finding] = []
    ran: List[str] = []
    skipped: List[str] = []
    rule_errors: List[str] = []
    for rid in ids:
        rule = RULES.get(rid)
        try:
            if not rule.applies(ctx):
                skipped.append(rid)
                continue
            findings.extend(rule.check(ctx))
            ran.append(rid)
        except Exception as e:  # noqa: BLE001 — auditor must not crash the run
            rule_errors.append(rid)
            findings.append(Finding(
                rule=rid, severity=Severity.ERROR,
                message=f"rule crashed: {type(e).__name__}: {e}",
                location=ctx.spec_name))
    return {"findings": findings, "ran": ran, "skipped": skipped,
            "rule_errors": rule_errors}
