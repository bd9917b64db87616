# Static-analysis gate over recorded training steps and the specs that
# produced them: the recorded step (ir.py; the port's counterpart of the
# JAX package's lowered StableHLO), a rule registry with findings
# (rules.py), the paper-invariant step rules (hlo_rules.py), a Python AST
# lint for hot-path host syncs (ast_lint.py), and the audit entry point
# (audit.py / python -m repro_torch.analysis.audit).
from repro_torch.analysis.ir import (
    COLLECTIVE_KINDS,
    COMPUTE_KINDS,
    LoweredStep,
    StepOp,
    StepRecorder,
)
from repro_torch.analysis.rules import (
    RULES,
    AuditContext,
    Finding,
    Rule,
    Severity,
    register_rule,
    run_rules,
    worst_severity,
)
from repro_torch.analysis import hlo_rules  # noqa: F401  (registers the step rules)
from repro_torch.analysis.ast_lint import lint_paths, lint_source


def __getattr__(name):
    # Lazy: importing audit here would shadow `python -m
    # repro_torch.analysis.audit` (runpy re-executes the module it finds in
    # sys.modules) and audit pulls in the whole run/ stack.
    if name == "audit_spec":
        from repro_torch.analysis.audit import audit_spec
        return audit_spec
    raise AttributeError(name)

__all__ = [
    "COLLECTIVE_KINDS",
    "COMPUTE_KINDS",
    "LoweredStep",
    "StepOp",
    "StepRecorder",
    "RULES",
    "AuditContext",
    "Finding",
    "Rule",
    "Severity",
    "register_rule",
    "run_rules",
    "worst_severity",
    "lint_paths",
    "lint_source",
    "audit_spec",
]
