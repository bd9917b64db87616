"""Python AST lint for hot-path hazards in ``src/repro_torch/``
(counterpart of ``repro.analysis.ast_lint``).

Two hazard classes, both invisible to the step rules because they act on
the host rather than in the recorded ops:

``debug-stmt`` (everywhere): leftover ``breakpoint()`` and
``pdb.set_trace()`` — debug scaffolding that hangs a batch run at a
prompt.

``host-sync`` (hot files only): ``.item()``, ``.cpu()``, ``.numpy()`` and
``.tolist()`` with no arguments, and ``np.asarray`` / ``np.array``, inside
functions that operate on tensors in ``core/trainer.py`` or
``core/exchange.py``. On a CUDA tensor each waits for the card and copies
to the host — per step, per stage, in the paths the overlap numbers
depend on. A function operates on tensors when it names ``torch``
anything but the host-to-device conversions and dtypes
(``torch.as_tensor``, ``torch.from_numpy``, ``torch.float32``, ...): the
host-side plan building in those files (``stack_halo_plan``,
``prepare_distributed_host``, ``lift_worker_data``) turns numpy plans into
device tensors and is legitimate, as the JAX package's pure-numpy
functions are.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Sequence, Tuple

from repro_torch.analysis.rules import Finding, Severity

# Files whose tensor functions are the per-step hot path.
HOT_FILES: Tuple[str, ...] = ("core/trainer.py", "core/exchange.py")
# Tensor methods that copy to the host (called with no arguments).
_HOST_SYNC_METHODS = ("item", "cpu", "numpy", "tolist")
# numpy entry points that force a host copy when handed a CUDA tensor.
_HOST_SYNC_FUNCS = ("asarray", "array")
_NUMPY_ALIASES = ("np", "numpy", "onp")
# torch names that only move host data onto a device or name a dtype or a
# device: plan building, not tensor work.
_HOST_TORCH = frozenset({
    "as_tensor", "from_numpy", "device", "dtype", "bool", "uint8", "int8",
    "int16", "int32", "int64", "float16", "bfloat16", "float32", "float64"})


def _attr_chain(node: ast.AST) -> str:
    """Dotted name of an attribute chain ('torch.cuda.synchronize'), else ''."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _uses_tensors(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id == "torch" and node.attr not in _HOST_TORCH):
            return True
    return False


def _debug_findings(tree: ast.AST, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id == "breakpoint":
            chain = "breakpoint"
        else:
            chain = _attr_chain(node.func)
            if not chain.endswith("pdb.set_trace"):
                continue
        findings.append(Finding(
            rule="debug-stmt", severity=Severity.ERROR,
            message=f"leftover debug statement: {chain}(...)",
            location=f"{path}:{node.lineno}",
            fix_hint="remove before merging — breakpoint/set_trace hangs "
                     "batch runs"))
    return findings


def _host_sync_findings(tree: ast.AST, path: str) -> List[Finding]:
    findings: List[Finding] = []
    seen = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _uses_tensors(fn):
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            label = ""
            if not isinstance(func, ast.Attribute):
                continue
            if (func.attr in _HOST_SYNC_METHODS and not node.args
                    and not node.keywords):
                label = f".{func.attr}()"
            else:
                chain = _attr_chain(func)
                root, _, attr = chain.rpartition(".")
                if root in _NUMPY_ALIASES and attr in _HOST_SYNC_FUNCS:
                    label = f"{chain}(...)"
            if not label or node.lineno in seen:
                continue
            seen.add(node.lineno)
            findings.append(Finding(
                rule="host-sync", severity=Severity.ERROR,
                message=f"host sync {label} inside a hot-path tensor "
                        f"function ({fn.name})",
                location=f"{path}:{node.lineno}",
                fix_hint="on a CUDA tensor this waits for the card and "
                         "copies to the host every step; keep the value on "
                         "the device and numpy to host-side plan building"))
    return findings


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    """Lint one module's source. ``path`` decides hot-file status."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="debug-stmt", severity=Severity.ERROR,
                        message=f"cannot parse: {e.msg}",
                        location=f"{path}:{e.lineno or 0}")]
    findings = _debug_findings(tree, path)
    norm = path.replace("\\", "/")
    if any(norm.endswith(h) for h in HOT_FILES):
        findings.extend(_host_sync_findings(tree, path))
    return sorted(findings, key=lambda f: f.location)


def lint_paths(paths: Sequence[str] | Iterable[str]) -> List[Finding]:
    """Lint every ``.py`` under the given files/directories."""
    findings: List[Finding] = []
    for p in paths:
        root = Path(p)
        files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
        for f in files:
            findings.extend(lint_source(f.read_text(), str(f)))
    return findings
