"""Orchestrates the lochecks analyzer families over a tree — port of
``learningorchestra_tpu/analysis/runner.py``.

``run_checks(package_root)`` parses every package module once, runs
the per-module analyzers (concurrency, program hazards, cancellation)
and, with ``whole_program``, the composed lock graph, applies inline
suppressions, and returns a :class:`Report`.  The JAX runner's drift
gates and witness cross-check wait for the port's deploy manifests,
client and witnessed locks (ROADMAP A.11).
``tests/test_torch_lochecks.py`` is the tier-1 gate.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from .cancellation import analyze_cancellation
from .concurrency import analyze_concurrency
from .findings import ERROR, WARN, Finding, apply_suppressions
from .jaxlint import analyze_jax

#: rule id -> one-line description (the README catalog is generated
#: from the same table the CLI prints with --rules).
RULES = {
    "lock-order": (
        ERROR,
        "inconsistent lock-acquisition order across methods "
        "(deadlock potential)",
    ),
    "lock-self-deadlock": (
        ERROR,
        "re-acquiring a held non-reentrant threading.Lock on the "
        "same path",
    ),
    "unlocked-shared-write": (
        ERROR,
        "shared instance state written both under a lock and bare, "
        "or bare across threads",
    ),
    "jit-host-sync": (
        ERROR,
        "host-device sync construct inside a program function or a "
        "method it runs, or a jit/pjit-compiled body",
    ),
    "jit-mutable-global": (
        ERROR,
        "module-level mutable captured (frozen) at trace time inside "
        "a jitted body",
    ),
    "jit-shape-branch": (
        WARN,
        "Python branch on a traced argument's shape inside a jitted "
        "body (retraces per shape class)",
    ),
    "loop-no-cancel-check": (
        ERROR,
        "long-running loop never consults a cancel token / watchdog "
        "deadline (cooperative cancellation is the contract now)",
    ),
    "lock-order-global": (
        ERROR,
        "cross-module lock-order cycle in the composed whole-program "
        "graph (each module individually consistent)",
    ),
    "blocking-call-under-lock": (
        ERROR,
        "indefinitely-blocking call (join/wait/get/result/sleep/"
        "urlopen/subprocess without timeout) while holding a lock",
    ),
    "lock-name-mismatch": (
        ERROR,
        "concurrency_rt.make_lock name differs from the lock's "
        "static identity (witness edges would not line up)",
    ),
}


@dataclasses.dataclass
class Report:
    findings: list  # unsuppressed, sorted
    suppressed: list
    files_scanned: int
    parse_errors: list  # [(path, message)]

    @property
    def errors(self) -> list:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> list:
        return [f for f in self.findings if f.severity == WARN]

    def exit_code(self) -> int:
        return 1 if (self.errors or self.parse_errors) else 0


def _dedupe(findings: list[Finding]) -> list[Finding]:
    seen: set = set()
    out = []
    for f in findings:
        key = (f.file, f.line, f.rule, f.message)
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


def run_checks(
    package_root: str | Path,
    *,
    whole_program: bool = False,
) -> Report:
    """Run every analyzer family over ``package_root``.

    ``whole_program=True`` additionally composes the per-module lock
    models into the global graph (cross-module inversions,
    blocking-call-under-lock, make_lock name congruence).
    """
    package_root = Path(package_root)
    findings: list[Finding] = []
    texts: dict[str, str] = {}
    trees: dict[str, ast.Module] = {}
    parse_errors: list = []
    files = [
        p for p in sorted(package_root.rglob("*.py"))
        if "__pycache__" not in p.parts
    ]
    for path in files:
        text = path.read_text()
        texts[str(path)] = text
        try:
            tree = ast.parse(text)
        except SyntaxError as exc:
            parse_errors.append((str(path), str(exc)))
            continue
        trees[str(path)] = tree
        findings += analyze_concurrency(str(path), tree)
        findings += analyze_jax(str(path), tree)
        findings += analyze_cancellation(str(path), tree, text)
    if whole_program:
        from .wholeprogram import analyze_wholeprogram

        wp_findings, _ = analyze_wholeprogram(package_root, trees)
        findings += wp_findings
    kept, suppressed = apply_suppressions(_dedupe(findings), texts)
    kept.sort(key=lambda f: (f.file, f.line, f.rule))
    return Report(
        findings=kept,
        suppressed=suppressed,
        files_scanned=len(files),
        parse_errors=parse_errors,
    )
