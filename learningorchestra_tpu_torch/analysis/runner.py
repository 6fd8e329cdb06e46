"""Orchestrates the lochecks analyzer families over a tree — port of
``learningorchestra_tpu/analysis/runner.py``.

``run_checks(package_root)`` parses every package module once, runs
the per-module analyzers (concurrency, program hazards, cancellation),
the cross-artifact drift gates and, with ``whole_program``, the composed
lock graph (with ``witness_dump``, a runtime witness snapshot checked
against it), applies inline suppressions, and returns a
:class:`Report`.  ``tests/test_torch_lochecks.py`` is the tier-1 gate.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

from .cancellation import analyze_cancellation
from .concurrency import analyze_concurrency
from .drift import DriftPaths, analyze_drift
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
    "witness-unmatched-edge": (
        ERROR,
        "runtime-witnessed lock order missing from the static "
        "whole-program graph (static false negative)",
    ),
    "knob-missing-config": (
        ERROR, "LO_TPU_* knob absent from config.py",
    ),
    "knob-missing-compose": (
        ERROR, "LO_TPU_* knob absent from deploy/torch/docker-compose.yml",
    ),
    "knob-missing-k8s": (
        ERROR, "LO_TPU_* knob absent from deploy/torch/k8s.yaml",
    ),
    "knob-missing-readme": (
        ERROR, "LO_TPU_* knob absent from the README's port section",
    ),
    "knob-unknown": (
        ERROR, "manifest/README knob that no code reads",
    ),
    "fault-point-unknown": (
        ERROR, "fault-point name faults/plane.py never registers",
    ),
    "route-missing-client": (
        ERROR, "REST route without a client.py binding",
    ),
    "route-gate-missing": (
        ERROR, "the every-route-metered test gate is gone",
    ),
    "metric-unregistered": (
        ERROR, "metric family used in tests/README but never "
        "registered",
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
    repo_root: str | Path | None = None,
    drift: bool = True,
    whole_program: bool = False,
    witness_dump: str | Path | None = None,
) -> Report:
    """Run every analyzer family over ``package_root``.

    ``repo_root`` locates the cross-artifact surfaces (deploy
    manifests, README, tests); default: the package root's parent.
    ``drift=False`` runs only the per-module analyzers — what the
    golden tests use on synthetic fixture trees.
    ``whole_program=True`` additionally composes the per-module lock
    models into the global graph (cross-module inversions,
    blocking-call-under-lock, make_lock name congruence), and
    ``witness_dump`` cross-checks a runtime witness snapshot
    (``LO_TPU_WITNESS_DUMP`` JSON) against that graph.
    """
    package_root = Path(package_root)
    repo_root = Path(
        repo_root if repo_root is not None else package_root.parent
    )
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

        wp_findings, graph = analyze_wholeprogram(package_root, trees)
        findings += wp_findings
        if witness_dump is not None:
            from .witness import cross_check, load_dump

            findings += cross_check(load_dump(witness_dump), graph)
    if drift:
        drift_findings = analyze_drift(DriftPaths.for_repo(repo_root))
        for f in drift_findings:
            if f.file not in texts:
                try:
                    texts[f.file] = Path(f.file).read_text()
                except OSError:
                    pass
        findings += drift_findings
    kept, suppressed = apply_suppressions(_dedupe(findings), texts)
    kept.sort(key=lambda f: (f.file, f.line, f.rule))
    return Report(
        findings=kept,
        suppressed=suppressed,
        files_scanned=len(files),
        parse_errors=parse_errors,
    )
