"""Cooperative-cancellation rule (error-level) — port of
``learningorchestra_tpu/analysis/cancellation.py``.

The job engine's deadline watchdog (jobs/engine.py) fails overdue jobs
and reclaims their worker slot and chip leases — but the job BODY
keeps running until it finishes on its own: Python threads cannot be
killed.  True cancellation needs the body to poll a cancel token, and
since the cancellation PR landed one (``jobs/cancel.py`` —
``cancel_requested()`` bound per dispatch, flipped by the watchdog and
the bounded shutdown drain), consulting it is the CONTRACT, not a
worklist item.

``loop-no-cancel-check`` flags long-running loop shapes inside the
job-execution and serving planes that never consult a stop/deadline
signal: ``while True:`` loops and epoch-style ``for`` loops whose body
neither touches an ``Event`` / deadline / cancel construct nor raises
out.  Error severity: the shutdown-drain hang this rule originally
named (the pre-cancellation ``JobEngine.shutdown``) is exactly what an
unchecked loop costs; suppress deliberate cases inline.
"""

from __future__ import annotations

import ast
import re

from .findings import ERROR, Finding

#: Only the planes where a runaway body holds real resources (the port
#: adds its rank program, ``parallel/rank.py``).
SCOPE_RE = re.compile(
    r"(jobs/|services/executor|train/neural|train/checkpoint"
    r"|parallel/(distributed|coordinator|rank)|serve/)"
)

#: A loop consulting any of these is cooperating.
_CANCEL_TOKENS = re.compile(
    r"deadline|cancel|stop|shutdown|closed|is_set|wait\(|expired"
    r"|_shutting_down|should_|alive",
    re.IGNORECASE,
)


def _loop_source(node: ast.AST, lines: list[str]) -> str:
    end = getattr(node, "end_lineno", node.lineno)
    return "\n".join(lines[node.lineno - 1:end])


def _is_epoch_for(node: ast.For) -> bool:
    names = {
        n.id for n in ast.walk(node.target)
        if isinstance(n, ast.Name)
    }
    return any("epoch" in name.lower() for name in names)


def analyze_cancellation(path: str, tree: ast.Module,
                         text: str) -> list[Finding]:
    if not SCOPE_RE.search(path.replace("\\", "/")):
        return []
    lines = text.splitlines()
    findings: list[Finding] = []
    for node in ast.walk(tree):
        # Only shapes that can run LONG: ``while True`` (daemon/body
        # loops) and epoch-style fits.  A bounded arithmetic while
        # (``while b < rows: b <<= 1``) is not a cancellation concern.
        unbounded = (
            isinstance(node, ast.While)
            and isinstance(node.test, ast.Constant)
            and node.test.value is True
        )
        epochish = isinstance(node, ast.For) and _is_epoch_for(node)
        if not (unbounded or epochish):
            continue
        src = _loop_source(node, lines)
        if _CANCEL_TOKENS.search(src):
            continue
        shape = (
            "while-loop" if unbounded else "epoch for-loop"
        )
        findings.append(Finding(
            path, node.lineno, "loop-no-cancel-check",
            f"{shape} never consults a cancel token / watchdog "
            "deadline — the engine can fail the job but this body "
            "runs to completion (poll jobs/cancel.py's "
            "cancel_requested() between units of work)",
            severity=ERROR,
        ))
    return findings
