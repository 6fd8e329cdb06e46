"""Witness-vs-static cross-check — port of
``learningorchestra_tpu/analysis/witness.py``, the sanitizer gate.

The runtime lock witness (:mod:`learningorchestra_tpu_torch.concurrency_rt`,
``LO_TPU_WITNESS=1``) records the lock-acquisition orders that ACTUALLY
happened.  This module checks each witnessed edge against the static
whole-program graph (:mod:`.wholeprogram`): an observed edge the static
model lacks means the model has a FALSE NEGATIVE — an unknown lock, an
unresolved call chain, or a misnamed ``make_lock`` — and fails the
build as ``witness-unmatched-edge``.  (The reverse — static edges never
witnessed — is expected: static analysis overapproximates.)

Self-edges (``A.x -> A.x``) are exempt: identity is type-level, so two
INSTANCES of one class nesting their same-named locks witness as a
self-edge the static model cannot express (documented limit in
wholeprogram.py).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

from .findings import Finding
from .wholeprogram import GlobalLockGraph

_SITE_RE = re.compile(r"^(?P<path>.*):(?P<line>\d+)$")


def load_dump(path: str | Path) -> dict:
    """A witness snapshot JSON written via ``LO_TPU_WITNESS_DUMP``."""
    with open(path) as fh:
        return json.load(fh)


def _site(edge: dict) -> tuple:
    m = _SITE_RE.match(edge.get("site") or "")
    if m:
        return m.group("path"), int(m.group("line"))
    return "<witness>", 1


def cross_check(
    snapshot: dict, graph: GlobalLockGraph
) -> list[Finding]:
    """→ findings for witnessed edges the static model cannot
    reproduce.  ``snapshot`` is :func:`concurrency_rt.snapshot` output
    (live or :func:`load_dump`-ed)."""
    findings: list[Finding] = []
    pairs = graph.edge_pairs
    for edge in snapshot.get("edges", ()):
        a, b = edge.get("from"), edge.get("to")
        if not a or not b or a == b:
            continue
        if (a, b) in pairs:
            continue
        path, line = _site(edge)
        unknown = [n for n in (a, b) if n not in graph.names]
        if unknown:
            detail = (
                f"lock(s) {', '.join(unknown)} are not in the static "
                "model at all (unregistered construction site or "
                "misnamed make_lock)"
            )
        else:
            detail = (
                "both locks are modeled but the ordering edge is "
                "missing (unresolved call chain in the static pass)"
            )
        findings.append(Finding(
            path, line, "witness-unmatched-edge",
            f"runtime witnessed lock order {a} -> {b} "
            f"({edge.get('count', 1)}x) is absent from the static "
            f"whole-program graph — {detail}; the static model has a "
            "false negative",
        ))
    return findings
