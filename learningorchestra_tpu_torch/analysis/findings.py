"""Finding model + suppression scanning for the lochecks suite.

A copy of ``learningorchestra_tpu/analysis/findings.py``: the port imports
nothing of the JAX package.

Every analyzer emits :class:`Finding` records — file:line, a stable
rule id, a severity, and a human message.  Suppression is inline and
rule-scoped, pylint-style::

    self._hits += 1  # lo-check: disable=unlocked-shared-write

A comment on the finding line (or the line directly above it, for
lines too long to carry a trailing comment) silences exactly the
listed rules.  ``# lo-check: disable-file=<rule>`` anywhere in a file
silences a rule file-wide.  Suppressions are deliberate, reviewed
exceptions — the tier-1 gate counts only UNSUPPRESSED error findings.
"""

from __future__ import annotations

import dataclasses
import re

#: Severities.  ``error`` findings fail the CLI / tier-1 gate;
#: ``warn`` findings are reported (worklists, e.g. the cooperative-
#: cancellation rule) but never flip the exit code.
ERROR = "error"
WARN = "warn"

_DISABLE_RE = re.compile(
    r"#\s*lo-check:\s*disable=([A-Za-z0-9_,\- ]+)"
)
_DISABLE_FILE_RE = re.compile(
    r"#\s*lo-check:\s*disable-file=([A-Za-z0-9_,\- ]+)"
)


@dataclasses.dataclass(frozen=True)
class Finding:
    file: str
    line: int
    rule: str
    message: str
    severity: str = ERROR

    def render(self) -> str:
        return (
            f"{self.file}:{self.line}: [{self.rule}] "
            f"{self.severity}: {self.message}"
        )


class Suppressions:
    """Per-file index of ``# lo-check: disable=...`` comments."""

    def __init__(self, text: str):
        self.by_line: dict[int, set[str]] = {}
        self.file_wide: set[str] = set()
        for lineno, line in enumerate(text.splitlines(), start=1):
            m = _DISABLE_RE.search(line)
            if m:
                rules = {
                    tok.strip() for tok in m.group(1).split(",")
                    if tok.strip()
                }
                self.by_line.setdefault(lineno, set()).update(rules)
            m = _DISABLE_FILE_RE.search(line)
            if m:
                self.file_wide.update(
                    tok.strip() for tok in m.group(1).split(",")
                    if tok.strip()
                )

    def covers(self, rule: str, line: int) -> bool:
        if rule in self.file_wide or "all" in self.file_wide:
            return True
        for candidate in (line, line - 1):
            rules = self.by_line.get(candidate)
            if rules and (rule in rules or "all" in rules):
                return True
        return False


def apply_suppressions(
    findings: list[Finding], texts: dict[str, str]
) -> tuple[list[Finding], list[Finding]]:
    """→ (kept, suppressed).  ``texts`` maps file path → source text;
    findings in files without text (e.g. a deleted artifact) are kept."""
    kept: list[Finding] = []
    suppressed: list[Finding] = []
    cache: dict[str, Suppressions] = {}
    for f in findings:
        text = texts.get(f.file)
        if text is None:
            kept.append(f)
            continue
        sup = cache.get(f.file)
        if sup is None:
            sup = cache[f.file] = Suppressions(text)
        (suppressed if sup.covers(f.rule, f.line) else kept).append(f)
    return kept, suppressed
