"""``simlint: allow[rule] — reason`` comment-pragma parsing/validation.

A pragma suppresses named rules for its own line; placed on a ``def`` or
``class`` header line it suppresses them for the whole scope.  The reason
string is mandatory — an allowance without a justification is itself a
finding — and the repo-wide pragma count is budgeted (``max_pragmas`` in
the manifest) so suppressions stay an audited exception, not an exit.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from repro_torch.analysis.report import RULES, Finding

__all__ = ["Pragma", "scan_pragmas"]

# hash sign, then "simlint: allow[rule-a,rule-b] — reason" ("--"/":" ok too)
_PRAGMA_RE = re.compile(
    r"#\s*simlint:\s*allow\[([^\]]*)\]\s*(?:(?:—|--|:)\s*)?(.*)$")
_MARKER_RE = re.compile(r"#\s*simlint\b")


@dataclass
class Pragma:
    line: int
    rules: tuple[str, ...]
    reason: str
    used: bool = field(default=False, compare=False)

    def covers(self, rule: str) -> bool:
        return rule in self.rules


def scan_pragmas(path: str, source: str) -> tuple[dict[int, Pragma],
                                                  list[Finding]]:
    """Extract pragmas per line; malformed ones become findings.

    Returns ``({lineno: Pragma}, findings)``.  Anything that *looks* like a
    simlint marker but does not parse — or names an unknown rule, or lacks
    a reason — is reported under the ``pragma`` rule rather than silently
    ignored: a typo'd suppression must never masquerade as a clean file.
    """
    pragmas: dict[int, Pragma] = {}
    findings: list[Finding] = []
    for lineno, text in enumerate(source.splitlines(), start=1):
        if not _MARKER_RE.search(text):
            continue
        m = _PRAGMA_RE.search(text)
        if m is None:
            findings.append(Finding(
                path, lineno, "pragma",
                "malformed simlint pragma; expected a comment of the form "
                "'simlint: allow[rule] — reason'"))
            continue
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        reason = m.group(2).strip()
        bad = [r for r in rules if r not in RULES]
        if not rules or bad:
            findings.append(Finding(
                path, lineno, "pragma",
                f"pragma names unknown rule(s) {bad or '[]'}; known: "
                f"{', '.join(sorted(RULES))}"))
            continue
        if not reason:
            findings.append(Finding(
                path, lineno, "pragma",
                "pragma reason is empty — every allowance must carry a "
                "justification string"))
            continue
        pragmas[lineno] = Pragma(lineno, rules, reason)
    return pragmas, findings
