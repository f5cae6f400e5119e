"""Structured analysis findings, as the JAX package's
``analysis/findings.py`` records them: a 406 carries them in its body
and an accepted job stores them on its metadata under ``analysis``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"


@dataclass(frozen=True)
class Finding:
    """One observation: ``severity`` ``"error"`` (blocks the request) or
    ``"warning"``, a stable kebab-case ``rule`` id, a ``location``
    (``"line L:C"`` in code, a parameter path, or ``""``) and a
    ``message``."""

    severity: str
    rule: str
    location: str
    message: str

    def to_dict(self) -> Dict[str, str]:
        return {"severity": self.severity, "rule": self.rule,
                "location": self.location, "message": self.message}


def error_findings(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == SEVERITY_ERROR]


def warning_findings(findings: Iterable[Finding]) -> List[Finding]:
    return [f for f in findings if f.severity == SEVERITY_WARNING]


def findings_to_dicts(findings: Iterable[Finding]) -> List[Dict[str, str]]:
    return [f.to_dict() for f in findings]


class LintRejected(Exception):
    """Error-severity findings; carries every finding so one 406 body can
    hold them all."""

    def __init__(self, findings: List[Finding], summary: str = ""):
        self.findings = list(findings)
        errs = error_findings(self.findings)
        head = summary or (errs[0].message if errs
                           else "analysis rejected the request")
        if len(errs) > 1:
            head = f"{head} (+{len(errs) - 1} more finding(s))"
        super().__init__(head)
        self.summary = head
