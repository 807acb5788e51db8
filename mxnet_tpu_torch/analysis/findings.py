"""Finding/Report datatypes of ``mxnet_tpu_torch.analysis`` (counterpart of
``mxnet_tpu/analysis/findings.py``, copied).

Every analyzer emits the same structured ``Finding`` so that its users
can filter by severity and rule and render uniformly. The training-health
plane's blame pass (``obs/health.py``) anchors its NaN provenance to a
graph node with one; the linters of ``analysis/`` report the rest.
"""
from __future__ import annotations

import json as _json
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional

from ..base import GraphAnalysisError  # noqa: F401  (canonical re-export)

__all__ = ["Severity", "Finding", "Report", "GraphAnalysisError"]


class Severity:
    """Severity levels, ordered. Plain strings so findings json-serialize."""

    ERROR = "error"      # graph will crash or silently compute the wrong thing
    WARNING = "warning"  # very likely a bug or a serious perf hazard
    INFO = "info"        # worth knowing; often intentional

    ORDER = (ERROR, WARNING, INFO)

    @classmethod
    def rank(cls, sev: str) -> int:
        try:
            return cls.ORDER.index(sev)
        except ValueError:
            return len(cls.ORDER)


@dataclass
class Finding:
    """One lint result.

    ``node`` is the graph-node (or parameter/file) the finding is anchored
    to; ``fix_hint`` is a one-line actionable suggestion.
    """

    rule_id: str
    severity: str
    message: str
    node: Optional[str] = None
    op: Optional[str] = None
    fix_hint: Optional[str] = None
    location: Optional[str] = None  # file:line for source-level linters
    details: dict = field(default_factory=dict)

    def format(self) -> str:
        where = self.node or self.location or ""
        head = f"[{self.severity}] {self.rule_id}"
        if where:
            head += f" @ {where}"
        if self.op:
            head += f" ({self.op})"
        out = f"{head}: {self.message}"
        if self.fix_hint:
            out += f"\n    hint: {self.fix_hint}"
        return out

    def to_dict(self) -> dict:
        d = {"rule_id": self.rule_id, "severity": self.severity,
             "message": self.message}
        for k in ("node", "op", "fix_hint", "location"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.details:
            d["details"] = self.details
        return d


class Report:
    """Ordered collection of findings with severity helpers."""

    def __init__(self, findings: Optional[Iterable[Finding]] = None):
        self.findings: List[Finding] = list(findings or [])

    # -- collection protocol -------------------------------------------
    def add(self, finding: Finding) -> "Report":
        self.findings.append(finding)
        return self

    def extend(self, findings: Iterable[Finding]) -> "Report":
        self.findings.extend(findings)
        return self

    def __iter__(self) -> Iterator[Finding]:
        return iter(self.findings)

    def __len__(self) -> int:
        return len(self.findings)

    def __bool__(self) -> bool:
        return bool(self.findings)

    # -- filtering ------------------------------------------------------
    def by_severity(self, severity: str) -> "Report":
        return Report(f for f in self.findings if f.severity == severity)

    def by_rule(self, rule_id: str) -> "Report":
        return Report(f for f in self.findings if f.rule_id == rule_id)

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == Severity.WARNING]

    @property
    def has_errors(self) -> bool:
        return any(f.severity == Severity.ERROR for f in self.findings)

    # -- rendering ------------------------------------------------------
    def sorted(self) -> "Report":
        return Report(sorted(self.findings,
                             key=lambda f: Severity.rank(f.severity)))

    def summary(self) -> str:
        n_err = len(self.errors)
        n_warn = len(self.warnings)
        n_info = len(self.findings) - n_err - n_warn
        return f"{n_err} error(s), {n_warn} warning(s), {n_info} info"

    def format(self) -> str:
        if not self.findings:
            return "clean: no findings"
        lines = [f.format() for f in self.sorted()]
        lines.append(self.summary())
        return "\n".join(lines)

    def to_json(self) -> str:
        return _json.dumps({"findings": [f.to_dict() for f in self.findings],
                            "summary": self.summary()}, indent=2)

    def raise_if_errors(self) -> "Report":
        """Raise :class:`GraphAnalysisError` if any error-severity finding."""
        errs = self.errors
        if errs:
            first = errs[0]
            msg = "\n".join(f.format() for f in errs)
            raise GraphAnalysisError(
                f"graph lint failed with {len(errs)} error(s):\n{msg}",
                node=first.node, op=first.op, rule_id=first.rule_id,
                findings=errs)
        return self

    def __repr__(self):
        return f"<Report {self.summary()}>"
