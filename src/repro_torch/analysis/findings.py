"""Finding/report model of the port's analysis.

A *finding* is one violated (or suspicious) invariant, located as precisely
as the check can manage: scheme findings point at the function registered
for the scheme, contract findings at ``stage_coded_matmul``.
A ``Report`` aggregates findings and derives an exit code from them.

Severity policy: ``error`` findings always fail the run; ``warning``
findings fail only under ``strict``.

A copy of the JAX package's module, so the port's findings compare with
the reference's field for field.
"""

from __future__ import annotations

import dataclasses
import json

ERROR = "error"
WARNING = "warning"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated invariant, with a file:line anchor."""

    rule: str        # e.g. "recovery-threshold", "one-launch-epilogue"
    severity: str    # ERROR | WARNING
    path: str        # repo-relative path of the anchor
    line: int        # 1-based; 0 when the finding has no single line
    message: str
    layer: str       # "schemes" | "contracts"

    def __post_init__(self):
        if self.severity not in (ERROR, WARNING):
            raise ValueError(f"severity must be error|warning, "
                             f"got {self.severity!r}")

    def location(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path

    def render(self) -> str:
        return (f"{self.location()}: [{self.layer}/{self.rule}] "
                f"{self.severity}: {self.message}")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    """All findings of one analysis run, plus what was actually checked.

    ``checked`` counts per layer (files linted, schemes validated, programs
    verified) guard against the silent-skip failure mode: a run that found
    nothing because it *checked* nothing must not read as a pass, so
    ``exit_code`` also fails when a requested layer reports zero units.
    """

    findings: list[Finding] = dataclasses.field(default_factory=list)
    checked: dict[str, int] = dataclasses.field(default_factory=dict)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    def count(self, severity: str) -> int:
        return sum(1 for f in self.findings if f.severity == severity)

    def exit_code(self, strict: bool = False) -> int:
        if self.count(ERROR):
            return 1
        if strict and self.count(WARNING):
            return 1
        if any(n == 0 for n in self.checked.values()):
            return 2  # a requested layer checked nothing: not a real pass
        return 0

    def as_dict(self) -> dict:
        return {
            "findings": [f.as_dict() for f in self.findings],
            "checked": dict(self.checked),
            "errors": self.count(ERROR),
            "warnings": self.count(WARNING),
        }

    def to_json(self, **kwargs) -> str:
        return json.dumps(self.as_dict(), indent=2, sort_keys=True, **kwargs)

    def render(self) -> str:
        lines = [f.render() for f in sorted(
            self.findings, key=lambda f: (f.layer, f.path, f.line, f.rule))]
        units = ", ".join(f"{k}={v}" for k, v in sorted(self.checked.items()))
        lines.append(f"repro_torch.analysis: {self.count(ERROR)} error(s), "
                     f"{self.count(WARNING)} warning(s) [{units}]")
        return "\n".join(lines)
