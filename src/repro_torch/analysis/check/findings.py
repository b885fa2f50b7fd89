"""Shared finding type for the spec validators (copy of
``repro.analysis.check.findings``)."""
from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class CheckFinding:
    """One spec-validation problem on one declaration."""
    rule: str           # capability | seed-collision | schedule | compile
    severity: str       # "error" | "warning"
    target: str         # scenario/sweep name (plus point, when relevant)
    message: str

    def format(self) -> str:
        return f"{self.target}: {self.severity}: {self.rule}: " \
               f"{self.message}"

    def to_dict(self) -> dict:
        return asdict(self)
