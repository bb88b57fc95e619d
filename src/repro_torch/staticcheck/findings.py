"""Finding records and the JSON report shared by both staticcheck layers;
port of ``repro/staticcheck/findings.py``.

A finding is one rule violation, anchored to ``file:line`` for the AST
layer or to ``<ops:entrypoint>`` for op audits. The CLI (``python -m
repro_torch.staticcheck``) serializes findings into a JSON report and
exits nonzero when any exist, so CI can gate on them. The report keeps the
reference's keys, with ``jaxpr_audits`` named ``op_audits``: the port has
no jaxpr, its audits read the ATen ops a call dispatches.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

__all__ = ["Finding", "report_dict", "write_report"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation."""
    rule: str      # e.g. "R1-bvh-loop-outside-engine", "no-dense-intermediate"
    path: str      # source file, or "<ops:NAME>" for op audits
    line: int      # 1-based; 0 when the finding has no source anchor
    message: str   # human-readable explanation

    def location(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path

    def __str__(self) -> str:  # the CLI's one-line format
        return f"{self.location()}: [{self.rule}] {self.message}"


def report_dict(findings: list[Finding], *, checked_files: int = 0,
                op_audits: list[str] | None = None) -> dict:
    return {
        "ok": not findings,
        "checked_files": checked_files,
        "op_audits": op_audits or [],
        "findings": [dataclasses.asdict(f) for f in findings],
    }


def write_report(path: str | pathlib.Path, findings: list[Finding], *,
                 checked_files: int = 0,
                 op_audits: list[str] | None = None) -> None:
    pathlib.Path(path).write_text(json.dumps(
        report_dict(findings, checked_files=checked_files,
                    op_audits=op_audits), indent=2) + "\n")
