"""CLI: ``python -m repro_torch.staticcheck [paths...] [--ops] [--fast]
[--device cpu|cuda] [--json REPORT] [--rules R1,R3]``; port of
``python -m repro.staticcheck``.

Runs the AST lint over the given paths (default: the ``repro_torch``
package source, i.e. ``src/repro_torch``) and, with ``--ops``, the
registered op audits on ``--device`` (default: the CUDA card). Prints one
``file:line: [rule] message`` line per finding, writes the JSON report,
and exits nonzero iff any finding fired: the CI gate.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import repro_torch
from repro_torch.staticcheck.ast_lint import RULES, lint_paths
from repro_torch.staticcheck.findings import write_report


def _default_root() -> str:
    return str(pathlib.Path(repro_torch.__file__).resolve().parent)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.staticcheck")
    ap.add_argument("paths", nargs="*",
                    help="files/directories to lint (default: src/repro_torch)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated AST rule subset, e.g. R1,R3")
    ap.add_argument("--ops", action="store_true",
                    help="also run the registered op audits (runs the port's "
                         "device pipelines)")
    ap.add_argument("--fast", action="store_true",
                    help="smaller problem sizes for the op audits")
    ap.add_argument("--device", default=None,
                    help="device of the op audits (default: the CUDA card)")
    ap.add_argument("--json", default="staticcheck_report.json",
                    help="JSON report path (default: %(default)s)")
    args = ap.parse_args(argv)

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in RULES]
        if unknown:
            ap.error(f"unknown rules {unknown}; available: {sorted(RULES)}")

    paths = args.paths or [_default_root()]
    findings, checked = lint_paths(paths, rules=rules)

    audit_names: list[str] = []
    if args.ops:
        from repro_torch.staticcheck.registry import run_registered_audits
        of, audit_names = run_registered_audits(fast=args.fast,
                                                device=args.device)
        findings = findings + of

    for f in findings:
        print(f)
    write_report(args.json, findings, checked_files=checked,
                 op_audits=audit_names)
    summary = f"staticcheck: {len(findings)} finding(s) over {checked} file(s)"
    if audit_names:
        summary += f" + {len(audit_names)} op audit(s)"
    print(summary + f"; report -> {args.json}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
