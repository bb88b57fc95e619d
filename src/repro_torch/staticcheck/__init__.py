"""``repro_torch.staticcheck`` — the port's performance rules as
machine-checked gates; port of ``repro/staticcheck`` (its op audits, AST
rules, registry and CLI; the scale-safety abstract interpreter is ROADMAP
A16).

Two layers:

* **op audits** (``op_audit``): run a callable under a
  ``TorchDispatchMode`` that records every ATen op it dispatches, and
  enforce device-discipline invariants on the record —
  ``no_dense_intermediate`` (no O(n²) staging), ``no_host_transfer`` (no
  host syncs beyond an entry point's allowance, no bulk copy to the host),
  ``bounded_recompiles`` (workload sweeps stay under a shape cap).
  ``registry.REGISTERED_AUDITS`` applies them to the port's entry points;
  ``assert_no_host_transfers`` is the run-time guard the tests use (on the
  card, ``torch.cuda.set_sync_debug_mode("error")``).
* **AST lint** (``ast_lint``): the architecture rules R1, R3 and R4 over
  ``src/repro_torch`` (BVH loops only in the engine's homes, consumed CSR
  overflow flags, guarded min-image folds), with ``# staticcheck:
  <token>`` opt-out pragmas. The reference's R2 guards a JAX construct the
  port does not have.

CLI::

    PYTHONPATH=src python -m repro_torch.staticcheck            # AST lint
    PYTHONPATH=src python -m repro_torch.staticcheck --ops --fast --device cpu
    PYTHONPATH=src python -m repro_torch.staticcheck --json report.json

Exit status is nonzero iff any finding fired; the JSON report carries
``file:line`` anchors for each.
"""
from repro_torch.staticcheck.findings import Finding, report_dict, write_report
from repro_torch.staticcheck.op_audit import (
    OpTrace,
    assert_no_host_transfers,
    audit_ops,
    bounded_recompiles,
    count_compile_signatures,
    max_intermediate_elems,
    no_dense_intermediate,
    no_host_transfer,
    op_signature,
    sync_warnings,
    trace_ops,
)
from repro_torch.staticcheck.ast_lint import (
    BVH_NODE_FIELDS,
    CSR_PRODUCERS,
    RULES,
    lint_paths,
    lint_source,
)
from repro_torch.staticcheck.registry import (
    Audit,
    REGISTERED_AUDITS,
    run_registered_audits,
)

__all__ = [
    "Finding", "report_dict", "write_report",
    "OpTrace", "assert_no_host_transfers", "audit_ops", "bounded_recompiles",
    "count_compile_signatures", "max_intermediate_elems",
    "no_dense_intermediate", "no_host_transfer", "op_signature",
    "sync_warnings", "trace_ops",
    "BVH_NODE_FIELDS", "CSR_PRODUCERS", "RULES", "lint_paths", "lint_source",
    "Audit", "REGISTERED_AUDITS", "run_registered_audits",
]
