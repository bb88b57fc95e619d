"""``repro_torch.staticcheck`` — the port's performance rules as
machine-checked gates; port of ``repro/staticcheck`` (its op audits, AST
rules, scale-safety abstract interpreter, registries and CLI).

Three layers:

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
* **scale-safety abstract interpreter** (``absint``, over the interval
  lattice of ``lattice``): records the ATen ops of one run as data flow,
  propagates a value interval per tensor through them and re-reads the
  staged small sizes as symbolic exascale N — proving the W rules below
  without ever materializing a large tensor.

  ====  =================  ==================================================
  rule  name               fires when (at symbolic N)
  ====  =================  ==================================================
  W1    index-width        a signed-int result escapes its dtype (int32
                           ``counts→cumsum→offsets`` past 2^31 total hits;
                           ``shard*n_local+i`` global ids; narrowing
                           converts). Unsigned arithmetic and masked left
                           shifts wrap silently.
  W2    precision          a float quantization (round/floor/ceil/trunc/f→i
                           convert) sees magnitude ≥ 2^mantissa — the
                           ``round(BIG/L)*L == BIG`` min-image trap; with
                           ``precision_floor``, catastrophic cancellation.
  W3    bounds & routes    an index of ``index``/``index_put_`` outside
                           [-S, S-1], or of ``gather``/``index_select``/
                           ``take``/``scatter*`` outside [0, S-1], not ruled
                           out; ``ppermute`` tables that are not partial
                           permutations.
  ====  =================  ==================================================

  ``absint_registry.REGISTERED_ABSINT_AUDITS`` pins the production
  (int64-widened) configurations clean; ``SEEDED_FIXTURES`` pins each
  rule firing on the trap it encodes.

CLI::

    PYTHONPATH=src python -m repro_torch.staticcheck            # AST lint
    PYTHONPATH=src python -m repro_torch.staticcheck --ops --fast --device cpu
    PYTHONPATH=src python -m repro_torch.staticcheck --absint --fast --device cpu
    PYTHONPATH=src python -m repro_torch.staticcheck --json report.json

Exit status is nonzero iff any finding fired; the JSON report carries
``file:line`` anchors for each (``--absint`` also writes
``absint_report.json`` with per-entrypoint coverage counters).
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
from repro_torch.staticcheck.absint import (
    AbsintReport,
    AbsTrace,
    CollectiveUse,
    SymbolicScale,
    analyze,
    analyze_trace,
    audit_routes,
    scale_for,
)
from repro_torch.staticcheck.absint_registry import (
    AbsintAudit,
    REGISTERED_ABSINT_AUDITS,
    SEEDED_FIXTURES,
    absint_coverage,
    run_absint_audits,
)

__all__ = [
    "Finding", "report_dict", "write_report",
    "OpTrace", "assert_no_host_transfers", "audit_ops", "bounded_recompiles",
    "count_compile_signatures", "max_intermediate_elems",
    "no_dense_intermediate", "no_host_transfer", "op_signature",
    "sync_warnings", "trace_ops",
    "BVH_NODE_FIELDS", "CSR_PRODUCERS", "RULES", "lint_paths", "lint_source",
    "Audit", "REGISTERED_AUDITS", "run_registered_audits",
    "AbsintReport", "AbsTrace", "CollectiveUse", "SymbolicScale", "analyze",
    "analyze_trace", "audit_routes", "scale_for",
    "AbsintAudit", "REGISTERED_ABSINT_AUDITS", "SEEDED_FIXTURES",
    "absint_coverage", "run_absint_audits",
]
