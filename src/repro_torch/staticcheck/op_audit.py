"""Layer 1: op-level audits; the port's counterpart of
``repro/staticcheck/jaxpr_audit.py``.

The reference traces a callable to a jaxpr and walks every equation of
every sub-jaxpr. The port has no jaxpr: :class:`OpTrace`, a
``TorchDispatchMode`` like ``launch/op_cost.py``'s ``OpCounter``, runs
the call and records each ATen op it dispatches, with its outputs' shapes,
dtypes and devices. The port's loops are Python loops, so every iteration
is dispatched and recorded. The rules read the record:

* ``no_dense_intermediate(max_elems)`` — no op output at or above a size
  budget: the O(n²) staging regressions the reference catches at trace
  time (the dense ``(q, max_count)`` fill buffer, dense neighbor
  matrices).
* ``no_host_transfer(allowed_syncs=0)`` — the counterpart of the
  reference's callback/``device_put`` primitives: an op that makes the
  host wait for the device or moves data between them. Those are
  ``_local_scalar_dense`` (``bool``, ``int``, ``float``, ``.item()`` of a
  tensor), copies between devices, and the ops whose output size depends
  on the data (``nonzero``, ``masked_select``, the ``unique`` family,
  ``repeat_interleave`` without ``output_size``, indexing with a boolean
  mask). The reference's ``while_loop``s read their condition on the
  device; the port's loops cannot, so an entry point may make
  ``allowed_syncs`` scalar reads, a number its audit derives from its
  code's loops. A copy of more than one element to the host is never
  allowed.
* ``bounded_recompiles(cap)`` — a workload sweep hits at most ``cap``
  distinct argument signatures (the serving tier's fixed buckets).

What the mode sees. The CUDA kernels are ``ctypes`` launches, so on the
card the mode sees the torch ops around a launch and the outputs it
allocates, not the kernel. On the CPU a kernel wrapper runs the kernel's
plain version (a function of ``repro_torch.kernels`` whose name ends in
``_plain``), which stands for the launch: its ops count for sizes, but not
as host syncs, since the kernel it stands for runs without the host. In a
run on the CPU the CPU tensors stand for the card's data, so a scalar
read or a data-sized op counts as the sync it is on the card; beside a
card, CPU tensors are the host's own and their reads are not syncs. A
tensor made from host data (``torch.tensor``, ``torch.as_tensor`` of a
Python number: ``lift_fresh``) is a copy to the card only on the card,
where it waits for the copy; so is a Python number assigned into a card
tensor through an index (``x[idx] = 1``: ``index_put_`` with a 0-dim CPU
value). On the card every count is held to the card's own sync warnings
(:func:`sync_warnings`, ``chip_smoke.py`` phase 19).
"""
from __future__ import annotations

import collections
import contextlib
import os
import sys
import warnings
from typing import Callable, Iterable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.staticcheck.findings import Finding

__all__ = [
    "OpTrace",
    "SyncEvent",
    "trace_ops",
    "max_intermediate_elems",
    "no_dense_intermediate",
    "no_host_transfer",
    "audit_ops",
    "op_signature",
    "count_compile_signatures",
    "bounded_recompiles",
    "assert_no_host_transfers",
    "sync_warnings",
]

# A scalar read: the host waits for one value.
SCALAR_READS = frozenset({
    "_local_scalar_dense",
    # CUDA's kernel reads its flag back inside the op.
    "equal",
})
# Output size read from the data: the host waits for a count.
DATA_SIZED = frozenset({
    "nonzero", "masked_select", "_unique", "_unique2", "unique_dim",
    "unique_consecutive", "unique_dim_consecutive",
    # CUDA's kernel reads the largest value to size its output.
    "bincount",
})
# Indexing that takes a boolean mask runs ``nonzero`` inside the op.
MASK_INDEXED = frozenset({"index", "index_put", "index_put_",
                          "_index_put_impl_"})
# A tensor made from host data (``torch.tensor``, ``torch.as_tensor`` of
# Python numbers); on the card its data is copied from the host.
FROM_HOST = frozenset({"lift_fresh", "lift_fresh_copy"})
COPIES = frozenset({"_to_copy", "copy_"})
SYNC_WARNING = "synchronizing CUDA operation"

# Real paths, as ``_caller`` compares them with its frames' real paths (a
# checkout reached through a symlink).
_PKG = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
_KERNELS = os.path.join(_PKG, "kernels") + os.sep
_HERE = os.path.realpath(__file__)
_TORCH = os.path.dirname(os.path.realpath(torch.__file__)) + os.sep
_ROOT = os.path.dirname(os.path.dirname(_PKG))


class SyncEvent(NamedTuple):
    """One kind of host interaction at one source line."""
    kind: str    # "scalar", "size", "d2h" or "h2d"
    op: str      # the ATen op, e.g. "_local_scalar_dense", "index"
    where: str   # "src/repro_torch/core/bvh.py:75" (innermost port frame)
    sync: bool   # whether the host waits (a non-blocking copy does not)
    elems: int   # elements moved (1 for a scalar read or a count)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _has_mask(indices) -> bool:
    return any(t is not None and t.dtype in (torch.bool, torch.uint8)
               for t in (indices or ()))


def _on_host(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type == "cpu"


def _classify(name: str, overload: str, args, kwargs, out,
              host_data: bool) -> list[tuple[str, bool, int]]:
    """The host interactions of one op, each ``(kind, sync, elems)``. A
    read of a CPU tensor counts only where ``host_data`` (a run on the CPU,
    which stands for the card); a copy, only where it crosses devices."""
    if name in FROM_HOST:
        return [] if _on_host(out) else [("h2d", True, out.numel())]
    if name in COPIES:
        if name == "_to_copy":
            src, dst = args[0], out
            blocking = not kwargs.get("non_blocking", False)
        else:
            dst, src = args[0], args[1]
            blocking = not (args[2] if len(args) > 2
                            else kwargs.get("non_blocking", False))
        if src.device.type == dst.device.type:
            return []
        kind = "d2h" if dst.device.type == "cpu" else "h2d"
        return [(kind, blocking, src.numel())]
    if not (name in SCALAR_READS or name in DATA_SIZED or name in MASK_INDEXED
            or name == "repeat_interleave"):
        return []
    if _on_host(args[0]):
        return [] if not host_data else _reads(name, overload, args, kwargs)
    got = _reads(name, overload, args, kwargs)
    # An indexed assignment of a Python number to a tensor on the card
    # (``x[idx] = 1``) hands the op the number as a 0-dim CPU tensor, which
    # the op copies to the card and waits for.
    if name in MASK_INDEXED and name != "index":
        values = args[2] if len(args) > 2 else kwargs.get("values")
        if isinstance(values, torch.Tensor) and values.dim() == 0 \
                and _on_host(values):
            got.append(("h2d", True, 1))
    return got


def _reads(name: str, overload: str, args, kwargs) -> list:
    if name in SCALAR_READS:
        return [("scalar", True, 1)]
    if name in DATA_SIZED:
        return [("size", True, 1)]
    if name == "repeat_interleave" and overload != "self_int" \
            and kwargs.get("output_size") is None:
        return [("size", True, 1)]
    if name in MASK_INDEXED and _has_mask(args[1] if len(args) > 1
                                          else kwargs.get("indices")):
        return [("size", True, 1)]
    return []


_files: dict = {}


def _paths(filename: str) -> tuple[str, str]:
    """A code object's file: its real path, and that path relative to the
    checkout."""
    got = _files.get(filename)
    if got is None:
        real = os.path.realpath(filename)
        got = _files[filename] = (real, os.path.relpath(real, _ROOT))
    return got


def _caller() -> tuple[bool, str]:
    """Whether the op runs inside a kernel's plain version, and where it
    was called from: the innermost frame of the port (this module aside),
    else the innermost frame outside torch."""
    f = sys._getframe(2)
    where = outside = None
    while f is not None:
        path, rel = _paths(f.f_code.co_filename)
        if path.startswith(_KERNELS) and f.f_code.co_name.endswith("_plain"):
            return True, where or outside or "?"
        if path != _HERE:
            if where is None and path.startswith(_PKG):
                where = f"{rel}:{f.f_lineno}"
            if outside is None and not path.startswith(_TORCH):
                outside = f"{rel}:{f.f_lineno}"
        f = f.f_back
    return False, where or outside or "?"


class OpTrace(TorchDispatchMode):
    """Records what the ops dispatched inside it do: the largest output (in
    elements) and the op that made it, every host interaction by kind, op
    and source line, and, with ``record_ops``, the sequence of ``(op,
    outputs)`` signatures. ``host_data``: whether CPU tensors hold the
    pipeline's data (a run on the CPU) rather than host bookkeeping beside
    a card. ``warnings_log`` (a list that
    ``warnings.catch_warnings(record=True)`` fills) lets the trace pin each
    of the card's sync warnings to the op it came after."""

    def __init__(self, *, host_data: bool = True, record_ops: bool = False,
                 warnings_log=None):
        super().__init__()
        self.host_data = host_data
        self.ops: list | None = [] if record_ops else None
        self.n_ops = 0
        self.max_elems = 0
        self.max_op = ""
        self.events: collections.Counter = collections.Counter()
        self.warned: collections.Counter = collections.Counter()
        self.result = None
        self._log = warnings_log
        self._seen = 0
        self._last = None

    def _pin_warnings(self) -> None:
        if self._log is None:
            return
        new = sum(SYNC_WARNING in str(w.message) for w in self._log[self._seen:])
        self._seen = len(self._log)
        if new:
            self.warned[self._last] += new

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._pin_warnings()
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        self.n_ops += 1
        outs = list(_tensors(out))
        if self.ops is not None:
            self.ops.append((str(func), tuple(
                (str(t.dtype).removeprefix("torch."), tuple(t.shape))
                for t in outs)))
        got = _classify(name, func._overloadname, args, kwargs,
                        outs[0] if outs else None, self.host_data)
        for t in outs:
            if t.numel() > self.max_elems:
                self.max_elems, self.max_op = t.numel(), str(func)
        self._last = (name, "")
        if got or self._log is not None:
            plain, where = _caller()
            self._last = (name, where)
            if not plain:
                for kind, sync, elems in got:
                    self.events[SyncEvent(kind, name, where, sync, elems)] += 1
        return out

    def __exit__(self, *exc):
        self._pin_warnings()
        return super().__exit__(*exc)

    def syncs(self) -> collections.Counter:
        """Host syncs by op."""
        out: collections.Counter = collections.Counter()
        for ev, k in self.events.items():
            if ev.sync:
                out[ev.op] += k
        return out

    def syncs_by_line(self) -> collections.Counter:
        """Host syncs by ``(op, source line)``."""
        out: collections.Counter = collections.Counter()
        for ev, k in self.events.items():
            if ev.sync:
                out[(ev.op, ev.where)] += k
        return out

    def n_syncs(self) -> int:
        return sum(self.syncs().values())


def trace_ops(fn, args=(), *, record_ops: bool = False) -> OpTrace:
    """``fn(*args)`` run under an :class:`OpTrace`; the trace keeps the
    result in ``.result``."""
    with OpTrace(host_data=not _on_card(args), record_ops=record_ops) as trace:
        trace.result = fn(*args)
    return trace


def max_intermediate_elems(fn, args=()) -> int:
    """Largest op output (elements) of ``fn(*args)``: the quantity
    ``no_dense_intermediate`` budgets."""
    return trace_ops(fn, args).max_elems


def no_dense_intermediate(max_elems: int) -> Callable:
    """Rule: every op output must stay strictly under ``max_elems``.

    Pick the budget as the size of the dense object the pipeline is NOT
    allowed to stage, e.g. ``q * max_count`` for CSR fills, ``n * n`` for
    neighbor pipelines."""
    budget = int(max_elems)

    def rule(trace: OpTrace, name: str) -> list[Finding]:
        if trace.max_elems >= budget:
            return [Finding(
                rule="no-dense-intermediate", path=f"<ops:{name}>", line=0,
                message=(f"intermediate of {trace.max_elems} elems >= budget "
                         f"{budget} (op {trace.max_op!r}): the pipeline is "
                         f"staging a dense buffer"))]
        return []

    return rule


def no_host_transfer(allowed_syncs=0) -> Callable:
    """Rule: at most ``allowed_syncs`` host syncs (an int, or a function of
    the call's result for a count that grows with the rounds it returns),
    and no copy of more than one element to the host. Each finding names
    an op, how many times it ran and its first source line."""

    def rule(trace: OpTrace, name: str) -> list[Finding]:
        allowed = allowed_syncs(trace.result) if callable(allowed_syncs) \
            else int(allowed_syncs)
        path = f"<ops:{name}>"
        findings = []
        for ev, k in sorted(trace.events.items()):
            if ev.kind == "d2h" and ev.elems > 1:
                findings.append(Finding(
                    rule="no-host-transfer", path=path, line=0,
                    message=(f"copy of {ev.elems} elements to the host "
                             f"({ev.op!r}, {k}x at {ev.where}) inside a "
                             f"device pipeline")))
        syncs = trace.syncs()
        total = sum(syncs.values())
        if total > allowed:
            first: dict = {}
            for ev in trace.events:
                if ev.sync:
                    first.setdefault(ev.op, ev.where)
            for op, k in sorted(syncs.items()):
                findings.append(Finding(
                    rule="no-host-transfer", path=path, line=0,
                    message=(f"host sync {op!r} ran {k} times (first at "
                             f"{first[op]}): {total} syncs in all, "
                             f"{allowed} allowed")))
        return findings

    return rule


def audit_ops(fn, args, rules: Iterable[Callable], *,
              name: str | None = None) -> list[Finding]:
    """Run ``fn(*args)`` under an :class:`OpTrace` and apply each rule to
    the trace. Returns the concatenated findings ([] == the invariants
    hold)."""
    name = name or getattr(fn, "__name__", "fn")
    trace = trace_ops(fn, args)
    findings: list[Finding] = []
    for rule in rules:
        findings.extend(rule(trace, name))
    return findings


def op_signature(fn, args=()) -> tuple:
    """The sequence of ``(op, outputs' dtypes and shapes)`` that
    ``fn(*args)`` dispatches, in order. Two calls with equal signatures run
    the same ops on the same shapes and dtypes: the equality the
    ``stats_path_identity`` audit holds the engine's ``with_stats=False``
    path to."""
    return tuple(trace_ops(fn, args, record_ops=True).ops)


# --- recompile budget (a workload sweep) ------------------------------------

def _leaves(x):
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    else:
        yield x


def _signature(args) -> tuple:
    return tuple((tuple(x.shape), str(x.dtype)) if isinstance(x, torch.Tensor)
                 else ((), type(x).__name__) for x in _leaves(args))


def count_compile_signatures(sweep: Iterable[tuple]) -> int:
    """Number of DISTINCT (shape, dtype) signatures across a sweep of
    argument tuples: the shapes a fixed-bucket server must hold ready."""
    return len({_signature(args) for args in sweep})


def bounded_recompiles(fn, sweep: Iterable[tuple], cap: int, *,
                       name: str | None = None,
                       check_trace: bool = True) -> list[Finding]:
    """Rule: running ``fn`` over every argument tuple in ``sweep`` must hit
    at most ``cap`` distinct signatures (the fixed-bucket serving premise).

    With ``check_trace`` each distinct signature is also run once, so a
    sweep that would fail is caught here too."""
    name = name or getattr(fn, "__name__", "fn")
    sweep = list(sweep)
    seen: dict[tuple, tuple] = {}
    for args in sweep:
        seen.setdefault(_signature(args), args)
    if check_trace:
        for args in seen.values():
            fn(*args)
    if len(seen) > cap:
        return [Finding(
            rule="bounded-recompiles", path=f"<ops:{name}>", line=0,
            message=(f"{len(seen)} distinct shapes over a {len(sweep)}-point "
                     f"sweep exceeds the cap of {cap}: bucket the workload to "
                     f"fixed shapes"))]
    return []


# --- run-time guards ----------------------------------------------------------

def _on_card(args) -> bool:
    return any(t.is_cuda for t in _tensors(args))


@contextlib.contextmanager
def _sync_debug(mode: str):
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def assert_no_host_transfers(fn, *args, guard: str = "all", warmup: bool = True):
    """Run ``fn(*args)`` with host transfers refused and return its result:
    the port's "zero host round-trips after warm-up" assertion.

    On the card (any CUDA tensor among ``args``) the call runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so any synchronizing call
    raises; with ``guard="all"`` a host-to-device copy the mode sees
    (a non-blocking one too) raises as well. The card's guard cannot tell a
    host-to-device copy that waits from a read, so ``guard="d2h"`` refuses
    both there. On the CPU the trace's rule applies: ``"all"`` refuses
    every host interaction of :func:`no_host_transfer`, ``"d2h"`` all but
    host-to-device copies. With ``warmup`` a first call (which may build
    and load kernels) runs outside the guard."""
    if guard not in ("all", "d2h"):
        raise ValueError(f"guard must be 'all' or 'd2h', got {guard!r}")
    if warmup:
        fn(*args)
    kinds = ("scalar", "size", "d2h") if guard == "d2h" else \
        ("scalar", "size", "d2h", "h2d")
    if _on_card(args):
        with _sync_debug("error"), OpTrace(host_data=False) as trace:
            out = fn(*args)
        torch.cuda.synchronize()
        if guard == "all":
            kinds = ("h2d",)
        bad = [ev for ev in trace.events if ev.kind in kinds]
    else:
        with OpTrace() as trace:
            out = fn(*args)
        bad = [ev for ev in trace.events if ev.kind in kinds]
    if bad:
        raise RuntimeError("host transfer inside a guarded call: " + "; ".join(
            f"{ev.kind} {ev.op!r} x{trace.events[ev]} at {ev.where}"
            for ev in sorted(bad)))
    return out


def sync_warnings(fn, *args) -> dict:
    """On the card: ``fn(*args)`` once under an :class:`OpTrace` with
    ``torch.cuda.set_sync_debug_mode("warn")``. Returns the syncs the
    trace counted, the card's sync warnings, and each op (with its source
    line) whose counts differ. A warning is pinned to the op it came after
    (one before the first op to ``None``): a sync no ATen op carries, such
    as ``torch.cuda.synchronize``, shows as a warning its op did not
    count."""
    with warnings.catch_warnings(record=True) as log:
        warnings.simplefilter("always")
        with _sync_debug("warn"), \
                OpTrace(host_data=False, warnings_log=log) as trace:
            trace.result = fn(*args)
    counted = trace.syncs_by_line()
    warned = trace.warned
    differ = {key: (counted.get(key, 0), warned.get(key, 0))
              for key in set(counted) | set(warned)
              if counted.get(key, 0) != warned.get(key, 0)}
    return {"counted": sum(counted.values()), "warned": sum(warned.values()),
            "differ": differ, "trace": trace}
