"""Scale-safety abstract interpreter over the ATen ops of a call; port of
``repro/staticcheck/absint.py``.

``repro_torch.staticcheck``'s third layer: where the op audits gate program
STRUCTURE and the AST lint gates source idioms, this layer gates program
VALUES. It runs a call once under a ``TorchDispatchMode`` that records the
ATen ops it dispatches (which tensor feeds which op, the scalar arguments,
the outputs' dtypes and shapes, in-place writes and views), then walks the
record propagating an interval per tensor (``lattice.Ival``), and asks
whether the program still holds together when the staged small shapes are
re-read as **symbolic exascale sizes** (N=1e9 points, 64 shards).

Rule families
-------------

* **W1 index-width** — a *signed* integer op whose output interval escapes
  its dtype at symbolic N (int32 ``counts → cumsum → offsets`` CSR
  overflow, ``shard * n_local + i`` global-id overflow, narrowing
  ``_to_copy`` truncation). Unsigned arithmetic *wraps* (two's-complement),
  so deliberate wraparound stays silent; a finding fires only at the first
  op whose inputs were still representable.
* **W2 precision** — a float quantization (``round`` / ``floor`` /
  ``ceil`` / ``trunc`` / float→int ``_to_copy``) whose operand magnitude
  reaches 2^mantissa (2^24 f32): the ulp spacing exceeds 1 and integer
  rounding is meaningless — the machine-derived form of the
  ``round(BIG/L)*L == BIG`` min-image trap. With ``precision_floor`` set, a
  subtraction of overlapping large-magnitude intervals (catastrophic
  cancellation) also fires when the ulp at the operands exceeds the floor.
* **W3 bounds & routes** — an ``index``, ``index_select``, ``gather``,
  ``take``, ``index_put_`` or ``scatter*`` whose index interval is not
  provably inside the (symbolic) indexed axis. Torch has no clip or fill
  mode: an index out of range is an error on the CPU and a device assert
  on the card. Advanced indexing (``index``, ``index_put_``) wraps
  negative indices, so its range is ``[-S, S-1]``; the others take
  ``[0, S-1]``. Plus the collective-route audit: ``ppermute`` route tables
  must be partial permutations (unique sources, unique destinations, ids
  within the mesh axis). The reference also checks that a collective
  names an axis of the enclosing mesh; the port's collectives are methods
  of the axis handle, so that cannot fail.

Symbolic sizes: stage the program at small *marker* sizes (e.g. n=254),
then analyze under ``SymbolicScale(dims={254: 10**9}, axes={"data": 64})``
— every shape dimension and every integer scalar argument equal to a
marker is re-read at the symbolic size, so ``arange``/``cumsum``/``sum``
and shard-index bounds reflect the exascale run. ``scale_for(n, N)``
builds the marker family {n, n±1, 2n-1, 2n-2} for BVH-shaped programs.

Where the values come from. Intervals come from the transfer functions,
never from the staged data: a run at n = 254 must not "prove" a bound that
holds only at 254. The only concrete values read are those of tensors made
from host constants (``lift_fresh``, the fill of ``full`` and friends, the
ends of ``arange``), as the reference reads its literals and closed-over
constants. Tensors a call receives take their ``input_ivals``, or the
dtype's full range with ``known=False``.

What the trace cannot see, and how it is modelled (``repro_torch.opaque``):

* a kernel wrapper's ops are skipped, on the card (a ``ctypes`` launch and
  its output buffers) and on the CPU (the plain version) alike; its outputs
  take their dtype's full range, ``known=False``, as the reference models a
  ``pallas_call``. They are counted as ``kernel_outputs``, apart from
  unknown ops;
* a ``ShardAxis`` collective acts on the staged shards; it is modelled at
  the symbolic axis size as the reference models its collectives (``psum``
  scales by the symbolic shard count, ``ppermute`` joins with 0) and
  recorded as a :class:`CollectiveUse`; ``ShardAxis.index_tensor`` lies in
  ``[0, axis_size - 1]``.

Deliberate differences from the reference. The port's loops are Python
loops: the trace holds every iteration the staged run took, so there is
no ``scan``/``while`` to widen, and an accumulator over a Python loop
whose trip count grows with N is not extrapolated (the reference's linear
widening of ``scan`` carries has no counterpart). A value that the code
takes back to the host (``int(t)``) and feeds to a later op is a literal
there, as in the reference.

Soundness posture: unmodelled ops and kernel outputs degrade to
``known=False`` fallbacks that never fire findings — false negatives are
possible, false positives are what the rules are built to avoid.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
from typing import Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakTensorKeyDictionary

from repro_torch import opaque
from repro_torch.staticcheck import lattice as lat
from repro_torch.staticcheck.findings import Finding
from repro_torch.staticcheck.lattice import Ival

__all__ = [
    "SymbolicScale",
    "scale_for",
    "AbsintReport",
    "CollectiveUse",
    "AbsTrace",
    "analyze",
    "analyze_trace",
    "audit_routes",
]


def _fmt(x) -> str:
    """Exact display for integral bounds (an off-by-one W3 finding must
    not print as '[0, 1e+09] outside [0, 1e+09]')."""
    if isinstance(x, int) and abs(x) < 10**15:
        return str(x)
    if isinstance(x, float) and math.isfinite(x) and x.is_integer() \
            and abs(x) < 10**15:
        return str(int(x))
    return f"{x:.4g}"


class SymbolicScale(NamedTuple):
    """The staged-size → symbolic-size re-reading.

    ``dims``: marker dim/literal sizes → symbolic sizes (choose distinctive
    staged markers ≥ 64 so ordinary small constants never collide).
    ``axes``: mesh axis name → symbolic shard count (shard index and
    ``psum`` bounds). ``precision_floor``: enables the W2 cancellation
    rule at the given absolute-precision requirement (off when None).
    """
    dims: dict = {}
    axes: dict = {}
    precision_floor: float = None

    def dim(self, d: int) -> int:
        return int(self.dims.get(int(d), int(d)))

    def lit(self, v):
        """Re-read an integer literal that equals a marker size."""
        if isinstance(v, (int,)) and not isinstance(v, bool) and v in self.dims:
            return int(self.dims[v])
        return v

    def axis_size(self, name: str, staged: int) -> int:
        return int(self.axes.get(name, staged))


def scale_for(n: int, N: int, extra: dict | None = None) -> dict:
    """Marker family for a BVH-shaped program staged at ``n`` leaves:
    maps n, n±1 and the internal-node counts 2n-1 / 2n-2 to their
    symbolic counterparts. Merge ``extra`` marker→symbolic pairs on top."""
    dims = {n: N, n - 1: N - 1, n + 1: N + 1,
            2 * n - 1: 2 * N - 1, 2 * n - 2: 2 * N - 2}
    dims.update(extra or {})
    return dims


@dataclasses.dataclass
class AbsintReport:
    """One analysis run: findings + coverage counters. ``ops_visited``
    counts the recorded ATen ops and opaque calls (the reference's
    ``eqns_visited``), ``unknown_ops`` the ATen ops with no transfer
    function (its ``unknown_prims``), ``kernel_outputs`` the tensors kernel
    wrappers returned. ``keys`` holds one ``(rule, op, interval)`` per
    finding: what a run on the card and one on the CPU must share;
    ``unknown`` the unknown ops by name; ``outputs`` the interval of each
    tensor of the call's result, in order."""
    name: str
    findings: list
    values_analyzed: int = 0
    ops_visited: int = 0
    unknown_ops: int = 0
    kernel_outputs: int = 0
    collectives: list = dataclasses.field(default_factory=list)
    keys: list = dataclasses.field(default_factory=list)
    unknown: dict = dataclasses.field(default_factory=dict)
    outputs: list = dataclasses.field(default_factory=list)


class CollectiveUse(NamedTuple):
    """One collective of a ``ShardAxis``."""
    prim: str              # "ppermute" | "psum" | "pmax" | "all_gather"
    axes: tuple            # axis names the op names
    perm: tuple            # ppermute route table ((src, dst), ...) or ()
    mesh_axes: dict        # enclosing mesh: axis name -> staged size


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------

class _Ref(NamedTuple):
    """A tensor argument of a recorded op: the id of the value it held."""
    id: int


class _Rec(NamedTuple):
    kind: str        # "op", or an opaque call's kind
    name: str        # ATen overload packet ("add_"), kernel or collective
    overload: str    # ATen overload name ("Tensor"), else ""
    args: tuple      # tensors as _Ref
    kwargs: dict
    outs: tuple      # value ids of the tensor outputs, flat
    writes: tuple    # ((old id, new id), ...) of tensors written in place
    weak: tuple      # ((old id, new id, written id), ...): views of those
    where: str       # innermost source line of the port
    info: dict


def _flat(x, out):
    """Append the tensors of ``x`` (tuples, NamedTuples, lists and dicts
    of them) to ``out``, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _flat(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _flat(v, out)
    return out


_PKG = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
_SKIP = (os.path.realpath(__file__),
         os.path.realpath(opaque.__file__))
_ROOT = os.path.dirname(os.path.dirname(_PKG))
_files: dict = {}


def _where() -> str:
    """The innermost source line inside the port (this module aside), else
    the innermost outside torch."""
    f = sys._getframe(2)
    outside = None
    while f is not None:
        fn = f.f_code.co_filename
        got = _files.get(fn)
        if got is None:
            real = os.path.realpath(fn)
            got = _files[fn] = (real, os.path.relpath(real, _ROOT),
                                real.startswith(_PKG) and real not in _SKIP,
                                "torch" + os.sep in real)
        if got[2]:
            return f"{got[1]}:{f.f_lineno}"
        if outside is None and not got[3] and got[0] not in _SKIP:
            outside = f"{got[1]}:{f.f_lineno}"
        f = f.f_back
    return outside or "?"


class _Group:
    """Tensors sharing storage through recorded views."""
    __slots__ = ("members",)

    def __init__(self):
        self.members = WeakTensorKeyDictionary()


class AbsTrace(TorchDispatchMode):
    """Records the ATen ops dispatched inside it as value-id data flow:
    for each op its inputs (by the id of the value each tensor held), its
    scalar arguments, its outputs' ids, dtypes and shapes, the tensors it
    wrote in place and the views of those. Tensors are keyed weakly, so
    the trace keeps no intermediate alive. Ops inside an opaque call
    (``repro_torch.opaque``) are skipped; the call's result is recorded as
    one step. ``initial``: interval per value id of the tensors seen first
    as inputs (see :meth:`register`)."""

    def __init__(self):
        super().__init__()
        self.records: list = []
        self.meta: dict = {}          # value id -> (dtype, shape)
        self.initial: dict = {}       # value id -> Ival of an input
        self.const: dict = {}         # value id -> Ival read from host data
        self._ids = WeakTensorKeyDictionary()
        self._groups = WeakTensorKeyDictionary()
        self._next = 0

    # -- ids -------------------------------------------------------------

    def _new(self, t: torch.Tensor) -> int:
        vid = self._next
        self._next += 1
        self._ids[t] = vid
        self.meta[vid] = (t.dtype, tuple(t.shape))
        return vid

    def id_of(self, t: torch.Tensor) -> int:
        vid = self._ids.get(t)
        if vid is None:
            vid = self._new(t)
        return vid

    def register(self, t: torch.Tensor, ival: Ival | None) -> None:
        """Declare ``t`` an input of the call with interval ``ival``."""
        vid = self._new(t)
        if ival is not None:
            self.initial[vid] = ival

    def _refs(self, x):
        if isinstance(x, torch.Tensor):
            return _Ref(self.id_of(x))
        if isinstance(x, (tuple, list)):
            refs = [self._refs(v) for v in x]
            return refs if isinstance(x, list) else tuple(refs)
        if isinstance(x, dict):
            return {k: self._refs(v) for k, v in x.items()}
        return x

    def _group(self, t: torch.Tensor) -> _Group:
        g = self._groups.get(t)
        if g is None:
            g = self._groups[t] = _Group()
            g.members[t] = True
        return g

    # -- dispatch ----------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if opaque.inside():
            return func(*args, **kwargs)
        rargs, rkwargs = self._refs(args), self._refs(kwargs)
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        schema = func._schema
        written = []
        for k, a in enumerate(schema.arguments):
            info = a.alias_info
            if info is None or not info.is_write:
                continue
            val = args[k] if k < len(args) else kwargs.get(a.name)
            written += _flat(val, [])
        writes, weak = [], []
        for t in written:
            old = self.id_of(t)
            new = self._new(t)
            writes.append((old, new))
            for m in list(self._group(t).members.keys()):
                if m is not t:
                    weak.append((self.id_of(m), self._new(m), new))
        outs = []
        fresh = {id(t) for t in written}
        for t in _flat(out, []):
            outs.append(self._ids[t] if id(t) in fresh else self._new(t))
        if func.is_view and args and isinstance(args[0], torch.Tensor):
            g = self._group(args[0])
            for t in _flat(out, []):
                g.members[t] = True
                self._groups[t] = g
        if name in ("lift_fresh", "lift_fresh_copy") and outs:
            self.const[outs[0]] = _host_ival(_flat(out, [])[0])
        self.records.append(_Rec("op", name, func._overloadname, rargs,
                                 rkwargs, tuple(outs), tuple(writes),
                                 tuple(weak), _where(), {}))
        return out

    def opaque_result(self, kind: str, name: str, result, info: dict) -> None:
        """An opaque call returned (``repro_torch.opaque.announce``)."""
        info = dict(info)
        operand = info.pop("operand", None)
        args = (self._refs(operand),) if operand is not None else ()
        outs = []
        for t in _flat(result, []):
            # A collective may return a tensor object the trace already
            # holds (the sender's own, or on one shard the operand): the
            # object's value becomes the join of both, sound for every
            # reader of it (see _Interp._opaque).
            prev = self._ids.get(t)
            vid = self._new(t)
            if prev is not None:
                info.setdefault("joins", {})[vid] = prev
            outs.append(vid)
        self.records.append(_Rec(kind, name, "", args, {}, tuple(outs), (),
                                 (), _where(), info))

    def final_ids(self, result) -> list:
        """The value ids of the tensors of ``result``, in order."""
        return [self._ids[t] for t in _flat(result, []) if t in self._ids]


def _host_ival(t: torch.Tensor) -> Ival:
    """The interval of a tensor made from host data (a constant)."""
    if t.numel() == 0:
        return lat.dtype_top(t.dtype)
    if t.dtype == torch.bool:
        return Ival(int(t.min()), int(t.max()), True)
    if t.is_floating_point():
        lo, hi = float(t.min()), float(t.max())
        if math.isnan(lo) or math.isnan(hi):
            return lat.dtype_top(t.dtype)
        return Ival(lo, hi, True)
    if t.is_complex():
        return lat.dtype_top(t.dtype)
    return Ival(int(t.min()), int(t.max()), True)


# ---------------------------------------------------------------------------
# The interpreter
# ---------------------------------------------------------------------------

# Ops whose output holds the input's elements, rearranged (interval-
# preserving, no W1 of their own).
_SHAPE_ONLY = frozenset((
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "unsqueeze", "squeeze", "permute", "t", "transpose",
    "slice", "select", "narrow", "as_strided", "alias", "detach", "clone",
    "contiguous", "unbind", "split", "split_with_sizes", "chunk", "flatten",
    "unflatten", "repeat", "roll", "flip", "movedim", "diagonal", "tile",
    "unfold", "view_as", "squeeze_copy", "unsqueeze_copy", "view_copy",
    "lift_fresh", "lift_fresh_copy"))

# Subset safe for guard-refinement aliasing: lane i of the output is lane i
# (or a replica) of the input, so a lanewise predicate on the root still
# describes the aliased value. permute/transpose/slice reorder lanes and
# must not alias.
_LANE_SAFE = frozenset((
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "unsqueeze", "squeeze", "alias", "detach", "clone",
    "contiguous", "view_as"))

_CMP = frozenset(("eq", "ne", "lt", "le", "gt", "ge"))
_SHIFT_LEFT = frozenset(("__lshift__", "bitwise_left_shift"))
_BIT_MASK = frozenset(("bitwise_and", "__and__"))
_BIT_MERGE = frozenset(("bitwise_or", "bitwise_xor", "__or__", "__xor__"))
_ORDER = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}

# The index operand of each indexing op: (argument position, kind). Kind
# "adv": advanced indexing, a list of per-dimension index tensors that wrap
# negatives; "dim": one index tensor along the ``dim`` argument (position
# 1), range [0, S-1]; "flat": over the flattened operand.
_INDEXING = {
    "index": (1, "adv"), "index_put": (1, "adv"),
    "_index_put_impl": (1, "adv"),
    "index_select": (2, "dim"), "gather": (2, "dim"),
    "scatter": (2, "dim"), "scatter_add": (2, "dim"),
    "scatter_reduce": (2, "dim"), "index_add": (2, "dim"),
    "index_copy": (2, "dim"), "index_fill": (2, "dim"),
    "index_reduce": (2, "dim"), "take": (1, "flat"),
}


def _base(name: str) -> str:
    """The op an in-place or out-of-place variant computes (``mul_`` ->
    ``mul``)."""
    if name.startswith("__i") and name.endswith("__"):
        return "__" + name[3:]
    if name.endswith("_") and not name.endswith("__"):
        return name[:-1]
    return name


class _Interp:
    def __init__(self, trace: AbsTrace, scale: SymbolicScale, name: str,
                 rules, outputs: set):
        self.t = trace
        self.scale = scale
        self.name = name
        self.rules = frozenset(rules)
        self.findings: dict = {}      # dedup key -> Finding
        self.report = AbsintReport(name=name, findings=[])
        self.env: dict = {}
        self.uninit: set = set()
        self.alias: dict = {}         # value id -> root value id
        self.guard_of: dict = {}      # cmp output -> (op, x root, const)
        self.lin_of: dict = {}        # add/sub output -> (x root, delta)
        self.outputs = outputs
        self.uses: dict = {}          # value id -> [(record index, arg pos)]
        for k, rec in enumerate(trace.records):
            for pos, ref in _arg_refs(rec.args):
                self.uses.setdefault(ref.id, []).append((k, pos))
            for pos, ref in _arg_refs(tuple(rec.kwargs.values()), 1000):
                self.uses.setdefault(ref.id, []).append((k, pos))

    # -- env helpers -------------------------------------------------------

    def dtype(self, vid: int):
        return self.t.meta[vid][0]

    def shape(self, vid: int) -> tuple:
        return tuple(self.scale.dim(d) for d in self.t.meta[vid][1])

    def val(self, vid: int) -> Ival:
        v = self.env.get(vid)
        if v is None:
            v = self.t.initial.get(vid) or lat.dtype_top(self.dtype(vid))
            self.env[vid] = v
        return v

    def read(self, x) -> Ival | None:
        """The interval of an argument: a tensor's, or a Python scalar's
        (an int equal to a marker is re-read at its symbolic size)."""
        if isinstance(x, _Ref):
            return self.val(x.id)
        if isinstance(x, bool):
            return lat.const(int(x))
        if isinstance(x, int):
            return lat.const(self.scale.lit(x))
        if isinstance(x, float):
            if math.isnan(x):
                return Ival(-math.inf, math.inf, False)
            return lat.const(x)
        return None

    def write(self, vid: int, val: Ival) -> None:
        dtype = self.dtype(vid)
        if lat.is_unsigned_int(dtype):
            val = lat.wrap_unsigned(val, dtype)
        elif dtype == torch.bool:
            val = Ival(0 if val.lo <= 0 else 1, 1 if val.hi >= 1 else 0,
                       val.known)
        self.env[vid] = val
        self.report.values_analyzed += 1

    def root(self, vid: int) -> int:
        while vid in self.alias:
            vid = self.alias[vid]
        return vid

    # -- findings ----------------------------------------------------------

    def emit(self, rule: str, rec: _Rec, message: str, interval=None):
        # One finding per (rule, op, source line): an unrolled loop revisits
        # the same line with the same fault.
        key = (rule, rec.name, rec.where)
        if key not in self.findings:
            self.findings[key] = Finding(
                rule=rule, path=f"<absint:{self.name}>", line=0,
                message=f"[{rec.where}] {message}")
            self.report.keys.append((rule, rec.name, interval))

    # -- deferred judgement ------------------------------------------------

    def _only_deferred_uses(self, vid: int, accept) -> bool:
        """True when every later use of ``vid`` (followed transitively
        through shape-only ops) satisfies ``accept(rec, pos)`` and never
        reaches the call's result — the value's judgment is deferred to
        those consuming ops."""
        todo, seen, used = [vid], set(), False
        while todo:
            v = todo.pop()
            if v in seen:
                continue
            seen.add(v)
            if v in self.outputs:
                return False
            for k, pos in self.uses.get(v, ()):
                rec = self.t.records[k]
                if rec.kind == "op" and rec.name in _SHAPE_ONLY:
                    todo.extend(rec.outs)
                    continue
                if rec.kind == "op" and accept(rec, pos):
                    used = True
                    continue
                return False
        return used

    def only_case_uses(self, vid: int) -> bool:
        """Every later use is as a *case* of a ``where`` (never its
        condition): such a value is dead on the lanes where it is not
        selected, so it is judged after guard refinement there."""
        return self._only_deferred_uses(
            vid, lambda rec, pos: _base(rec.name) == "where" and pos in (1, 2))

    def only_index_uses(self, vid: int) -> bool:
        """Every later use is as the index operand of an indexing op: a
        narrowing convert consumed only as an index is judged by that op's
        W3 bounds check, which a truncated index still fails."""
        def accept(rec, pos):
            got = _INDEXING.get(_base(rec.name))
            return got is not None and (pos == got[0] or (
                got[1] == "adv" and 100 <= pos < 1000))
        return self._only_deferred_uses(vid, accept)

    def only_masked_uses(self, vid: int) -> bool:
        """Every later use clears the bits a left shift carried past the
        top of a signed dtype: an ``and`` with a non-negative mask, or an
        ``or``/``xor`` whose result is in turn only masked. That is bit
        surgery (the port's Morton codes live in int64, torch's CPU having
        no uint32 shifts), which wraps as the reference's uint32 surgery
        does. Any other use, a right shift included, reads the carried
        bits and is judged at the shift."""
        def accept(rec, pos):
            op = _base(rec.name)
            if op in _BIT_MASK and pos in (0, 1):
                mask = self.read(rec.args[1 - pos])
                return mask.known and mask.lo >= 0
            return op in _BIT_MERGE and all(self.only_masked_uses(o)
                                            for o in rec.outs)
        return self._only_deferred_uses(vid, accept)

    # -- the W-rule checks -------------------------------------------------

    def check_w1(self, rec: _Rec, outs: list):
        if "W1" not in self.rules:
            return
        # fire only where the overflow FIRST happens: skip if an input
        # already escaped its own dtype (reported upstream).
        for _, ref in _arg_refs(rec.args):
            iv = self.val(ref.id)
            dt = self.dtype(ref.id)
            if not iv.known or not lat.is_signed_int(dt):
                continue
            b = lat.int_bounds(dt)
            if iv.lo < b[0] or iv.hi > b[1]:
                return
        bad = []
        for vid in outs:
            dt, iv = self.dtype(vid), self.env[vid]
            if not iv.known or not lat.is_signed_int(dt):
                continue
            b = lat.int_bounds(dt)
            if iv.lo < b[0] or iv.hi > b[1]:
                bad.append((vid, dt, iv, b))
        if not bad:
            return
        if all(self.only_case_uses(vid) for vid, *_ in bad):
            return
        if rec.name == "_to_copy" and all(self.only_index_uses(vid)
                                          for vid, *_ in bad):
            return
        if _base(rec.name) in _SHIFT_LEFT and all(
                self.only_masked_uses(vid) for vid, *_ in bad):
            return
        _, dt, iv, b = bad[0]
        span = f"[{_fmt(iv.lo)}, {_fmt(iv.hi)}]"
        self.emit(
            "W1-index-width", rec,
            f"{rec.name}: {str(dt).removeprefix('torch.')} result spans "
            f"{span} at symbolic N — exceeds the dtype range "
            f"[{_fmt(b[0])}, {_fmt(b[1])}]; widen the index dtype "
            f"(index_dtype=torch.int64) or annotate "
            f"'# staticcheck: width-ok'", span)

    def check_w2_quantize(self, rec: _Rec, vid: int, iv: Ival):
        if "W2" not in self.rules or not iv.known:
            return
        dt = self.dtype(vid)
        m = lat.mantissa_bits(dt)
        if m is None:
            return
        mag = iv.maxmag()
        if mag >= float(1 << m):
            self.emit(
                "W2-precision", rec,
                f"{rec.name}: quantizing a {str(dt).removeprefix('torch.')} "
                f"operand with magnitude up to {mag:.4g} — ulp spacing "
                f"{lat.ulp_at(mag, dt):.4g} exceeds 1 beyond 2^{m}, so "
                f"integer rounding collapses (the round(BIG/L)*L == BIG "
                f"min-image trap); fold in float64 or clamp the operand "
                f"first")

    def check_w2_cancel(self, rec: _Rec, dt, a: Ival, b: Ival):
        floor = self.scale.precision_floor
        if "W2" not in self.rules or floor is None:
            return
        if not lat.is_float(dt) or not (a.known and b.known):
            return
        if not a.overlaps(b):
            return
        mag = min(a.maxmag(), b.maxmag())
        if mag == 0 or math.isinf(mag):
            return
        if lat.ulp_at(mag, dt) > floor:
            self.emit(
                "W2-precision", rec,
                f"sub: catastrophic cancellation risk — "
                f"{str(dt).removeprefix('torch.')} operands of magnitude "
                f"~{mag:.4g} may cancel, leaving absolute error "
                f"~{lat.ulp_at(mag, dt):.4g} > precision_floor={floor:.4g}; "
                f"use a two-pass/compensated formulation")

    def check_w3(self, rec: _Rec, iv: Ival, size: int, wraps: bool):
        if "W3" not in self.rules or not iv.known:
            return
        lo = -size if wraps else 0
        if iv.lo < lo or iv.hi > size - 1:
            self.emit(
                "W3-bounds", rec,
                f"{rec.name}: index interval [{_fmt(iv.lo)}, "
                f"{_fmt(iv.hi)}] is not provably inside [{_fmt(lo)}, "
                f"{_fmt(size - 1)}] at symbolic N — clip the index or "
                f"guard the sentinel with torch.where")

    # -- the walk ----------------------------------------------------------

    def run(self):
        for k, rec in enumerate(self.t.records):
            self.report.ops_visited += 1
            if rec.kind == "op":
                self._op(k, rec)
            else:
                self._opaque(rec)

    def _opaque(self, rec: _Rec):
        info = rec.info
        if rec.kind == "kernel":
            # The kernel's values are outside the lattice: every output
            # covers its dtype's range, as the reference's pallas_call.
            for vid in rec.outs:
                self.report.kernel_outputs += 1
                self.write(vid, lat.dtype_top(self.dtype(vid)))
            return
        staged = info.get("size", 1)
        size = self.scale.axis_size(rec.name if rec.kind == "axis_index"
                                    else info.get("axis"), staged)
        if rec.kind == "axis_index":
            for vid in rec.outs:
                self.write(vid, Ival(0, size - 1, True))
            return
        x = self.val(rec.args[0].id)
        axis = info.get("axis")
        self.report.collectives.append(CollectiveUse(
            prim=rec.name, axes=(axis,), perm=tuple(info.get("perm", ())),
            mesh_axes={axis: staged}))
        if rec.name == "ppermute":
            val = lat.join(x, lat.const(0))     # no sender: zeros
        elif rec.name == "psum":
            val = lat.scale_by_count(x, size)
        else:                                   # pmax, all_gather
            val = x
        joins = info.get("joins", {})
        for vid in rec.outs:
            prev = joins.get(vid)
            self.write(vid, val if prev is None else lat.join(val,
                                                              self.val(prev)))
        self.check_w1(rec, list(rec.outs))

    def _op(self, k: int, rec: _Rec):
        base = _base(rec.name)
        fn = _TRANSFER.get(base)
        if fn is None:
            self.report.unknown_ops += 1
            self.report.unknown[rec.name] = \
                self.report.unknown.get(rec.name, 0) + 1
            vals = [lat.dtype_top(self.dtype(v)) for v in rec.outs]
        else:
            got = fn(self, rec)
            vals = got if isinstance(got, list) else [got] * len(rec.outs)
        for vid, v in zip(rec.outs, vals):
            if v is None:
                v = lat.dtype_top(self.dtype(vid))
            self.write(vid, v)
        for old, new in rec.writes:
            if new not in rec.outs:      # written, not returned
                v = vals[0] if vals and vals[0] is not None \
                    else lat.dtype_top(self.dtype(new))
                self.write(new, v)
        for old, new, src in rec.weak:
            self.write(new, self.env[src] if old in self.uninit
                       else lat.join(self.val(old), self.env[src]))
        if base in ("empty", "empty_like", "new_empty", "empty_strided"):
            self.uninit.update(rec.outs)
        if rec.outs and isinstance(rec.args[0], _Ref) and (
                base in _LANE_SAFE and self.dtype(rec.outs[0])
                == self.dtype(rec.args[0].id)
                or base == "_to_copy" and _widening(self, rec)):
            for vid in rec.outs:
                self.alias[vid] = self.root(rec.args[0].id)
        if base not in _SHAPE_ONLY and base not in _CMP:
            self.check_w1(rec, list(rec.outs) + [n for _, n in rec.writes
                                                  if n not in rec.outs])
        if base in _SHIFT_LEFT:
            # a shift wraps in two's complement (torch shifts as unsigned):
            # past the top, the result may be any value of the dtype
            for vid in rec.outs:
                v, b = self.env[vid], lat.int_bounds(self.dtype(vid))
                if b and (v.lo < b[0] or v.hi > b[1]):
                    self.env[vid] = Ival(b[0], b[1], v.known)


def _widening(self: _Interp, rec: _Rec) -> bool:
    """A value-preserving integer convert (int32 -> int64)."""
    src, dst = self.dtype(rec.args[0].id), self.dtype(rec.outs[0])
    bs, bd = lat.int_bounds(src), lat.int_bounds(dst)
    return bool(bs and bd and bd[0] <= bs[0] and bs[1] <= bd[1])


def _arg_refs(args, start: int = 0) -> list:
    """``(position, _Ref)`` of the tensor arguments; a tensor inside a list
    argument at position p gets 100 + 10·p + its place (the index lists
    of advanced indexing, the tensors of ``cat``)."""
    out = []
    for p, a in enumerate(args):
        if isinstance(a, _Ref):
            out.append((start + p, a))
        elif isinstance(a, (tuple, list)):
            for j, x in enumerate(a):
                if isinstance(x, _Ref):
                    out.append((start + 100 + 10 * p + j, x))
    return out


# ---------------------------------------------------------------------------
# Transfer functions, by ATen op (in-place variants share them)
# ---------------------------------------------------------------------------

def _arg(rec: _Rec, pos: int, name: str, default=None):
    if pos < len(rec.args):
        return rec.args[pos]
    return rec.kwargs.get(name, default)


def _ins(self: _Interp, rec: _Rec, n: int) -> list:
    return [self.read(a) for a in rec.args[:n]]


def _out_dtype(self: _Interp, rec: _Rec):
    if rec.outs:
        return self.dtype(rec.outs[0])
    for _, new in rec.writes:
        return self.dtype(new)
    return None


def _is_int(dt) -> bool:
    return lat.is_signed_int(dt) or lat.is_unsigned_int(dt)


def _bool_of(*ivs) -> Ival:
    return Ival(0, 1, all(v is None or v.known for v in ivs))


def _t_add(self, rec):
    a, b = self.read(rec.args[0]), self.read(_arg(rec, 1, "other"))
    alpha = _arg(rec, 2, "alpha", 1)
    if alpha != 1:
        b = lat.mul(b, self.read(alpha))
    _note_lin(self, rec, a, b, 1)
    return lat.add(a, b)


def _t_sub(self, rec):
    a, b = self.read(rec.args[0]), self.read(_arg(rec, 1, "other"))
    alpha = _arg(rec, 2, "alpha", 1)
    if alpha != 1:
        b = lat.mul(b, self.read(alpha))
    if isinstance(rec.args[0], _Ref):
        self.check_w2_cancel(rec, self.dtype(rec.args[0].id), a, b)
    _note_lin(self, rec, a, b, -1)
    return lat.sub(a, b)


def _t_rsub(self, rec):
    a, b = self.read(rec.args[0]), self.read(_arg(rec, 1, "other"))
    alpha = _arg(rec, 2, "alpha", 1)
    if alpha != 1:
        a = lat.mul(a, self.read(alpha))
    return lat.sub(b, a)


def _note_lin(self: _Interp, rec: _Rec, av: Ival, bv: Ival, sign: int):
    """Record ``out = x ± point`` for guard-refinement back-substitution."""
    a, b = rec.args[0], _arg(rec, 1, "other")
    if not rec.outs:
        return
    if bv.is_point() and isinstance(a, _Ref) and not math.isinf(bv.lo):
        self.lin_of[rec.outs[0]] = (self.root(a.id), sign * bv.lo)
    elif sign > 0 and av.is_point() and isinstance(b, _Ref) \
            and not math.isinf(av.lo):
        self.lin_of[rec.outs[0]] = (self.root(b.id), av.lo)


def _t_mul(self, rec):
    return lat.mul(*_ins(self, rec, 2))


def _t_div(self, rec):
    a, b = _ins(self, rec, 2)
    val = lat.div(a, b)
    mode = _arg(rec, 2, "rounding_mode")
    if mode == "trunc":
        return lat.truncate(val)
    if mode == "floor":
        return lat.floor_op(val)
    return val


def _t_floor_divide(self, rec):
    return lat.floor_op(lat.div(*_ins(self, rec, 2)))


def _t_fmod(self, rec):
    return lat.rem(*_ins(self, rec, 2))


def _t_remainder(self, rec):
    """Python semantics: the result takes the divisor's sign."""
    a, b = _ins(self, rec, 2)
    k = a.known and b.known
    if b.lo > 0 and not math.isinf(b.hi):
        return Ival(0, b.hi, k)
    if b.hi < 0 and not math.isinf(b.lo):
        return Ival(b.lo, 0, k)
    m = b.maxmag()
    return Ival(-m, m, k)


def _t_neg(self, rec):
    return lat.neg(self.read(rec.args[0]))


def _t_abs(self, rec):
    return lat.iabs(self.read(rec.args[0]))


def _t_sign(self, rec):
    return Ival(-1, 1, self.read(rec.args[0]).known)


def _t_minimum(self, rec):
    return lat.imin(*_ins(self, rec, 2))


def _t_maximum(self, rec):
    return lat.imax(*_ins(self, rec, 2))


def _t_clamp(self, rec):
    x = self.read(rec.args[0])
    lo = self.read(_arg(rec, 1, "min"))
    hi = self.read(_arg(rec, 2, "max"))
    if hi is not None:
        x = lat.imin(x, hi)
    if lo is not None:
        x = lat.imax(lo, x)
    return x


def _t_clamp_min(self, rec):
    return lat.imax(self.read(rec.args[1]), self.read(rec.args[0]))


def _t_clamp_max(self, rec):
    return lat.imin(self.read(rec.args[0]), self.read(rec.args[1]))


def _t_pow(self, rec):
    a, y = self.read(rec.args[0]), rec.args[1]
    if isinstance(y, bool) or not isinstance(y, int):
        if isinstance(y, float) and y.is_integer():
            y = int(y)
        else:
            return Ival(-math.inf, math.inf, False)
    if y < 0:
        return Ival(-math.inf, math.inf, a.known)
    if y == 0:
        return Ival(1, 1, a.known)

    def p(x):
        if math.isinf(x):
            return math.inf if (y % 2 == 0 or x > 0) else -math.inf
        try:
            return x ** y
        except OverflowError:
            return math.inf if (y % 2 == 0 or x > 0) else -math.inf

    cs = [p(a.lo), p(a.hi)]
    if y % 2 == 0 and a.lo < 0 < a.hi:
        cs.append(0)
    return Ival(min(cs), max(cs), a.known)


def _t_sqrt(self, rec):
    a = self.read(rec.args[0])
    return Ival(math.sqrt(max(a.lo, 0.0)),
                math.sqrt(max(a.hi, 0.0)) if not math.isinf(a.hi)
                else math.inf, a.known)


def _t_rsqrt(self, rec):
    a = self.read(rec.args[0])
    lo = 0.0 if math.isinf(a.hi) else (math.inf if a.hi <= 0
                                       else 1.0 / math.sqrt(a.hi))
    hi = math.inf if a.lo <= 0 else 1.0 / math.sqrt(a.lo)
    return Ival(min(lo, hi), hi, a.known)


def _t_exp(self, rec):
    return lat.monotonic(self.read(rec.args[0]),
                         lambda x: math.exp(min(x, 700.0)))


def _t_log(self, rec):
    a = self.read(rec.args[0])
    return Ival(-math.inf if a.lo <= 0 else math.log(a.lo),
                -math.inf if a.hi <= 0 else
                (math.inf if math.isinf(a.hi) else math.log(a.hi)), a.known)


def _t_unit(self, rec):
    return Ival(-1.0, 1.0, self.read(rec.args[0]).known)


def _t_sigmoid(self, rec):
    return Ival(0.0, 1.0, self.read(rec.args[0]).known)


def _quantizer(f):
    def t(self, rec):
        a = self.read(rec.args[0])
        if isinstance(rec.args[0], _Ref) and lat.is_float(
                self.dtype(rec.args[0].id)):
            self.check_w2_quantize(rec, rec.args[0].id, a)
            return f(a)
        return a
    return t


def _t_to_copy(self, rec):
    src = self.read(rec.args[0])
    src_dt = self.dtype(rec.args[0].id)
    dst_dt = _out_dtype(self, rec)
    if lat.is_float(src_dt) and _is_int(dst_dt):
        self.check_w2_quantize(rec, rec.args[0].id, src)
        return lat.truncate(src)
    if dst_dt == torch.bool:
        return Ival(0, 1, src.known)
    return src


def _t_copy(self, rec):
    """``dst.copy_(src)``: every element of dst now holds src's, in dst's
    dtype."""
    src = self.read(_arg(rec, 1, "src"))
    src_dt = self.dtype(rec.args[1].id)
    dst_dt = self.dtype(rec.args[0].id)
    if lat.is_float(src_dt) and _is_int(dst_dt):
        self.check_w2_quantize(rec, rec.args[1].id, src)
        return lat.truncate(src)
    return src


def _t_bit(op):
    def t(self, rec):
        a, b = _ins(self, rec, 2)
        if _out_dtype(self, rec) == torch.bool:
            return _bool_of(a, b)
        return op(a, b)
    return t


def _t_bitwise_not(self, rec):
    a = self.read(rec.args[0])
    dt = _out_dtype(self, rec)
    if dt == torch.bool:
        return _bool_of(a)
    if lat.is_signed_int(dt):
        return Ival(-a.hi - 1, -a.lo - 1, a.known)
    top = lat.int_bounds(dt)[1]
    return Ival(top - a.hi, top - a.lo, a.known)


def _t_shl(self, rec):
    return lat.shift_left(*_ins(self, rec, 2))


def _t_shr(self, rec):
    a, s = _ins(self, rec, 2)
    signed = not lat.is_unsigned_int(self.dtype(rec.args[0].id))
    return lat.shift_right(a, s, arithmetic=signed)


def _t_bool(self, rec):
    return _bool_of(*[self.read(a) for a in rec.args if isinstance(
        a, (_Ref, int, float))])


def _t_cmp(self, rec):
    """A comparison: [0, 1]; against a point it guards later selects."""
    op = _base(rec.name)
    a, b = rec.args[0], _arg(rec, 1, "other")
    av, bv = self.read(a), self.read(b)
    if op in _ORDER and rec.outs:
        if bv is not None and bv.is_point() and isinstance(a, _Ref):
            self.guard_of[rec.outs[0]] = (op, self.root(a.id), bv.lo)
        elif av.is_point() and isinstance(b, _Ref):
            self.guard_of[rec.outs[0]] = (_ORDER[op], self.root(b.id), av.lo)
    return Ival(0, 1, True)


def _t_where(self, rec):
    cond, a, b = rec.args[0], _arg(rec, 1, "self"), _arg(rec, 2, "other")
    cases = ((a, True), (b, False))
    info = self.guard_of.get(self.root(cond.id)) \
        if isinstance(cond, _Ref) else None
    if info is not None:
        op, x_root, c = info
        xval = self.val(x_root)
        if xval.known:
            false_g, true_g = _guards(op, c)
            vals = []
            for case, branch in cases:
                guard = true_g if branch else false_g
                if lat.meet(xval, guard) is None:
                    continue                    # infeasible branch
                vals.append(_refine_case(self, case, x_root, xval, guard))
            if vals:
                v = vals[0]
                for w in vals[1:]:
                    v = lat.join(v, w)
                return v
    return lat.join(self.read(a), self.read(b))


def _refine_case(self: _Interp, case, x_root: int, xval: Ival, guard: Ival):
    """Interval of a ``where`` case under the guard: if the case IS the
    guarded value, meet; if it is ``guarded ± literal``, meet then shift."""
    base = self.read(case)
    if not isinstance(case, _Ref):
        return base
    root = self.root(case.id)
    if root == x_root:
        m = lat.meet(base, guard)
        return base if m is None else m
    lin = self.lin_of.get(root)
    if lin is not None and lin[0] == x_root:
        m = lat.meet(xval, guard)
        if m is not None:
            return Ival(m.lo + lin[1], m.hi + lin[1], m.known)
    return base


def _guards(op: str, c):
    """(guard when pred False, guard when pred True) for ``x <op> c``."""
    inf = math.inf
    if op == "lt":
        return Ival(c, inf), Ival(-inf, c - 1 if isinstance(c, int) else c)
    if op == "le":
        return Ival(c + 1 if isinstance(c, int) else c, inf), Ival(-inf, c)
    if op == "gt":
        return Ival(-inf, c), Ival(c + 1 if isinstance(c, int) else c, inf)
    return Ival(-inf, c - 1 if isinstance(c, int) else c), Ival(c, inf)


def _t_masked_fill(self, rec):
    x = self.read(rec.args[0])
    v = self.read(_arg(rec, 2, "value"))
    if isinstance(rec.args[0], _Ref) and rec.args[0].id in self.uninit:
        return v
    return lat.join(x, v)


def _t_shape(self, rec):
    return self.read(rec.args[0])


def _t_view(self, rec):
    """``view`` to a shape keeps the elements; to a dtype reinterprets the
    bits (the dtype's full range, unknown)."""
    dt = _out_dtype(self, rec)
    if dt != self.dtype(rec.args[0].id):
        return lat.dtype_top(dt)
    return self.read(rec.args[0])


def _t_join_list(self, rec):
    vals = [self.read(x) for x in rec.args[0] if isinstance(x, _Ref)]
    if not vals:
        return None
    v = vals[0]
    for w in vals[1:]:
        v = lat.join(v, w)
    return v


def _t_const(pos: int, name: str):
    def t(self, rec):
        return self.read(_arg(rec, pos, name))
    return t


def _t_zero(self, rec):
    return lat.const(0)


def _t_one(self, rec):
    return lat.const(1)


def _t_empty(self, rec):
    return None


def _t_lift(self, rec):
    """A tensor made from host data: its values are constants. A 0-dim
    integer is a literal, re-read at its symbolic size as the reference
    reads literals."""
    v = self.t.const.get(rec.outs[0]) if rec.outs else None
    if v is None:
        return self.read(rec.args[0])
    if v.is_point() and isinstance(v.lo, int) \
            and len(self.t.meta[rec.outs[0]][1]) == 0:
        return lat.const(self.scale.lit(v.lo))
    return v


def _t_arange(self, rec):
    nums = [a for a in rec.args if isinstance(a, (int, float))
            and not isinstance(a, bool)]
    if rec.overload == "default" or len(nums) == 1:
        start, end, step = 0, nums[0], 1
    elif len(nums) == 2:
        (start, end), step = nums, 1
    else:
        start, end, step = nums[:3]
    if isinstance(start, int) and isinstance(end, int):
        start, end = self.scale.lit(start), self.scale.lit(end)
        if end <= start:
            return lat.const(start)
        last = start + ((end - 1 - start) // step) * step if step > 0 \
            else start
        return Ival(min(start, last), max(start, last), True)
    return Ival(min(start, end), max(start, end), True)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _dims(rec: _Rec, pos: int, name: str, ndim: int):
    d = _arg(rec, pos, name)
    if d is None:
        return list(range(ndim))
    d = [d] if isinstance(d, int) else list(d)
    return [x % ndim if ndim else 0 for x in d] or list(range(ndim))


def _reduced_count(self: _Interp, rec: _Rec, dims) -> int:
    shape = self.shape(rec.args[0].id)
    return max(_numel(shape[d] for d in dims if d < len(shape)), 1)


def _t_sum(self, rec):
    x = self.read(rec.args[0])
    ndim = len(self.t.meta[rec.args[0].id][1])
    count = _reduced_count(self, rec, _dims(rec, 1, "dim", ndim))
    return lat.scale_by_count(x, count)


def _t_cumsum(self, rec):
    x = self.read(rec.args[0])
    ndim = len(self.t.meta[rec.args[0].id][1])
    count = _reduced_count(self, rec, _dims(rec, 1, "dim", ndim)[:1])
    return lat.scale_by_count(x, count)


def _t_extreme(self, rec):
    """max/min/amax/amin/cummax/cummin: values keep the operand's interval;
    an indices output lies along the reduced dimension."""
    x = self.read(rec.args[0])
    if rec.overload == "other":               # torch.max(a, b)
        f = lat.imax if _base(rec.name) == "max" else lat.imin
        return f(x, self.read(rec.args[1]))
    if len(rec.outs) < 2:
        return x
    ndim = len(self.t.meta[rec.args[0].id][1])
    n = _reduced_count(self, rec, _dims(rec, 1, "dim", ndim)[:1])
    return [x, Ival(0, n - 1, True)]


def _t_arg_extreme(self, rec):
    ndim = len(self.t.meta[rec.args[0].id][1])
    n = _reduced_count(self, rec, _dims(rec, 1, "dim", ndim))
    return Ival(0, n - 1, True)


def _t_any(self, rec):
    return _bool_of(self.read(rec.args[0]))


def _t_mean(self, rec):
    return self.read(rec.args[0])


def _t_count_nonzero(self, rec):
    ndim = len(self.t.meta[rec.args[0].id][1])
    return Ival(0, _reduced_count(self, rec, _dims(rec, 1, "dim", ndim)),
                True)


def _t_sort(self, rec):
    x = self.read(rec.args[0])
    ndim = len(self.t.meta[rec.args[0].id][1])
    # sort.default(self, dim), sort.stable(self, *, stable, dim): the
    # stable overloads take ``dim`` by keyword
    d = rec.kwargs.get("dim", -1) if rec.overload == "stable" \
        else _arg(rec, 1, "dim", -1)
    n = self.shape(rec.args[0].id)[d % ndim] if ndim else 1
    idx = Ival(0, max(n - 1, 0), True)
    return [x, idx] if len(rec.outs) == 2 else idx


def _t_topk(self, rec):
    x = self.read(rec.args[0])
    ndim = len(self.t.meta[rec.args[0].id][1])
    d = _arg(rec, 2, "dim", -1)
    n = self.shape(rec.args[0].id)[d % ndim] if ndim else 1
    return [x, Ival(0, max(n - 1, 0), True)]


def _t_nonzero(self, rec):
    shape = self.shape(rec.args[0].id)
    return Ival(0, max(max(shape, default=1) - 1, 0), True)


def _t_local_scalar(self, rec):
    return None


def _index_check(self: _Interp, rec: _Rec):
    """W3 on the index operand(s) of an indexing op."""
    pos, kind = _INDEXING[_base(rec.name)]
    src = rec.args[0]
    shape = self.shape(src.id)
    idx = _arg(rec, pos, "indices" if kind == "adv" else "index")
    if kind == "adv":
        d = 0
        for t in idx:
            if t is None:
                d += 1
                continue
            if self.dtype(t.id) in (torch.bool, torch.uint8):
                d += len(self.t.meta[t.id][1])
                continue
            if d < len(shape):
                self.check_w3(rec, self.val(t.id), shape[d], wraps=True)
            d += 1
        return
    if not isinstance(idx, _Ref):
        return
    if kind == "flat":
        self.check_w3(rec, self.val(idx.id), _numel(shape), wraps=False)
        return
    dim = rec.args[1] if len(rec.args) > 1 else rec.kwargs.get("dim", 0)
    if shape:
        self.check_w3(rec, self.val(idx.id), shape[dim % len(shape)],
                      wraps=False)


def _t_gather(self, rec):
    _index_check(self, rec)
    return self.read(rec.args[0])


def _t_index_put(self, rec):
    _index_check(self, rec)
    x, v = self.read(rec.args[0]), self.read(_arg(rec, 2, "values"))
    if _arg(rec, 3, "accumulate", False):
        n = _numel(self.shape(rec.args[2].id)) if isinstance(
            rec.args[2], _Ref) else 1
        return lat.add(x, lat.scale_by_count(v, n))
    if rec.args[0].id in self.uninit:
        return v
    return lat.join(x, v)


def _scatter_src(self: _Interp, rec: _Rec):
    src = _arg(rec, 3, "src")
    if src is None:
        src = rec.kwargs.get("value")
    return src


def _t_scatter(self, rec):
    _index_check(self, rec)
    x, src = self.read(rec.args[0]), self.read(_scatter_src(self, rec))
    reduce = _arg(rec, 4, "reduce")
    if reduce in ("add", "sum"):
        return _accumulate(self, rec, x, src)
    if rec.args[0].id in self.uninit:
        return src
    return lat.join(x, src)


def _accumulate(self: _Interp, rec: _Rec, x: Ival, src: Ival) -> Ival:
    """All updates may collapse onto one slot (the segment-sum idiom)."""
    s = _scatter_src(self, rec)
    n = _numel(self.shape(s.id)) if isinstance(s, _Ref) else 1
    return lat.add(x, lat.scale_by_count(src, n))


def _t_scatter_add(self, rec):
    _index_check(self, rec)
    x, src = self.read(rec.args[0]), self.read(_scatter_src(self, rec))
    return _accumulate(self, rec, x, src)


def _t_scatter_reduce(self, rec):
    _index_check(self, rec)
    x, src = self.read(rec.args[0]), self.read(_scatter_src(self, rec))
    reduce = _arg(rec, 4, "reduce")
    include_self = _arg(rec, 5, "include_self", True)
    k = x.known and src.known
    if reduce == "sum":
        return _accumulate(self, rec, x, src)
    if reduce == "amin":
        # scatter-min only LOWERS slots: [min(lo), operand.hi] keeps a
        # sentinel-valued update from widening the operand's top.
        if include_self:
            return Ival(min(x.lo, src.lo), x.hi, k)
        return Ival(min(x.lo, src.lo), max(x.hi, src.hi), k)
    if reduce == "amax":
        if include_self:
            return Ival(x.lo, max(x.hi, src.hi), k)
        return Ival(min(x.lo, src.lo), max(x.hi, src.hi), k)
    if reduce == "mean":
        return lat.join(x, src)
    return None


def _t_index_add(self, rec):
    _index_check(self, rec)
    x, src = self.read(rec.args[0]), self.read(_arg(rec, 3, "source"))
    n = _numel(self.shape(rec.args[3].id)) if isinstance(
        rec.args[3], _Ref) else 1
    return lat.add(x, lat.scale_by_count(src, n))


def _t_index_fill(self, rec):
    _index_check(self, rec)
    return lat.join(self.read(rec.args[0]), self.read(_arg(rec, 3, "value")))


def _t_index_copy(self, rec):
    _index_check(self, rec)
    return lat.join(self.read(rec.args[0]), self.read(_arg(rec, 3, "source")))


def _t_fill(self, rec):
    return self.read(_arg(rec, 1, "value"))


_TRANSFER: dict = {
    "add": _t_add, "sub": _t_sub, "rsub": _t_rsub, "mul": _t_mul,
    "div": _t_div, "floor_divide": _t_floor_divide, "fmod": _t_fmod,
    "remainder": _t_remainder, "neg": _t_neg, "abs": _t_abs,
    "sign": _t_sign, "sgn": _t_sign,
    "minimum": _t_minimum, "maximum": _t_maximum, "fmin": _t_minimum,
    "fmax": _t_maximum, "clamp": _t_clamp, "clip": _t_clamp,
    "clamp_min": _t_clamp_min, "clamp_max": _t_clamp_max, "pow": _t_pow,
    "sqrt": _t_sqrt, "rsqrt": _t_rsqrt, "exp": _t_exp, "log": _t_log,
    "tanh": _t_unit, "erf": _t_unit, "sin": _t_unit, "cos": _t_unit,
    "sigmoid": _t_sigmoid,
    "floor": _quantizer(lat.floor_op), "ceil": _quantizer(lat.ceil_op),
    "round": _quantizer(lat.round_op), "trunc": _quantizer(lat.truncate),
    "_to_copy": _t_to_copy, "copy": _t_copy,
    "bitwise_and": _t_bit(lat.bit_and), "__and__": _t_bit(lat.bit_and),
    "bitwise_or": _t_bit(lat.bit_or), "__or__": _t_bit(lat.bit_or),
    "bitwise_xor": _t_bit(lat.bit_xor), "__xor__": _t_bit(lat.bit_xor),
    "bitwise_not": _t_bitwise_not,
    "__lshift__": _t_shl, "bitwise_left_shift": _t_shl,
    "__rshift__": _t_shr, "bitwise_right_shift": _t_shr,
    "logical_and": _t_bool, "logical_or": _t_bool, "logical_xor": _t_bool,
    "logical_not": _t_bool, "isnan": _t_bool, "isinf": _t_bool,
    "isfinite": _t_bool, "signbit": _t_bool, "isin": _t_bool,
    "where": _t_where, "masked_fill": _t_masked_fill,
    "masked_select": _t_shape,
    "view": _t_view, "cat": _t_join_list, "stack": _t_join_list,
    "full": _t_const(1, "fill_value"), "full_like": _t_const(1, "fill_value"),
    "new_full": _t_const(2, "fill_value"),
    "scalar_tensor": _t_const(0, "s"), "fill": _t_fill,
    "zeros": _t_zero, "zeros_like": _t_zero, "new_zeros": _t_zero,
    "zero": _t_zero, "ones": _t_one, "ones_like": _t_one,
    "new_ones": _t_one, "empty": _t_empty, "empty_like": _t_empty,
    "new_empty": _t_empty, "empty_strided": _t_empty,
    "lift_fresh": _t_lift, "lift_fresh_copy": _t_lift,
    "arange": _t_arange,
    "sum": _t_sum, "cumsum": _t_cumsum, "mean": _t_mean,
    "amax": _t_extreme, "amin": _t_extreme, "max": _t_extreme,
    "min": _t_extreme, "cummax": _t_extreme, "cummin": _t_extreme,
    "argmax": _t_arg_extreme, "argmin": _t_arg_extreme,
    "any": _t_any, "all": _t_any, "count_nonzero": _t_count_nonzero,
    "sort": _t_sort, "argsort": _t_sort, "topk": _t_topk,
    "nonzero": _t_nonzero, "_local_scalar_dense": _t_local_scalar,
    "index": _t_gather, "index_select": _t_gather, "gather": _t_gather,
    "take": _t_gather, "index_put": _t_index_put,
    "_index_put_impl": _t_index_put, "scatter": _t_scatter,
    "scatter_add": _t_scatter_add, "scatter_reduce": _t_scatter_reduce,
    "index_add": _t_index_add, "index_fill": _t_index_fill,
    "index_copy": _t_index_copy,
}
for _name in _SHAPE_ONLY:
    _TRANSFER.setdefault(_name, _t_shape)
for _name in _CMP:
    _TRANSFER[_name] = _t_cmp
del _name


# ---------------------------------------------------------------------------
# Route audit (W3): permutation bijectivity + axis-name validity
# ---------------------------------------------------------------------------

def audit_routes(uses, name: str) -> list:
    """Check the recorded collectives: ``ppermute`` tables must be partial
    permutations of the staged mesh axis (unique sources, unique
    destinations, ids in range); every named axis must be a mesh axis (a
    ``ShardAxis`` names its own, so a port trace passes that check by
    construction). Returns W3 findings."""
    findings = []

    def emit(msg):
        findings.append(Finding(rule="W3-routes", path=f"<absint:{name}>",
                                line=0, message=msg))

    for use in uses:
        for a in use.axes:
            if use.mesh_axes and a not in use.mesh_axes:
                emit(f"{use.prim}: axis {a!r} is not an axis of the "
                     f"enclosing mesh {sorted(use.mesh_axes)}")
        if use.prim != "ppermute" or not use.perm:
            continue
        size = None
        if use.axes and use.mesh_axes:
            size = use.mesh_axes.get(use.axes[0])
        srcs = [s for s, _ in use.perm]
        dsts = [d for _, d in use.perm]
        if len(set(srcs)) != len(srcs):
            emit(f"ppermute: duplicate source in route table {use.perm} — "
                 f"not a partial permutation")
        if len(set(dsts)) != len(dsts):
            emit(f"ppermute: duplicate destination in route table "
                 f"{use.perm} — two shards would collide")
        if size is not None:
            bad = [x for x in srcs + dsts if not (0 <= x < size)]
            if bad:
                emit(f"ppermute: shard ids {sorted(set(bad))} outside the "
                     f"mesh axis {use.axes[0]!r} of size {size}")
    return findings


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def analyze_trace(trace: AbsTrace, *, name: str, scale: SymbolicScale,
                  outputs=(), rules=("W1", "W2", "W3")) -> AbsintReport:
    """Analyze a recorded :class:`AbsTrace` under the symbolic scale.
    ``outputs``: the call's result (its tensors never defer a W1
    judgment)."""
    final = trace.final_ids(outputs)
    interp = _Interp(trace, scale, name, rules, set(final))
    interp.run()
    interp.report.outputs = [interp.val(vid) for vid in final]
    findings = list(interp.findings.values())
    if "W3" in rules:
        routes = audit_routes(interp.report.collectives, name)
        findings += routes
        interp.report.keys += [(f.rule, "ppermute", None) for f in routes]
    interp.report.findings = findings
    return interp.report


def _spec_leaves(s, out):
    if s is None or isinstance(s, Ival):
        out.append(s)
    elif isinstance(s, (tuple, list)):
        for v in s:
            _spec_leaves(v, out)
    elif isinstance(s, dict):
        for v in s.values():
            _spec_leaves(v, out)
    return out


def analyze(fn: Callable, args, *, name: str, scale: SymbolicScale,
            input_ivals=None, rules=("W1", "W2", "W3")) -> AbsintReport:
    """Run ``fn(*args)`` once under an :class:`AbsTrace` and analyze the
    record. ``input_ivals``: one spec per positional argument — None (every
    tensor leaf unknown), one ``Ival`` (broadcast over the argument's
    tensor leaves), or a structure-matching tree of Ival/None. The index
    dtype is the caller's (``index_dtype=`` of the entry point)."""
    trace = AbsTrace()
    specs = list(input_ivals or [])
    specs += [None] * (len(args) - len(specs))
    for a, s in zip(args, specs):
        leaves = _flat(a, [])
        if s is None or isinstance(s, Ival):
            ivals = [s] * len(leaves)
        else:
            ivals = _spec_leaves(s, [])
            if len(ivals) != len(leaves):
                raise ValueError(f"input_ivals: {len(ivals)} specs for "
                                 f"{len(leaves)} tensors of an argument")
        for t, iv in zip(leaves, ivals):
            trace.register(t, iv)
    with trace:
        out = fn(*args)
    return analyze_trace(trace, name=name, scale=scale, outputs=out,
                         rules=rules)
