"""``repro_torch.staticcheck``'s scale-safety interpreter against
``repro.staticcheck``'s: every lattice transfer function returns the
reference's interval exactly on a grid of dtype edges, zero crossings and
infinities (and contains every concrete result on tiny ranges); each of
the twelve registry entries fires the reference's rules for the same name
(the reference run under ``jax.disable_jit()``, its int64 entries under
x64: a nested ``jit`` otherwise hides its body from the reference's walk,
ROADMAP C1); the analyzer's mechanics case for case with
``tests/test_absint.py``; the port's deliberate differences (Python loops
are not extrapolated, torch's negative indices, masked shifts, kernel
outputs taken whole); the index widths the interpreter proves, executed at
mocked-large sizes against the reference; and the CLI's contract.
"""
from __future__ import annotations

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.staticcheck import absint as ref_absint  # noqa: E402
from repro.staticcheck import absint_registry as ref_registry  # noqa: E402
from repro.staticcheck import lattice as rlat  # noqa: E402
from repro_torch.core.mesh import ShardMesh  # noqa: E402
from repro_torch.kernels import wavefront as kw  # noqa: E402
from repro_torch.staticcheck import __main__ as cli  # noqa: E402
from repro_torch.staticcheck import absint_registry as registry  # noqa: E402
from repro_torch.staticcheck import lattice as lat  # noqa: E402
from repro_torch.staticcheck.absint import (CollectiveUse,  # noqa: E402
                                            SymbolicScale, analyze,
                                            audit_routes, scale_for)
from repro_torch.staticcheck.lattice import Ival  # noqa: E402

N_SYM = 10**9
CPU = torch.device("cpu")


def _scale(**kw):
    return SymbolicScale(dims=scale_for(254, N_SYM), **kw)


def _rules(rep) -> list:
    return sorted({f.rule for f in rep.findings})


# --- (a) the lattice, function for function against the reference ------------

_EDGES = [-2**63, -2**31 - 1, -2**31, -7, -1, 0, 1, 3, 2**31 - 1, 2**31,
          2**63 - 1]
_FLOATS = [-math.inf, -2.5, -0.0, 0.5, 1e15, math.inf]


def _grid():
    out = []
    for vals in (_EDGES, _FLOATS):
        for i, a in enumerate(vals):
            for b in vals[i:]:
                out.append((a, b, True))
    out += [(-3, 5, False), (0, 2**31, False), (-math.inf, math.inf, False)]
    return out


_GRID = _grid()


def _same(got, want):
    """Port and reference agree: equal bounds and ``known``, or both
    ``None``."""
    if want is None or got is None:
        return got is None and want is None
    return (got.lo, got.hi, got.known) == (want.lo, want.hi, want.known) \
        and type(got.lo) is type(want.lo) and type(got.hi) is type(want.hi)


def _call(f, *args):
    try:
        return f(*args), None
    except Exception as exc:  # both sides must raise alike
        return None, type(exc)


def _both(name, *specs, extra=()):
    got = _call(getattr(lat, name), *[Ival(*s) for s in specs], *extra)
    want = _call(getattr(rlat, name), *[rlat.Ival(*s) for s in specs], *extra)
    return got, want


@pytest.mark.parametrize("name", ["join", "meet", "add", "sub", "mul", "div",
                                  "rem", "imin", "imax", "bit_and", "bit_or",
                                  "bit_xor"])
def test_lattice_binary_ops_equal_the_reference(name):
    for a in _GRID:
        for b in _GRID:
            (got, gerr), (want, werr) = _both(name, a, b)
            assert gerr == werr and _same(got, want), (name, a, b, got, want)


@pytest.mark.parametrize("name", ["neg", "iabs", "floor_op", "ceil_op",
                                  "round_op", "truncate"])
def test_lattice_unary_ops_equal_the_reference(name):
    for a in _GRID:
        (got, gerr), (want, werr) = _both(name, a)
        assert gerr == werr and _same(got, want), (name, a, got, want)


def test_lattice_shifts_counts_and_monotonic_equal_the_reference():
    ints = [s for s in _GRID if not any(isinstance(x, float) for x in s[:2])]
    shifts = [(0, 0, True), (0, 3, True), (1, 1, True), (16, 32, True),
              (-1, 2, True), (0, math.inf, True), (63, 64, False)]
    for a in ints:
        for s in shifts:
            for name, extra in (("shift_left", ()),):
                (got, gerr), (want, werr) = _both(name, a, s, extra=extra)
                assert gerr == werr and _same(got, want), (name, a, s)
            for arith in (True, False):
                got = _call(lambda x, y: lat.shift_right(x, y, arithmetic=arith),
                            Ival(*a), Ival(*s))
                want = _call(lambda x, y: rlat.shift_right(x, y,
                                                           arithmetic=arith),
                             rlat.Ival(*a), rlat.Ival(*s))
                assert got[1] == want[1] and _same(got[0], want[0]), (a, s)
    for a in _GRID:
        for count in (0, 1, 254, N_SYM, 64 * N_SYM):
            for known in (True, False):
                got = lat.scale_by_count(Ival(*a), count, known)
                want = rlat.scale_by_count(rlat.Ival(*a), count, known)
                assert _same(got, want), (a, count)
        for f in (lambda x: x, lambda x: math.exp(min(x, 700.0))):
            assert _same(lat.monotonic(Ival(*a), f),
                         rlat.monotonic(rlat.Ival(*a), f)), a
    for x in (-5, 0, 254, 2.5, -math.inf):
        assert _same(lat.const(x), rlat.const(x))
    assert _same(lat.TOP, rlat.TOP)


_DTYPES = [(torch.int8, "int8"), (torch.int16, "int16"), (torch.int32, "int32"),
           (torch.int64, "int64"), (torch.uint8, "uint8"),
           (torch.uint16, "uint16"), (torch.uint32, "uint32"),
           (torch.uint64, "uint64"), (torch.float16, "float16"),
           (torch.bfloat16, "bfloat16"), (torch.float32, "float32"),
           (torch.float64, "float64"), (torch.bool, "bool")]


@pytest.mark.parametrize("tdt,name", _DTYPES, ids=[n for _, n in _DTYPES])
def test_lattice_dtype_facts_equal_the_reference(tdt, name):
    jdt = jnp.dtype(name)
    for f in ("is_signed_int", "is_unsigned_int", "is_float", "int_bounds",
              "mantissa_bits"):
        assert getattr(lat, f)(tdt) == getattr(rlat, f)(jdt), f
    assert _same(lat.dtype_top(tdt), rlat.dtype_top(jdt))
    for mag in (0, 1.0, 3.0, 2.0**24, 1e15, math.inf):
        assert lat.ulp_at(mag, tdt) == rlat.ulp_at(mag, jdt), mag
    for a in _GRID:
        assert _same(lat.wrap_unsigned(Ival(*a), tdt),
                     rlat.wrap_unsigned(rlat.Ival(*a), jdt)), a
    # the W rules key on these: a torch dtype must never read as "no int"
    if name.startswith("int"):
        assert lat.is_signed_int(tdt) and lat.int_bounds(tdt) is not None


# brute-force containment over enumerated concrete inputs (test_absint.py)

_INTS = [Ival(-6, -2), Ival(-3, 3), Ival(0, 5), Ival(2, 7), Ival(4, 4)]


def _enum(iv):
    return np.arange(int(iv.lo), int(iv.hi) + 1, dtype=np.int64)


@pytest.mark.parametrize("op,ref", [
    ("add", lambda x, y: x + y), ("sub", lambda x, y: x - y),
    ("mul", lambda x, y: x * y), ("imin", np.minimum), ("imax", np.maximum),
])
def test_lattice_binary_ops_contain_all_concrete_results(op, ref):
    f = getattr(lat, op)
    for a in _INTS:
        for b in _INTS:
            out = f(a, b)
            xs, ys = np.meshgrid(_enum(a), _enum(b))
            got = ref(xs, ys)
            assert out.known and out.lo <= got.min() and got.max() <= out.hi


def test_lattice_division_remainder_and_bits_contain_concrete_results():
    for a in _INTS:
        for b in _INTS:
            xs, ys = np.meshgrid(_enum(a), _enum(b))
            nz = ys != 0
            if not nz.any():
                continue
            q = np.trunc(xs[nz] / ys[nz])
            r = xs[nz] - q * ys[nz]           # torch.fmod: the dividend's sign
            dq, dr = lat.truncate(lat.div(a, b)), lat.rem(a, b)
            assert dq.lo <= q.min() and q.max() <= dq.hi, (a, b, dq)
            assert dr.lo <= r.min() and r.max() <= dr.hi, (a, b, dr)
    small = [Ival(0, 7), Ival(2, 11), Ival(5, 5)]
    for a in small:
        for b in small:
            xs, ys = np.meshgrid(_enum(a), _enum(b))
            for op, ref in (("bit_and", np.bitwise_and), ("bit_or", np.bitwise_or),
                            ("bit_xor", np.bitwise_xor)):
                out, got = getattr(lat, op)(a, b), ref(xs, ys)
                assert out.lo <= got.min() and got.max() <= out.hi, (op, a, b)
        for sh in (Ival(0, 3), Ival(1, 1)):
            xs, ys = np.meshgrid(_enum(a), _enum(sh))
            out, got = lat.shift_left(a, sh), xs << ys
            assert out.lo <= got.min() and got.max() <= out.hi
            out, got = lat.shift_right(a, sh, arithmetic=True), xs >> ys
            assert out.lo <= got.min() and got.max() <= out.hi
    for a in [Ival(-2.75, 3.25), Ival(0.1, 0.9), Ival(-5.5, -1.5)]:
        xs = np.linspace(a.lo, a.hi, 37)
        for op, ref in (("floor_op", np.floor), ("ceil_op", np.ceil),
                        ("round_op", np.round), ("truncate", np.trunc)):
            out, got = getattr(lat, op)(a), ref(xs)
            assert out.lo <= got.min() and got.max() <= out.hi, (op, a)


# --- (b) the twelve registry entries against the reference -------------------

_PORT = {a.name: a for a in registry.REGISTERED_ABSINT_AUDITS
         + registry.SEEDED_FIXTURES}


@pytest.fixture(scope="module")
def ref_verdicts():
    """The rules each reference entry fires, computed once. A nested jit
    stages as ``jit`` under this JAX and the reference's walk does not
    descend into it, so the reference traces with jit disabled; its int64
    entries run under x64 (its own ``x64=True`` reaches an API this JAX no
    longer has). The CSR entries' tree is built once, compiled, outside
    the analysis, as the reference builds it outside its trace."""
    mp = pytest.MonkeyPatch()
    csr_args = ref_registry._csr_args()
    mp.setattr(ref_registry, "_csr_args", lambda: csr_args)
    runs = {a.name: a.run for a in ref_registry.REGISTERED_ABSINT_AUDITS
            + ref_registry.SEEDED_FIXTURES}
    runs["query_csr_device/int64"] = lambda fast: ref_registry._run_csr(
        fast, jnp.int64, x64=False)
    runs["sharded_neighbor_csr/int64"] = lambda fast: ref_registry._run_sharded(
        fast, jnp.int64, x64=False)
    out = {}
    with jax.disable_jit():
        for name, run in runs.items():
            if name.endswith("int64"):
                with jax.enable_x64(True):
                    out[name] = _rules(run(False))
            else:
                out[name] = _rules(run(False))
    mp.undo()
    return out


def test_registry_names_are_the_references():
    assert [a.name for a in registry.REGISTERED_ABSINT_AUDITS] == \
        [a.name for a in ref_registry.REGISTERED_ABSINT_AUDITS]
    assert [(a.name, a.expect_rules) for a in registry.SEEDED_FIXTURES] == \
        [(a.name, a.expect_rules) for a in ref_registry.SEEDED_FIXTURES]


@pytest.mark.parametrize("name", list(_PORT))
def test_registry_entry_fires_the_references_rules(name, ref_verdicts):
    audit = _PORT[name]
    rep = audit.run(CPU)
    assert _rules(rep) == ref_verdicts[name] == sorted(audit.expect_rules), \
        [str(f) for f in rep.findings]
    assert rep.values_analyzed > 0
    if not audit.expect_rules:
        # the reference's test_registered_absint_audit_clean: no unmodelled
        # op (kernel outputs are counted apart)
        assert rep.unknown_ops == 0, rep.unknown
    elif "W3-routes" not in audit.expect_rules:
        # value-level rules localize to ONE op; route tables may trip
        # several invariants at once
        assert len(rep.findings) == 1, [str(f) for f in rep.findings]


# --- (c) the analyzer's mechanics --------------------------------------------

def test_fixed_twin_min_image_is_silent():
    L = 100.0

    def min_image_fixed(dx):
        dxc = torch.clamp(dx, -L, L)
        return dxc - torch.round(dxc / L) * L

    rep = analyze(min_image_fixed, (torch.zeros(254),), name="minimg_fixed",
                  scale=_scale(), input_ivals=[Ival(-1.0e15, 1.0e15)])
    assert rep.findings == [] and rep.unknown_ops == 0


def test_fixed_twin_clipped_gather_is_silent():
    lab = torch.zeros(254, dtype=torch.int32)
    idx = torch.zeros(254, dtype=torch.int64)
    rep = analyze(lambda l, i: l[torch.clamp(i, 0, 253)], (lab, idx),
                  name="gather_fixed", scale=_scale(),
                  input_ivals=[Ival(0, 100), Ival(0, N_SYM)])
    assert rep.findings == []
    rep = analyze(lambda l, i: l.index_select(0, i), (lab, idx),
                  name="gather_unclipped", scale=_scale(),
                  input_ivals=[Ival(0, 100), Ival(0, N_SYM)])
    assert _rules(rep) == ["W3-bounds"]


def test_fixed_twin_f64_subtraction_meets_precision_floor():
    a = torch.zeros(254, dtype=torch.float64)
    rep = analyze(lambda x, y: x - y, (a, a), name="cancel_f64",
                  scale=_scale(precision_floor=1e-3),
                  input_ivals=[Ival(1.0e9, 1.1e9), Ival(1.0e9, 1.1e9)])
    assert rep.findings == []


def test_negative_indices_follow_torch_ranges():
    """torch wraps negative indices of advanced indexing itself: [-N, N-1]
    is in bounds (the reference proves the same of jnp's canonicalizing
    select), one past either end is not; ``gather`` takes [0, N-1]."""
    x = torch.zeros(254)
    i = torch.zeros(254, dtype=torch.int64)
    for ival, rules in ((Ival(-N_SYM, N_SYM - 1), []),
                        (Ival(-N_SYM - 1, N_SYM - 1), ["W3-bounds"]),
                        (Ival(-N_SYM, N_SYM), ["W3-bounds"])):
        rep = analyze(lambda a, j: a[j], (x, i), name="neg_idx",
                      scale=_scale(), input_ivals=[None, ival])
        assert _rules(rep) == rules, ival
    rep = analyze(lambda a, j: torch.gather(a, 0, j), (x, i), name="gather",
                  scale=_scale(), input_ivals=[None, Ival(-1, N_SYM - 1)])
    assert _rules(rep) == ["W3-bounds"]


def test_where_sentinel_refinement():
    """``torch.where(j < n, j, 0)`` guards a sentinel: the guarded case
    meets j < n, so the index is in bounds; ``j ± literal`` refines the
    same way, and an unguarded sentinel still fires."""
    lab = torch.zeros(254, dtype=torch.int32)
    i = torch.zeros(254, dtype=torch.int64)

    def guarded(l, j):
        return l[torch.where(j < l.shape[0], j, 0)]

    def shifted(l, j):
        return l[torch.where(j >= 1, j - 1, 0)]

    def unguarded(l, j):
        return l[torch.where(j > 5, j, 0)]

    for fn, ival, rules in ((guarded, Ival(0, N_SYM), []),
                            (shifted, Ival(0, N_SYM), []),
                            (unguarded, Ival(0, N_SYM), ["W3-bounds"])):
        rep = analyze(fn, (lab, i), name=fn.__name__, scale=_scale(),
                      input_ivals=[Ival(0, 100), ival])
        assert _rules(rep) == rules, fn.__name__
    # the reference proves the same of its cross-pjit where
    ref = ref_absint.analyze(
        lambda l, j: l[jnp.where(j < l.shape[0], j, 0)],
        (jnp.zeros(254, jnp.int32), jnp.zeros(254, jnp.int32)),
        name="where_refine", scale=ref_absint.SymbolicScale(
            dims=ref_absint.scale_for(254, N_SYM)),
        input_ivals=[rlat.Ival(0, 100), rlat.Ival(0, N_SYM)])
    assert ref.findings == []


def test_unsigned_wraparound_is_legal():
    """Unsigned results wrap (uint8 here: torch's CPU has no uint32
    multiply); the reference's uint32 magic multiply wraps alike."""
    def magic(v):
        v = v.to(torch.uint8) & 0x0F
        return (v * 0x25) & 0xF0

    rep = analyze(magic, (torch.zeros(254, dtype=torch.int32),), name="magic",
                  scale=_scale(), input_ivals=[Ival(0, 1023)])
    assert rep.findings == [] and rep.unknown_ops == 0
    assert rep.outputs == [Ival(0, 0xF0, True)]


def test_masked_left_shift_is_bit_surgery_but_an_index_is_not():
    """The port's Morton codes live in int64 (torch's CPU has no uint32
    shifts): a shift that carries bits past bit 63 and is then masked is
    the reference's unsigned wraparound; the same shift used as a number,
    or shifted back right without a mask (an arithmetic shift, which
    sign-extends the carried bit), overflows."""
    def masked(v):
        v = v & 0x1F00000000FFFF
        return (v | (v << 16)) & 0x1F0000FF0000FF

    def unmasked(v):
        return (v << 16) + 1

    def shifted_back(v):
        return (v << 16) >> 8

    def merged_then_shifted(v):
        return ((v << 16) | v) >> 8

    v = torch.zeros(254, dtype=torch.int64)
    rep = analyze(masked, (v,), name="masked", scale=_scale(),
                  input_ivals=[Ival(0, 2**62)])
    assert rep.findings == []
    for fn in (unmasked, shifted_back, merged_then_shifted):
        rep = analyze(fn, (v,), name=fn.__name__, scale=_scale(),
                      input_ivals=[Ival(0, 2**62)])
        assert _rules(rep) == ["W1-index-width"], fn.__name__


def test_narrowing_convert_fires_unless_only_an_index():
    v = torch.zeros(254, dtype=torch.int64)
    lab = torch.zeros(254)
    rep = analyze(lambda x: x.to(torch.int32) + 1, (v,), name="narrow",
                  scale=_scale(), input_ivals=[Ival(0, 2**40)])
    assert [(f.rule, k[1]) for f, k in zip(rep.findings, rep.keys)] == \
        [("W1-index-width", "_to_copy")]
    # consumed only as an index: judged by the index's bounds check
    rep = analyze(lambda l, x: l[x.to(torch.int32)], (lab, v), name="idx",
                  scale=_scale(), input_ivals=[None, Ival(0, N_SYM - 1)])
    assert rep.findings == []


def test_writes_through_views_reach_their_base():
    """A view written in place updates its base (and a buffer from
    ``empty`` holds only what was written into it)."""
    lab = torch.zeros(254, dtype=torch.int32)

    def via_view(l, j):
        idx = torch.zeros(254, dtype=torch.int64)
        idx[:5].copy_(j[:5])                # j may hold the sentinel n
        return l[idx]

    rep = analyze(via_view, (lab, torch.zeros(254, dtype=torch.int64)),
                  name="view", scale=_scale(),
                  input_ivals=[None, Ival(0, N_SYM)])
    assert _rules(rep) == ["W3-bounds"]

    def scattered(x):
        return torch.empty_like(x).scatter_(0, torch.arange(254), x)

    rep = analyze(scattered, (torch.zeros(254),), name="empty",
                  scale=_scale(), input_ivals=[Ival(-2.0, 3.0)])
    assert rep.outputs == [Ival(-2.0, 3.0, True)]


def test_symbolic_scale_reads_markers():
    sc = SymbolicScale(dims=scale_for(254, N_SYM))
    ref = ref_absint.SymbolicScale(dims=ref_absint.scale_for(254, N_SYM))
    assert scale_for(254, N_SYM, {318: 7}) == \
        ref_absint.scale_for(254, N_SYM, {318: 7})
    assert sc.dim(254) == N_SYM and sc.dim(253) == N_SYM - 1
    assert sc.dim(507) == 2 * N_SYM - 1 and sc.dim(17) == 17
    assert sc.lit(254) == N_SYM and sc.lit(True) is True
    for x in (254, 253, 255, 506, 507, 17, True, 2.5):
        assert sc.lit(x) == ref.lit(x)
    assert sc.axis_size("data", 1) == 1
    assert SymbolicScale(axes={"data": 64}).axis_size("data", 1) == 64


def test_audit_routes_unit():
    mesh = {"data": 4}
    uses = [CollectiveUse("ppermute", ("data",),
                          ((0, 1), (1, 2), (2, 3), (3, 0)), mesh),
            CollectiveUse("ppermute", ("data",), ((0, 1), (2, 1)), mesh),
            CollectiveUse("ppermute", ("data",), ((0, 7),), mesh),
            CollectiveUse("psum", ("model",), (), mesh)]
    assert audit_routes(uses[:1], "t") == []
    msgs = [f.message for f in audit_routes(uses[1:], "t")]
    assert any("duplicate destination" in m for m in msgs)
    assert any("outside the mesh axis" in m for m in msgs)
    assert any("not an axis of the enclosing mesh" in m for m in msgs)
    ref = ref_absint.audit_routes(
        [ref_absint.CollectiveUse(*u) for u in uses], "t")
    assert [(f.rule, f.message) for f in audit_routes(uses, "t")] == \
        [(f.rule, f.message) for f in ref]


def test_collectives_and_shard_index_at_the_symbolic_axis():
    """On one staged shard read as 64: the shard index spans [0, 63], a
    psum scales by 64, a ppermute with no sender joins 0, and each
    collective is recorded with its route table."""
    mesh = ShardMesh(1, "cpu")

    def body(axis, x):
        s = axis.psum(x * 1)
        p = axis.ppermute(x + 0, [(0, 0)])
        return s, p, axis.index_tensor * 1

    rep = analyze(lambda x: mesh.run(body, x)[0],
                  (torch.ones(254, dtype=torch.int32),), name="coll",
                  scale=SymbolicScale(dims=scale_for(254, N_SYM),
                                      axes={"data": 64}),
                  input_ivals=[Ival(1, 3)])
    assert rep.outputs == [Ival(0, 192, True), Ival(0, 3, True),
                           Ival(0, 63, True)]
    assert [(c.prim, c.axes, c.perm) for c in rep.collectives] == \
        [("psum", ("data",), ()), ("ppermute", ("data",), ((0, 0),))]
    assert rep.findings == []


def test_shard_index_keeps_global_ids_bit_equal():
    """``ShardAxis.index_tensor`` enters the global ids as a value; the
    ids are the old ``shard * n_loc + slot`` for both index dtypes."""
    from repro_torch.core.distributed import shard_context
    pts = torch.rand(3 * 40, 3, generator=torch.Generator().manual_seed(0))
    pts = pts[pts[:, 0].argsort()].contiguous()
    for dt in (torch.int32, torch.int64):
        gids = ShardMesh(3, "cpu").run(
            lambda axis, p: shard_context(p, 0.05, 16, axis,
                                          index_dtype=dt).gid, pts)
        for k, g in enumerate(gids):
            assert g.dtype == dt
            assert torch.equal(g, k * 40 + torch.arange(40, dtype=dt))


# --- (d) the deliberate difference: Python loops are not extrapolated --------

def test_python_loop_accumulator_is_not_extrapolated():
    """ROADMAP A16's loop difference: the reference's ``scan`` carries are
    widened linearly over the symbolic trip count, so its accumulator over
    N elements overflows int32; the port's Python loop runs the staged 254
    iterations, which the trace holds one by one, and is not extrapolated.
    A reduction over the same axis is read at symbolic N and fires."""
    def ref_acc(x):
        def body(c, xi):
            return c + xi, xi
        return jax.lax.scan(body, jnp.int32(0), x)[0]

    ref = ref_absint.analyze(
        ref_acc, (jnp.ones(254, jnp.int32),), name="scan_acc",
        scale=ref_absint.SymbolicScale(dims=ref_absint.scale_for(254, N_SYM)),
        input_ivals=[rlat.Ival(0, 2048)])
    assert [f.rule for f in ref.findings] == ["W1-index-width"]

    def loop_acc(x):
        c = torch.zeros((), dtype=torch.int32)
        for xi in x:
            c = c + xi
        return c

    x = torch.ones(254, dtype=torch.int32)
    rep = analyze(loop_acc, (x,), name="loop_acc", scale=_scale(),
                  input_ivals=[Ival(0, 2048)])
    assert rep.findings == [] and rep.outputs == [Ival(0, 254 * 2048, True)]
    rep = analyze(lambda v: v.sum(dtype=torch.int32), (x,), name="sum",
                  scale=_scale(), input_ivals=[Ival(0, 2048)])
    assert _rules(rep) == ["W1-index-width"]


# --- (e) the CLI --------------------------------------------------------------

def test_cli_absint_clean_tree_exits_zero(tmp_path, monkeypatch):
    lint_me = tmp_path / "ok.py"
    lint_me.write_text("x = 1\n")
    report, absint_report = tmp_path / "sc.json", tmp_path / "absint.json"
    rc = cli.main([str(lint_me), "--absint", "--fast", "--device", "cpu",
                   "--json", str(report), "--absint-json", str(absint_report)])
    assert rc == 0
    data = json.loads(absint_report.read_text())
    assert data["ok"]
    names = [e["name"] for e in data["entrypoints"]]
    assert "query_csr_device[int64]" in names and "fdbscan" in names
    for e in data["entrypoints"]:
        assert {"name", "values_analyzed", "ops_visited", "unknown_ops",
                "collectives", "findings"} <= set(e)
        assert e["findings"] == [] and e["unknown_ops"] == 0
    assert sum(e["values_analyzed"] for e in data["entrypoints"]) > 1000
    # a finding fails the gate
    monkeypatch.setattr(registry, "REGISTERED_ABSINT_AUDITS",
                        [_PORT["min_image/f32@BIG"]])
    rc = cli.main([str(lint_me), "--absint", "--device", "cpu",
                   "--json", str(report), "--absint-json", str(absint_report)])
    assert rc == 1 and not json.loads(absint_report.read_text())["ok"]


# --- (f) kernel outputs are taken whole, launched or plain --------------------

def test_kernel_outputs_get_one_interval_launched_or_plain(monkeypatch):
    """On the card a wrapper's outputs are buffers the kernel fills; on the
    CPU its plain version computes them. Either way the interpreter skips
    the wrapper's ops and gives the outputs their dtype's range: a
    ``zeros`` buffer standing for the launch must not read as [0, 0]."""
    bvh, pred, _ = registry._csr_args(CPU)

    def run():
        from repro_torch.core.query import query_count
        return analyze(lambda b, p: query_count(b, p), (bvh, pred),
                       name="count", scale=_scale())

    plain = run()
    monkeypatch.setattr(kw, "wavefront_count_plain",
                        lambda bvh, qa, *a, **k: torch.zeros(
                            qa.shape[0], dtype=torch.int32))
    launched = run()
    assert plain.outputs == launched.outputs == [lat.dtype_top(torch.int32)]
    assert (plain.ops_visited, plain.values_analyzed, plain.kernel_outputs) \
        == (launched.ops_visited, launched.values_analyzed,
            launched.kernel_outputs)
    assert plain.kernel_outputs == 1 and plain.unknown_ops == 0


# --- the index widths the interpreter proves, executed --------------------------

def test_csr_offsets_int64_past_2_31_at_mocked_large_counts():
    """4 queries x 2^30 mocked hits = 2^32: int64 offsets hold it (int32
    would wrap to 0), as the reference's do under x64."""
    from repro.core.bvh import build_bvh as ref_build_bvh
    from repro.core.geometry import scene_bounds as ref_scene_bounds
    from repro.core.query import query_csr_device as ref_csr
    from repro.core.query import within as ref_within
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.core.query import query_csr_device, within

    pts = np.random.default_rng(0).random((4, 3)).astype(np.float32)
    tp = torch.from_numpy(pts)
    csr = query_csr_device(build_bvh(tp, *scene_bounds(tp)), within(tp, 0.1),
                           8, counts=torch.full((4,), 2**30, dtype=torch.int64),
                           index_dtype=torch.int64)
    assert csr.offsets.dtype == torch.int64
    assert int(csr.offsets[-1]) == int(csr.total) == 2**32
    assert bool(csr.overflowed)
    with jax.enable_x64(True):
        jp = jnp.asarray(pts)
        want = ref_csr(ref_build_bvh(jp, *ref_scene_bounds(jp)),
                       ref_within(jp, 0.1), 8,
                       counts=jnp.full((4,), 2**30, jnp.int64),
                       index_dtype=jnp.int64)
        np.testing.assert_array_equal(csr.offsets.numpy(),
                                      np.asarray(want.offsets))
        assert int(want.total) == int(csr.total)
        assert bool(want.overflowed) == bool(csr.overflowed)


def test_morton_quantize_clamps_before_cast():
    """±1e15 clamps to the last and first bin in float space before the
    integer cast, as the reference's ``_quantize``; the codes equal the
    reference's (hi, lo) pair. (The int64 catalog sentinel is
    ``test_torch_merge.py``'s ``test_catalog_keeps_int64_labels``.)"""
    from repro.core.morton import _quantize, morton64 as ref_morton64
    from repro_torch.core.morton import morton64
    from repro_torch.interop import morton64_to_int64

    big = np.asarray([[1.0e15, -1.0e15, 0.5]], np.float32)
    q = _quantize(jnp.asarray(big), 1 << 21)
    assert int(q[0, 0]) == (1 << 21) - 1 and int(q[0, 1]) == 0
    got = morton64(torch.from_numpy(big))
    hi, lo = ref_morton64(jnp.asarray(big))
    assert got.dtype == torch.int64
    assert torch.equal(got, morton64_to_int64(hi, lo))
    # x in the last bin, y in the first: every x bit set, no y bit
    x_bits = sum(1 << (3 * i + 2) for i in range(21))
    assert int(got[0]) & x_bits == x_bits
    assert int(got[0]) & (x_bits >> 1) == 0
