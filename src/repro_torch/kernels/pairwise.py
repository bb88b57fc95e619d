"""ε-neighbour counts and min core labels; port of the Pallas TPU kernels
``stencil_count``, ``stencil_min_label``, ``pairwise_count`` and
``pairwise_min_label`` (``repro/kernels/pairwise.py:166``, ``:197``,
``:91`` and ``:113``).

Two candidate sets, two epilogues, two CUDA kernels in ``csrc/pairwise.cu``:

* **stencil** (``eps_kernel``) — points binned into ε-cells of a fixed
  capacity C, ``cell_pts`` (ncells+1, C, D) padded with ``BIG``, the last
  cell all padding (the sink); each slot of cell ``i`` is tested against
  every slot of the cells ``nbr_map[i, :]``. Padded query slots hold
  garbage, as in the reference (``BIG`` against ``BIG`` gives d² = 0), and
  the kernel reproduces it. It tests only what it cannot settle by slot
  class: a slot is real where a coordinate differs bitwise from
  float32(``BIG``), padded elsewhere, and every padded slot has the
  padding vector's bits, so one test of the padding vector stands for all
  of a cell's padded slots (the argument in ``csrc/pairwise.cu``). The
  classes come from a prologue, :func:`slot_classes` (C bits a cell),
  made once for all launches on one ``cell_pts`` inside
  :func:`shared_classes`; MIN_LABEL also needs minP, the least label over
  a cell's padded core slots, made per launch. A warp per query cell
  compacts its stencil's real slots and tests them 32 at a time.
* **all pairs** (``pairwise_tile_kernel``) — every row of ``x`` (m, D)
  against every row of ``y`` (n, D). Bound by operations: 2D + 4 per pair,
  each one FP32 instruction since no FMA is allowed, so the floor is the
  SMs' FP32 issue rate (128 lanes a clock each). The kernel is shaped as a
  register-tiled SGEMM: 128 × 128 tiles, an 8 × 8 micro-tile of
  accumulators per thread, both operands k-major in shared memory through
  double-buffered ``cp.async``.

Epilogues: COUNT, the number of candidates with d² <= eps2; MIN_LABEL, the
min label over candidates within eps2 whose core flag is set,
``SENTINEL_LABEL`` when there is none.

The order of arithmetic is the contract, and it is the reference's
formula, not the exact Σ(x−y)² of the rest of the port (ROADMAP C2)::

    xx = ((x0·x0 + x1·x1) + x2·x2) + …      (yy the same)
    xy = ((x0·y0 + x1·y1) + x2·y2) + …
    d2 = (xx + yy) − (2·xy);   hit = d2 <= eps2

all in float32, summed left to right over D. The plain versions use
separate torch ``*``, ``+`` and ``-`` (no matmul, no ``sum``, no
``addcmul``), so nothing fuses or reorders; the kernels round each step
with ``__fmul_rn``/``__fadd_rn``/``__fsub_rn``. XLA:CPU flushes subnormal
inputs and results to zero (ROADMAP C7), so the kernels are built with
``--ftz=true`` and the plain versions flush the inputs, each product, each
partial sum of x·y and d2 (``core.geometry.flush``); the norms' sums of
flushed squares and 2·x·y cannot be subnormal. Where every nonzero input
is at least 2^-50 in magnitude nothing can be: each product is 0 or at
least 2^-100, so every value the formula computes is a multiple of
2^-123, and the plain versions skip the flushes (:func:`_flush_needed`).
Kernel and plain version are then equal bit for bit at every slot, the
padded ones included. Against JAX they agree away from ties at ε only:
XLA's ``dot_general`` may sum in another order.

What the all-pairs wrappers allocate on the card (``torch.empty``, freed
when the call returns; the caching allocator hands the memory out again
only in the order of the stream the kernel runs on): x and y transposed
to (D, mp) and (D, np), mp and np the row counts rounded up to whole
128-row tiles, the padding zero (:func:`k_major`); a float32 scratch of
mp + np squared norms, written once by the kernel's prologue; for
MIN_LABEL an int32 scratch of np labels, ``SENTINEL_LABEL`` where the core
flag is off or the row is padding. The output is filled with 0 (COUNT) or
``SENTINEL_LABEL`` (MIN_LABEL) before the launch, since the kernel
combines partial results into it with ``atomicAdd`` or ``atomicMin``.
Padded candidates are masked by index and padded query rows are never
written, so the padding's values never reach a result. The stencil
wrappers allocate the class words, (ncells+1, ceil(C/32)) int32, unless
:func:`shared_classes` holds them, and for MIN_LABEL an int32 scratch of
ncells+1 minP values; the kernel writes every output slot once.

A wrapper launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; ``<wrapper>.launches`` counts kernel launches (one per
call that has work; the prologues are part of the launch).
``nbr_map`` entries outside ``[0, ncells]`` read the sink cell in both.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from repro_torch.core.geometry import flush
from repro_torch.kernels import _build
from repro_torch.opaque import kernel_call

BIG = 1e15                  # padding coordinate; BIG**2 is finite in float32
SENTINEL_LABEL = 2**31 - 1  # int32 max: "no core neighbour"

__all__ = ["BIG", "SENTINEL_LABEL", "TILE", "stencil_count",
           "stencil_min_label", "pairwise_count", "pairwise_min_label",
           "stencil_count_plain", "stencil_min_label_plain",
           "pairwise_count_plain", "pairwise_min_label_plain", "k_major",
           "slot_classes", "slot_classes_plain", "shared_classes"]

TILE = 128                  # rows of x per block and of y per tile (all pairs)

# Elements of one (rows, candidates) distance tile in the plain versions.
_PLAIN_TILE = 1 << 24

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("pairwise")
    lib.stencil_classes.argtypes = [_P, _I, _I, _I, _F, _P, _P]
    lib.stencil_count.argtypes = [_P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P]
    lib.stencil_min_label.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                      _F, _P, _P, _P]
    lib.pairwise_count.argtypes = [_P, _P, _I, _I, _L, _L, _I, _F, _P, _P, _P]
    lib.pairwise_min_label.argtypes = [_P, _P, _P, _P, _I, _I, _L, _L, _I, _F,
                                       _P, _P, _P, _P]
    for fn in (lib.stencil_classes, lib.stencil_count, lib.stencil_min_label,
               lib.pairwise_count, lib.pairwise_min_label):
        fn.restype = _I
    lib.cuda_error_string.argtypes = [_I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

# Inputs at least this large (or 0) make no subnormal anywhere in d2.
_NO_FLUSH_BELOW = 2.0 ** -50


def _flush_needed(*ts: torch.Tensor) -> bool:
    """Whether some nonzero input lies below 2^-50 in magnitude, so that
    a product or a sum of the contract could be subnormal (one host
    sync)."""
    return any(bool(((t != 0) & (t.abs() < _NO_FLUSH_BELOW)).any())
               for t in ts if t.numel())


def _keep(x: torch.Tensor) -> torch.Tensor:
    return x


def _sq_norms(p: torch.Tensor, ftz: bool = False) -> torch.Tensor:
    """(..., D) -> (...): Σ p_k·p_k left to right, from zero; with
    ``ftz`` (``p`` already flushed) each square flushed."""
    f = flush if ftz else _keep
    acc = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    for k in range(p.shape[-1]):
        v = p[..., k]
        acc = acc + f(v * v)
    return acc


def _d2(q, qn, c, cn, ftz: bool = False) -> torch.Tensor:
    """(..., A, D) queries and (..., B, D) candidates with their squared
    norms -> (..., A, B) float32 d2 in the contract's order; with ``ftz``
    (inputs already flushed) each product, each partial sum of x·y and d2
    flushed."""
    f = flush if ftz else _keep
    xy = torch.zeros(q.shape[:-1] + (c.shape[-2],), dtype=torch.float32,
                     device=q.device)
    for k in range(q.shape[-1]):
        xy = f(xy + f(q[..., :, None, k] * c[..., None, :, k]))
    return f((qn[..., :, None] + cn[..., None, :]) - 2.0 * xy)


def _hits(q, qn, c, cn, eps2: float, ftz: bool = False) -> torch.Tensor:
    """d2 <= eps2, (..., A, B) bool."""
    return _d2(q, qn, c, cn, ftz) <= torch.tensor(eps2, dtype=torch.float32)


def _epilogue(hit, labels, core):
    """COUNT without labels, else MIN_LABEL; ``labels``/``core`` broadcast
    against ``hit`` over its last axis."""
    if labels is None:
        return hit.sum(-1, dtype=torch.int32)
    cand = torch.where(hit & core, labels, SENTINEL_LABEL)
    return cand.amin(-1).to(torch.int32)


def _sink_safe(nbr_map: torch.Tensor, ncells: int) -> torch.Tensor:
    bad = (nbr_map < 0) | (nbr_map > ncells)
    return torch.where(bad, ncells, nbr_map).long()


def _stencil_plain(cell_pts, nbr_map, eps2, cell_labels=None, cell_core=None):
    ncells, s = nbr_map.shape
    cap = cell_pts.shape[1]
    out = torch.empty((ncells, cap), dtype=torch.int32, device=cell_pts.device)
    d = cell_pts.shape[2]
    ftz = _flush_needed(cell_pts)
    if ftz:
        cell_pts = flush(cell_pts)
    norms = _sq_norms(cell_pts, ftz)                  # (ncells+1, C)
    step = max(1, _PLAIN_TILE // max(1, s * cap * cap))
    for lo in range(0, ncells, step):
        hi = min(ncells, lo + step)
        # All S stencil cells of a cell at once: (S·C) candidates per slot.
        cand = _sink_safe(nbr_map[lo:hi], ncells).reshape(-1)
        c = cell_pts[cand].reshape(hi - lo, s * cap, d)
        cn = norms[cand].reshape(hi - lo, s * cap)
        hit = _hits(cell_pts[lo:hi], norms[lo:hi], c, cn, eps2, ftz)
        if cell_labels is None:
            out[lo:hi] = _epilogue(hit, None, None)
        else:
            lab = cell_labels[cand].reshape(hi - lo, 1, s * cap)
            core = cell_core[cand].reshape(hi - lo, 1, s * cap)
            out[lo:hi] = _epilogue(hit, lab, core)
    return out


def _pairwise_plain(x, y, eps2, labels=None, core=None):
    m, n = x.shape[0], y.shape[0]
    fill = 0 if labels is None else SENTINEL_LABEL
    out = torch.full((m,), fill, dtype=torch.int32, device=x.device)
    if n == 0:
        return out
    ftz = _flush_needed(x, y)
    if ftz:
        x, y = flush(x), flush(y)
    xn, yn = _sq_norms(x, ftz), _sq_norms(y, ftz)
    step = max(1, _PLAIN_TILE // n)
    for lo in range(0, m, step):
        hi = min(m, lo + step)
        hit = _hits(x[lo:hi], xn[lo:hi], y, yn, eps2, ftz)
        out[lo:hi] = _epilogue(hit, labels, core)
    return out


def stencil_count_plain(cell_pts, nbr_map, eps2: float) -> torch.Tensor:
    """(ncells, C) int32: per slot, the candidates in its stencil cells
    within eps2 (garbage at padded slots, as the kernel's)."""
    return _stencil_plain(cell_pts, nbr_map, eps2)


def stencil_min_label_plain(cell_pts, cell_labels, cell_core, nbr_map,
                            eps2: float) -> torch.Tensor:
    """(ncells, C) int32: per slot, the min ``cell_labels`` over core
    candidates in its stencil within eps2, ``SENTINEL_LABEL`` if none."""
    return _stencil_plain(cell_pts, nbr_map, eps2, cell_labels, cell_core)


def slot_classes_plain(cell_pts: torch.Tensor) -> torch.Tensor:
    """(ncells+1, ceil(C/32)) int32 words: bit j % 32 of word j // 32 is
    set where slot j is real, a coordinate differing bitwise from
    float32(``BIG``)."""
    n1, cap, _ = cell_pts.shape
    big = torch.tensor(BIG, dtype=torch.float32).view(torch.int32)
    real = (cell_pts.view(torch.int32) != big.to(cell_pts.device)).any(-1)
    words = -(-cap // 32)
    bits = torch.zeros((n1, words * 32), dtype=torch.int64,
                       device=cell_pts.device)
    bits[:, :cap] = real
    shifts = torch.arange(32, dtype=torch.int64, device=cell_pts.device)
    packed = (bits.view(n1, words, 32) << shifts).sum(-1)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def pairwise_count_plain(x, y, eps2: float) -> torch.Tensor:
    """(m,) int32: the rows of ``y`` within eps2 of each row of ``x``."""
    return _pairwise_plain(x, y, eps2)


def pairwise_min_label_plain(x, y, labels, core, eps2: float) -> torch.Tensor:
    """(m,) int32: the min ``labels[j]`` over core rows ``j`` of ``y``
    within eps2 of each row of ``x``, ``SENTINEL_LABEL`` if none."""
    return _pairwise_plain(x, y, eps2, labels, core)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_points(name: str, t: torch.Tensor, ndim: int) -> None:
    _check(t.ndim == ndim and t.dtype == torch.float32 and t.is_contiguous(),
           f"{name} must be a contiguous {ndim}-d float32 tensor, got "
           f"{tuple(t.shape)} {t.dtype}")


def _check_stencil(cell_pts, nbr_map, labels=None, core=None):
    _check_points("cell_pts", cell_pts, 3)
    ncells_p1, cap, _ = cell_pts.shape
    _check(nbr_map.ndim == 2 and nbr_map.dtype == torch.int32
           and nbr_map.is_contiguous() and nbr_map.shape[0] + 1 == ncells_p1,
           "nbr_map must be a contiguous (ncells, S) int32 tensor, "
           "ncells + 1 == cell_pts.shape[0]")
    _check(ncells_p1 <= 2**31 - 1, "more cells than int32 indexes")
    tensors = [nbr_map]
    if labels is not None:
        _check(labels.shape == (ncells_p1, cap) and labels.dtype == torch.int32
               and labels.is_contiguous(),
               "cell_labels must be a contiguous (ncells+1, C) int32 tensor")
        _check(core.shape == (ncells_p1, cap) and core.dtype == torch.bool
               and core.is_contiguous(),
               "cell_core must be a contiguous (ncells+1, C) bool tensor")
        tensors += [labels, core]
    _check(all(t.device == cell_pts.device for t in tensors),
           "all inputs must be on one device")


def _check_pairwise(x, y, labels=None, core=None):
    _check_points("x", x, 2)
    _check_points("y", y, 2)
    _check(x.shape[1] == y.shape[1], "x and y need the same feature count")
    _check(max(x.shape[0], y.shape[0]) <= 2**31 - 1, "rows past int32")
    tensors = [y]
    if labels is not None:
        n = y.shape[0]
        _check(labels.shape == (n,) and labels.dtype == torch.int32
               and labels.is_contiguous(), "labels must be contiguous (n,) int32")
        _check(core.shape == (n,) and core.dtype == torch.bool
               and core.is_contiguous(), "core must be contiguous (n,) bool")
        tensors += [labels, core]
    _check(all(t.device == x.device for t in tensors),
           "all inputs must be on one device")


def _launch(name: str, out: torch.Tensor, *args) -> None:
    """Run the C entry point ``name`` on ``args``, then ``out`` and the
    current stream; raise on a CUDA error."""
    lib = _lib()
    code = getattr(lib, name)(*args, out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, name)


@kernel_call
def slot_classes(cell_pts: torch.Tensor) -> torch.Tensor:
    """:func:`slot_classes_plain`; on the card the stencil kernels'
    prologue (``real_mask_kernel``) writes it."""
    _check_points("cell_pts", cell_pts, 3)
    if not cell_pts.is_cuda:
        return slot_classes_plain(cell_pts)
    n1, cap, d = cell_pts.shape
    real = torch.empty((n1, -(-cap // 32)), dtype=torch.int32,
                       device=cell_pts.device)
    if real.numel():
        _launch("stencil_classes", real, cell_pts.data_ptr(), n1 - 1, cap, d,
                BIG)
    return real


_open = threading.local()   # .classes: [cell_pts, words or None] per block


@contextlib.contextmanager
def shared_classes(cell_pts: torch.Tensor):
    """Inside the block, this thread's stencil launches on ``cell_pts``
    (this very tensor, which must not change there) share one
    :func:`slot_classes`, made at the first launch, instead of making it
    at each launch."""
    held = _open.__dict__.setdefault("classes", [])
    held.append([cell_pts, None])
    try:
        yield
    finally:
        held.pop()


def _classes(cell_pts: torch.Tensor) -> torch.Tensor:
    for entry in getattr(_open, "classes", ()):
        if entry[0] is cell_pts:
            if entry[1] is None:
                entry[1] = slot_classes(cell_pts)
            return entry[1]
    return slot_classes(cell_pts)


@kernel_call
def stencil_count(cell_pts: torch.Tensor, nbr_map: torch.Tensor,
                  eps2: float) -> torch.Tensor:
    """(ncells, C) int32 ε-counts per slot over the stencil ``nbr_map``
    (ncells, S) of the slot-padded cells ``cell_pts`` (ncells+1, C, D)."""
    _check_stencil(cell_pts, nbr_map)
    if not cell_pts.is_cuda:
        return stencil_count_plain(cell_pts, nbr_map, eps2)
    _, cap, d = cell_pts.shape
    ncells, s = nbr_map.shape
    out = torch.empty((ncells, cap), dtype=torch.int32, device=cell_pts.device)
    if out.numel():
        real = _classes(cell_pts)
        _launch("stencil_count", out, cell_pts.data_ptr(), nbr_map.data_ptr(),
                real.data_ptr(), ncells, cap, d, s, BIG, eps2)
        _build.count_launch(stencil_count)
    return out


@kernel_call
def stencil_min_label(cell_pts: torch.Tensor, cell_labels: torch.Tensor,
                      cell_core: torch.Tensor, nbr_map: torch.Tensor,
                      eps2: float) -> torch.Tensor:
    """(ncells, C) int32: per slot, the min ``cell_labels`` (ncells+1, C)
    over core slots (``cell_core``, bool) of its stencil within eps2;
    ``SENTINEL_LABEL`` where there is none."""
    _check_stencil(cell_pts, nbr_map, cell_labels, cell_core)
    if not cell_pts.is_cuda:
        return stencil_min_label_plain(cell_pts, cell_labels, cell_core,
                                       nbr_map, eps2)
    _, cap, d = cell_pts.shape
    ncells, s = nbr_map.shape
    out = torch.empty((ncells, cap), dtype=torch.int32, device=cell_pts.device)
    if out.numel():
        real = _classes(cell_pts)
        pad_min = torch.empty((ncells + 1,), dtype=torch.int32,
                              device=cell_pts.device)
        _launch("stencil_min_label", out, cell_pts.data_ptr(),
                cell_labels.data_ptr(), cell_core.data_ptr(),
                nbr_map.data_ptr(), real.data_ptr(), ncells, cap, d, s, BIG,
                eps2, pad_min.data_ptr())
        _build.count_launch(stencil_min_label)
    return out


def k_major(t: torch.Tensor) -> torch.Tensor:
    """(r, D) -> (D, rp) float32: ``t`` transposed, its rows rounded up to
    whole ``TILE``-row tiles with zeros, so that one feature of a tile is
    one aligned run of memory."""
    r, d = t.shape
    rp = -(-r // TILE) * TILE
    out = torch.empty((d, rp), dtype=torch.float32, device=t.device)
    out[:, :r] = t.t()
    out[:, r:] = 0.0
    return out


def _pairwise_kernel(name: str, out, x, y, eps2, labels=None, core=None) -> bool:
    """Launch the all-pairs kernel ``name`` into ``out``, already filled
    with its epilogue's neutral value; whether it launched: with no pair
    there is nothing to do."""
    (m, d), n = x.shape, y.shape[0]
    if not (m and n):
        return False
    xt, yt = k_major(x), k_major(y)
    mp, np_ = xt.shape[1], yt.shape[1]
    norms = torch.empty((mp + np_,), dtype=torch.float32, device=x.device)
    if labels is None:
        _launch(name, out, xt.data_ptr(), yt.data_ptr(), m, n, mp, np_, d,
                eps2, norms.data_ptr())
    else:
        lc = torch.empty((np_,), dtype=torch.int32, device=x.device)
        _launch(name, out, xt.data_ptr(), yt.data_ptr(), labels.data_ptr(),
                core.data_ptr(), m, n, mp, np_, d, eps2, norms.data_ptr(),
                lc.data_ptr())
    return True


@kernel_call
def pairwise_count(x: torch.Tensor, y: torch.Tensor, eps2: float) -> torch.Tensor:
    """(m,) int32: the rows of ``y`` (n, D) within eps2 of each row of
    ``x`` (m, D)."""
    _check_pairwise(x, y)
    if not x.is_cuda:
        return pairwise_count_plain(x, y, eps2)
    out = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    _build.count_launch(pairwise_count,
                        _pairwise_kernel("pairwise_count", out, x, y, eps2))
    return out


@kernel_call
def pairwise_min_label(x: torch.Tensor, y: torch.Tensor, labels: torch.Tensor,
                       core: torch.Tensor, eps2: float) -> torch.Tensor:
    """(m,) int32: the min ``labels[j]`` (int32) over rows ``j`` of ``y``
    with ``core[j]`` (bool) within eps2 of each row of ``x``;
    ``SENTINEL_LABEL`` where there is none."""
    _check_pairwise(x, y, labels, core)
    if not x.is_cuda:
        return pairwise_min_label_plain(x, y, labels, core, eps2)
    out = torch.full((x.shape[0],), SENTINEL_LABEL, dtype=torch.int32,
                     device=x.device)
    _build.count_launch(pairwise_min_label, _pairwise_kernel(
        "pairwise_min_label", out, x, y, eps2, labels, core))
    return out


stencil_count.launches = 0
stencil_min_label.launches = 0
pairwise_count.launches = 0
pairwise_min_label.launches = 0
