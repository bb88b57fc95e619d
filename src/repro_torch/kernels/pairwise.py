"""ε-neighbour counts and min core labels over candidate tiles; port of the
Pallas TPU kernels ``stencil_count``, ``stencil_min_label``,
``pairwise_count`` and ``pairwise_min_label``
(``repro/kernels/pairwise.py:166``, ``:197``, ``:91`` and ``:113``).

Two candidate sets, two epilogues, one CUDA template (``csrc/pairwise.cu``):

* **stencil** — points binned into ε-cells of a fixed capacity C,
  ``cell_pts`` (ncells+1, C, D) padded with ``BIG``, the last cell all
  padding (the sink); each slot of cell ``i`` is tested against every slot
  of the cells ``nbr_map[i, :]``. Padded query slots hold garbage, as in the
  reference (``BIG`` against ``BIG`` gives d² = 0).
* **all pairs** — every row of ``x`` (m, D) against every row of ``y`` (n, D).

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
``addcmul``), so nothing fuses or reorders; the kernel rounds each step
with ``__fmul_rn``/``__fadd_rn``/``__fsub_rn``. Kernel and plain version
are then equal bit for bit at every slot, the padded ones included.
Against JAX they agree away from ties at ε only: XLA's ``dot_general``
may sum in another order.

A wrapper launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; ``<wrapper>.launches`` counts kernel launches. ``nbr_map``
entries outside ``[0, ncells]`` read the sink cell in both.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

BIG = 1e15                  # padding coordinate; BIG**2 is finite in float32
SENTINEL_LABEL = 2**31 - 1  # int32 max: "no core neighbour"

__all__ = ["BIG", "SENTINEL_LABEL", "stencil_count", "stencil_min_label",
           "pairwise_count", "pairwise_min_label", "stencil_count_plain",
           "stencil_min_label_plain", "pairwise_count_plain",
           "pairwise_min_label_plain"]

# Elements of one (rows, candidates) distance tile in the plain versions.
_PLAIN_TILE = 1 << 24

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("pairwise")
    lib.stencil_count.argtypes = [_P, _P, _I, _I, _I, _I, _F, _P, _P]
    lib.stencil_min_label.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _F,
                                      _P, _P]
    lib.pairwise_count.argtypes = [_P, _P, _I, _I, _I, _F, _P, _P]
    lib.pairwise_min_label.argtypes = [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P]
    for fn in (lib.stencil_count, lib.stencil_min_label, lib.pairwise_count,
               lib.pairwise_min_label):
        fn.restype = _I
    lib.cuda_error_string.argtypes = [_I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _sq_norms(p: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (...): Σ p_k·p_k left to right, from zero."""
    acc = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    for k in range(p.shape[-1]):
        v = p[..., k]
        acc = acc + v * v
    return acc


def _hits(q, qn, c, cn, eps2: float) -> torch.Tensor:
    """(..., A, D) queries and (..., B, D) candidates with their squared
    norms -> (..., A, B) bool, d2 <= eps2 in the contract's order."""
    xy = torch.zeros(q.shape[:-1] + (c.shape[-2],), dtype=torch.float32,
                     device=q.device)
    for k in range(q.shape[-1]):
        xy = xy + q[..., :, None, k] * c[..., None, :, k]
    d2 = (qn[..., :, None] + cn[..., None, :]) - 2.0 * xy
    return d2 <= torch.tensor(eps2, dtype=torch.float32)


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
    norms = _sq_norms(cell_pts)                       # (ncells+1, C)
    step = max(1, _PLAIN_TILE // max(1, s * cap * cap))
    for lo in range(0, ncells, step):
        hi = min(ncells, lo + step)
        # All S stencil cells of a cell at once: (S·C) candidates per slot.
        cand = _sink_safe(nbr_map[lo:hi], ncells).reshape(-1)
        c = cell_pts[cand].reshape(hi - lo, s * cap, d)
        cn = norms[cand].reshape(hi - lo, s * cap)
        hit = _hits(cell_pts[lo:hi], norms[lo:hi], c, cn, eps2)
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
    xn, yn = _sq_norms(x), _sq_norms(y)
    step = max(1, _PLAIN_TILE // n)
    for lo in range(0, m, step):
        hi = min(m, lo + step)
        hit = _hits(x[lo:hi], xn[lo:hi], y, yn, eps2)
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


def _launch(name: str, shape, device, *args) -> tuple[torch.Tensor, bool]:
    """An int32 output of ``shape`` filled by the C entry point ``name``
    (``args``, then the output and the stream), and whether it launched:
    an empty output launches nothing."""
    out = torch.empty(shape, dtype=torch.int32, device=device)
    if out.numel() == 0:
        return out, False
    lib = _lib()
    code = getattr(lib, name)(*args, out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, name)
    return out, True


def stencil_count(cell_pts: torch.Tensor, nbr_map: torch.Tensor,
                  eps2: float) -> torch.Tensor:
    """(ncells, C) int32 ε-counts per slot over the stencil ``nbr_map``
    (ncells, S) of the slot-padded cells ``cell_pts`` (ncells+1, C, D)."""
    _check_stencil(cell_pts, nbr_map)
    if not cell_pts.is_cuda:
        return stencil_count_plain(cell_pts, nbr_map, eps2)
    _, cap, d = cell_pts.shape
    ncells, s = nbr_map.shape
    out, launched = _launch("stencil_count", (ncells, cap), cell_pts.device,
                            cell_pts.data_ptr(), nbr_map.data_ptr(), ncells,
                            cap, d, s, eps2)
    stencil_count.launches += launched
    return out


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
    out, launched = _launch("stencil_min_label", (ncells, cap),
                            cell_pts.device, cell_pts.data_ptr(),
                            cell_labels.data_ptr(), cell_core.data_ptr(),
                            nbr_map.data_ptr(), ncells, cap, d, s, eps2)
    stencil_min_label.launches += launched
    return out


def pairwise_count(x: torch.Tensor, y: torch.Tensor, eps2: float) -> torch.Tensor:
    """(m,) int32: the rows of ``y`` (n, D) within eps2 of each row of
    ``x`` (m, D)."""
    _check_pairwise(x, y)
    if not x.is_cuda:
        return pairwise_count_plain(x, y, eps2)
    (m, d), n = x.shape, y.shape[0]
    xt = x.t().contiguous()      # (D, m): a warp reads one feature coalesced
    out, launched = _launch("pairwise_count", (m,), x.device, xt.data_ptr(),
                            y.data_ptr(), m, n, d, eps2)
    pairwise_count.launches += launched
    return out


def pairwise_min_label(x: torch.Tensor, y: torch.Tensor, labels: torch.Tensor,
                       core: torch.Tensor, eps2: float) -> torch.Tensor:
    """(m,) int32: the min ``labels[j]`` (int32) over rows ``j`` of ``y``
    with ``core[j]`` (bool) within eps2 of each row of ``x``;
    ``SENTINEL_LABEL`` where there is none."""
    _check_pairwise(x, y, labels, core)
    if not x.is_cuda:
        return pairwise_min_label_plain(x, y, labels, core, eps2)
    (m, d), n = x.shape, y.shape[0]
    xt = x.t().contiguous()
    out, launched = _launch("pairwise_min_label", (m,), x.device,
                            xt.data_ptr(), y.data_ptr(), labels.data_ptr(),
                            core.data_ptr(), m, n, d, eps2)
    pairwise_min_label.launches += launched
    return out


stencil_count.launches = 0
stencil_min_label.launches = 0
pairwise_count.launches = 0
pairwise_min_label.launches = 0
