"""Segmented reductions over sorted segment ids; port of the Pallas TPU
kernels ``segment_sum_sorted`` and ``segment_max_sorted``
(``repro/kernels/segment.py:106`` and ``:133``).

Contract (as the reference): ``out[s, :]`` reduces ``data[i, :]`` over rows
with ``seg_ids[i] == s``; ids are clipped to ``[0, num_segments)``; empty
segments give 0 for the sum and ``-SEG_NEG_BIG`` for the max; ``seg_ids``
must be sorted ascending. Rows a caller wants excluded are zeroed (sum) or
set to ``-SEG_NEG_BIG`` (max), not re-labelled.

Each wrapper launches the CUDA kernel in ``csrc/segment.cu`` for CUDA
tensors and runs the plain version, a scatter-add or scatter-max as in
``repro/kernels/ref.py:47-61``, for CPU tensors. ``<wrapper>.launches``
counts wrapper calls that launched the kernel (one per call, however many
levels it takes).

The kernel combines each segment's rows in an order fixed by the row count
alone and writes each output element once, with no atomics: the same
inputs give the same bits on every call. A block of the kernel reduces
``CHUNK_ROWS`` rows and leaves two carry records (a partial and its id) for
the runs that continue past it; the records are reduced again, level by
level (:func:`carry_plan`), in scratch the wrapper allocates. Rows and ids
are read with 16-byte loads where :func:`vector_path` allows it, else by
the scalar instance.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.opaque import kernel_call

SEG_NEG_BIG = 1e30
# Rows a block of the kernel reduces (kChunk in csrc/segment.cu).
CHUNK_ROWS = 2048
# Row widths with a 16-byte-load instance: the catalog's sums and max.
VECTOR_WIDTHS = (1, 8)

__all__ = ["SEG_NEG_BIG", "CHUNK_ROWS", "VECTOR_WIDTHS", "carry_plan",
           "carry_rows", "vector_path", "segment_sum_sorted",
           "segment_max_sorted", "segment_sum_sorted_plain",
           "segment_max_sorted_plain"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("segment")
    for fn in (lib.segment_sum_sorted, lib.segment_max_sorted):
        fn.argtypes = [_P, _P, _I64, _I, _I, _I, _P, _P, _P, _I64, _P]
        fn.restype = _I
    lib.cuda_error_string.argtypes = [_I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    lib.segment_chunk_rows.restype = _I
    if lib.segment_chunk_rows() != CHUNK_ROWS:
        raise RuntimeError(f"csrc/segment.cu reduces {lib.segment_chunk_rows()} "
                           f"rows a block, CHUNK_ROWS says {CHUNK_ROWS}")
    return lib


def carry_plan(n: int, chunk: int = CHUNK_ROWS) -> list[int]:
    """Rows of each level of carry records for ``n`` rows: a level of r
    rows takes ceil(r / chunk) blocks, which leave two records each for the
    next level, until one block holds a level."""
    plan = []
    while n > chunk:
        n = 2 * -(-n // chunk)
        plan.append(n)
    return plan


def carry_rows(n: int, chunk: int = CHUNK_ROWS) -> int:
    """Rows of the carry scratch for ``n`` rows: every level of
    :func:`carry_plan`, each rounded up to 4 rows so that the next level
    starts 16-byte aligned."""
    return sum(-(-r // 4) * 4 for r in carry_plan(n, chunk))


def vector_path(data: torch.Tensor, seg_ids: torch.Tensor) -> bool:
    """Whether the kernel may read ``data`` and ``seg_ids`` with 16-byte
    loads: a width in ``VECTOR_WIDTHS`` and both bases 16-byte aligned (a
    view such as ``seg_ids[1:]`` is not). Otherwise the scalar instance runs,
    with the same results."""
    return (data.shape[1] in VECTOR_WIDTHS and data.data_ptr() % 16 == 0
            and seg_ids.data_ptr() % 16 == 0)


def _clipped(seg_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return seg_ids.long().clamp(0, num_segments - 1)


def segment_sum_sorted_plain(data, seg_ids, num_segments: int):
    seg = _clipped(seg_ids, num_segments)[:, None].expand(-1, data.shape[1])
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    return out.scatter_add_(0, seg, data.float())


def segment_max_sorted_plain(data, seg_ids, num_segments: int):
    seg = _clipped(seg_ids, num_segments)[:, None].expand(-1, data.shape[1])
    out = torch.full((num_segments, data.shape[1]), -SEG_NEG_BIG,
                     dtype=torch.float32, device=data.device)
    return out.scatter_reduce_(0, seg, data.float(), "amax", include_self=True)


def _launch(name: str, data, seg_ids, num_segments: int, fill: float):
    if data.ndim != 2 or data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError("data must be a contiguous (n, D) float32 tensor")
    if seg_ids.dtype != torch.int32 or seg_ids.shape != (data.shape[0],) \
            or not seg_ids.is_contiguous():
        raise ValueError("seg_ids must be a contiguous (n,) int32 tensor")
    if seg_ids.device != data.device:
        raise ValueError("data and seg_ids must be on one device")
    if num_segments < 1:
        raise ValueError("num_segments must be >= 1")
    n, d = data.shape
    out = torch.full((num_segments, d), fill, dtype=torch.float32,
                     device=data.device)
    if n == 0 or d == 0:
        return out, False
    lib = _lib()
    recs = carry_rows(n)
    rec_vals = torch.empty((recs, d), dtype=torch.float32, device=data.device)
    rec_ids = torch.empty(recs, dtype=torch.int32, device=data.device)
    code = getattr(lib, name)(data.data_ptr(), seg_ids.data_ptr(), n, d,
                              num_segments, int(vector_path(data, seg_ids)),
                              out.data_ptr(), rec_vals.data_ptr(),
                              rec_ids.data_ptr(), recs,
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, name)
    return out, True


@kernel_call
def segment_sum_sorted(data: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """out[s, :] = sum of data[i, :] over sorted ids seg_ids[i] == s.
    The kernel adds in a fixed order of its own, not the plain version's
    row order: the same inputs give the same bits on every call, within
    float32 rounding of the plain version; a column of 1.0s (counts) is
    exact below 2^24 rows per segment."""
    if not data.is_cuda:
        return segment_sum_sorted_plain(data, seg_ids, num_segments)
    out, launched = _launch("segment_sum_sorted", data, seg_ids,
                            num_segments, 0.0)
    _build.count_launch(segment_sum_sorted, launched)
    return out


@kernel_call
def segment_max_sorted(data: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """out[s, :] = max of data[i, :] over sorted ids seg_ids[i] == s;
    ``-SEG_NEG_BIG`` for empty segments. Exact, whatever the order."""
    if not data.is_cuda:
        return segment_max_sorted_plain(data, seg_ids, num_segments)
    out, launched = _launch("segment_max_sorted", data, seg_ids,
                            num_segments, -SEG_NEG_BIG)
    _build.count_launch(segment_max_sorted, launched)
    return out


segment_sum_sorted.launches = 0
segment_max_sorted.launches = 0
