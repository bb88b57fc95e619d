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
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

SEG_NEG_BIG = 1e30

__all__ = ["SEG_NEG_BIG", "segment_sum_sorted", "segment_max_sorted",
           "segment_sum_sorted_plain", "segment_max_sorted_plain"]

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("segment")
    for fn in (lib.segment_sum_sorted, lib.segment_max_sorted):
        fn.argtypes = [_P, _P, ctypes.c_int64, _I, _I, _P, _P]
        fn.restype = _I
    lib.cuda_error_string.argtypes = [_I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    code = getattr(lib, name)(data.data_ptr(), seg_ids.data_ptr(), n, d,
                              num_segments, out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    _build.check(lib, code, name)
    return out, True


def segment_sum_sorted(data: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """out[s, :] = sum of data[i, :] over sorted ids seg_ids[i] == s.
    The kernel's atomics add in another order than the plain version:
    sums agree to float32 rounding; a column of 1.0s (counts) is exact
    below 2^24 rows per segment."""
    if not data.is_cuda:
        return segment_sum_sorted_plain(data, seg_ids, num_segments)
    out, launched = _launch("segment_sum_sorted", data, seg_ids,
                            num_segments, 0.0)
    segment_sum_sorted.launches += launched
    return out


def segment_max_sorted(data: torch.Tensor, seg_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """out[s, :] = max of data[i, :] over sorted ids seg_ids[i] == s;
    ``-SEG_NEG_BIG`` for empty segments. Exact, whatever the order."""
    if not data.is_cuda:
        return segment_max_sorted_plain(data, seg_ids, num_segments)
    out, launched = _launch("segment_max_sorted", data, seg_ids,
                            num_segments, -SEG_NEG_BIG)
    segment_max_sorted.launches += launched
    return out


segment_sum_sorted.launches = 0
segment_max_sorted.launches = 0
