"""Public wrappers around the ε-pairwise kernels; port of
``repro/kernels/ops.py`` (``eps_neighbor_counts``, ``eps_min_label``,
``cell_stencil_counts``, ``cell_stencil_min_label``).

``eps2`` is ``float32(eps)`` squared in float32, as the reference computes
it (``ops.py:77``, ``:103``). The reference pads rows to 128 with ``BIG``
and features to a multiple of 8 with zeros before its kernel; these
wrappers pad nothing. A zero feature adds an exact 0 to every sum, and a
padded row lies ~1e15 away from every real one and is sliced off as a
query, so no real row's result changes. (The all-pairs kernel's wrapper
pads its own transposed copies to whole tiles and masks the padding by
index, ``kernels/pairwise.py``.)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import pairwise as _k

__all__ = ["eps_squared", "eps_neighbor_counts", "eps_min_label",
           "cell_stencil_counts", "cell_stencil_min_label"]


def eps_squared(eps) -> float:
    """float32(eps) squared in float32, as a Python float: IEEE arithmetic
    on the host, with no tensor to read back."""
    e = np.float32(float(eps))
    return float(e * e)


def _rows(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.float32).contiguous()


def eps_neighbor_counts(x: torch.Tensor, y: torch.Tensor, eps) -> torch.Tensor:
    """(m,) int32 |N_ε(x_i)| against the point set y; any (m, d), (n, d)."""
    return _k.pairwise_count(_rows(x), _rows(y), eps_squared(eps))


def eps_min_label(x: torch.Tensor, y: torch.Tensor, labels: torch.Tensor,
                  core: torch.Tensor, eps) -> torch.Tensor:
    """(m,) int32 min label over ε-reachable core y-points;
    ``SENTINEL_LABEL`` when there is none."""
    return _k.pairwise_min_label(_rows(x), _rows(y),
                                 labels.to(torch.int32).contiguous(),
                                 core.to(torch.bool).contiguous(),
                                 eps_squared(eps))


def cell_stencil_counts(cell_pts: torch.Tensor, nbr_map: torch.Tensor,
                        eps) -> torch.Tensor:
    """(ncells+1, C, D) slot-padded cells -> (ncells, C) ε-counts."""
    return _k.stencil_count(cell_pts, nbr_map, eps_squared(eps))


def cell_stencil_min_label(cell_pts: torch.Tensor, cell_labels: torch.Tensor,
                           cell_core: torch.Tensor, nbr_map: torch.Tensor,
                           eps) -> torch.Tensor:
    """(ncells, C) min label over ε-reachable core slots of the stencil."""
    return _k.stencil_min_label(cell_pts, cell_labels, cell_core, nbr_map,
                                eps_squared(eps))
