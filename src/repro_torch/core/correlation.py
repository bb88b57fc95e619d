"""Two-point correlation pair counts; port of ``repro/core/correlation.py``
(paper §4.2.3): the pair traversal visits each unordered pair within
``r_max`` once and bins it by distance, the HISTOGRAM epilogue of the
traversal kernel (``kernels/wavefront.py``). No pair list is built.

The counts are int64, where the reference's are int32: at 2^24 particles
the pairs within a few linking lengths pass 2^31 and an int32 bin would
wrap. The Landy-Szalay-style estimator is a host-side postprocess.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bvh import build_bvh
from repro_torch.core.geometry import scene_bounds
from repro_torch.core.query import squared_radii, within
from repro_torch.device import as_tensor_on, resolve_device
from repro_torch.kernels.wavefront import pair_starts, wavefront_histogram

__all__ = ["pair_count_histogram", "two_point_correlation"]


def pair_count_histogram(points, r_max, n_bins: int = 16, *,
                         device=None) -> torch.Tensor:
    """DD(r): (n_bins,) int64 counts of unordered pairs by distance in
    ``n_bins`` equal bins over (0, r_max]: bin ``floor(sqrt(max(d², 1e-30))
    / r_max · n_bins)``, clipped, of each pair within ``r_max``. Runs on
    ``device`` (``None``: the CUDA card; raises without one)."""
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    lo, hi = scene_bounds(points)
    bvh = build_bvh(points, lo, hi)
    perm = bvh.leaf_perm.long()
    pred = within(points, r_max)
    return wavefront_histogram(bvh, points[perm].contiguous(),
                               squared_radii(pred)[perm].contiguous(),
                               float(r_max), n_bins, start=pair_starts(bvh))


def two_point_correlation(points, r_max, n_bins: int = 16, *,
                          volume: float = 1.0, device=None):
    """ξ(r) by the natural estimator DD/RR - 1 with an analytic uniform
    RR (no periodic box; fine for r_max much below the box size). Returns
    ``(xi, dd, edges)`` as numpy float64 arrays."""
    dd = pair_count_histogram(points, r_max, n_bins,
                              device=device).cpu().numpy().astype(np.float64)
    n = points.shape[0]
    edges = np.linspace(0.0, float(r_max), n_bins + 1)
    shell = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    rr = n * (n - 1) / 2.0 * shell / volume
    with np.errstate(divide="ignore", invalid="ignore"):
        xi = np.where(rr > 0, dd / rr - 1.0, 0.0)
    return xi, dd, edges
