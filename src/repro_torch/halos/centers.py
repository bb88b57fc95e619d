"""Most-bound-particle halo centers from ε-truncated potentials; port of
``repro/halos/centers.py``.

Each particle's potential is the softened short-range proxy

    φ_i = − Σ_{j : r_ij ≤ ε}  1 / sqrt(r_ij² + soft²),

one ε-query per particle with the sum fused into the traversal (the
POTENTIAL epilogue of ``repro_torch.kernels.wavefront``): no neighbour
list is stored. The self term 1/soft shifts every φ alike and cannot move
a halo's argmin. The per-halo argmin is two scatter-mins over the
catalog's particle→slot map: the least potential, then the least particle
index that attains it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bvh import Bvh, build_bvh
from repro_torch.core.geometry import scene_bounds
from repro_torch.core.query import squared_radii, within
from repro_torch.device import as_tensor_on, resolve_device
from repro_torch.kernels.wavefront import wavefront_potential

_BIG = 1e30

__all__ = ["MostBoundResult", "halo_potentials", "most_bound_centers"]


class MostBoundResult(NamedTuple):
    index: torch.Tensor      # (H,) int32, most-bound particle id, -1 empty slot
    center: torch.Tensor     # (H, 3) f32, its position (0 at empty slots)
    potential: torch.Tensor  # (H,) f32, its φ (0 at empty slots)


def _soft2(eps, softening) -> float:
    """soft², squared in float32 as the reference squares it; the
    softening defaults to ε/100."""
    soft = (np.float32(eps) * np.float32(1e-2) if softening is None
            else np.float32(softening))
    return float(soft * soft)


def halo_potentials(points, eps, *, softening=None, active=None,
                    bvh: Bvh | None = None, use_64bit: bool = True,
                    device=None) -> torch.Tensor:
    """Softened ε-truncated potential per particle, (n,) float32 (lower
    is more bound), on ``device`` (``None``: the CUDA card; raises without
    one). ``active`` (bool) masks queries: the rest return 0 and, unlike
    the reference's, walk nothing (the same output). ``bvh``: a tree over
    these very ``points``, which skips the build."""
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    if active is not None:
        active = as_tensor_on(active, torch.bool, dev)
    if bvh is None:
        bvh = build_bvh(points, *scene_bounds(points), use_64bit=use_64bit)
    pred = within(points, np.float32(eps))
    # A self-join: threads take the queries in the tree's leaf order.
    return wavefront_potential(bvh, pred.centers, squared_radii(pred),
                               _soft2(eps, softening), active,
                               order=bvh.leaf_perm)


def most_bound_centers(points, particle_halo, eps, *, capacity: int,
                       softening=None, bvh: Bvh | None = None,
                       use_64bit: bool = True,
                       device=None) -> MostBoundResult:
    """Per-halo most-bound-particle centers, on ``device`` (``None``: the
    CUDA card). ``particle_halo``: the catalog's (n,) particle→slot map
    (-1: no halo); only member particles are queried. Ties go to the
    least particle index; empty slots return index -1."""
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    particle_halo = as_tensor_on(particle_halo, torch.int32, dev)
    n = points.shape[0]
    member = particle_halo >= 0
    phi = halo_potentials(points, eps, softening=softening, active=member,
                          bvh=bvh, use_64bit=use_64bit, device=dev)
    slot = particle_halo.clamp(0, capacity - 1).long()
    phi_masked = torch.where(member, phi, _BIG)
    min_phi = torch.full((capacity,), _BIG, dtype=torch.float32,
                         device=dev).scatter_reduce_(0, slot, phi_masked,
                                                     "amin")
    attains = member & (phi_masked <= min_phi[slot])
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    idx = torch.full((capacity,), n, dtype=torch.int32,
                     device=dev).scatter_reduce_(0, slot,
                                                 torch.where(attains, ids, n),
                                                 "amin")
    found = idx < n
    center = torch.where(found[:, None], points[idx.clamp(0, n - 1).long()],
                         0.0)
    return MostBoundResult(index=torch.where(found, idx, -1), center=center,
                           potential=torch.where(found, min_phi, 0.0))
