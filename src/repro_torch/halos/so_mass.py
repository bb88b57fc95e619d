"""Spherical-overdensity (SO) halo masses from BVH range counts; port of
``repro/halos/so_mass.py``.

Around each halo center, R_Δ is the radius where the mean enclosed
density falls to Δ times the reference density, and M_Δ = (particles
inside R_Δ) × particle_mass. The enclosed counts are ε-sphere range
counts with a radius per query, those of ``query_count`` over
``within(centers, radii)``: on the card the SO count kernel
(``wavefront_sphere_count``: a warp per halo, subtrees inside the sphere
counted whole), its plain version on the CPU.
R_Δ is located by a fixed number of bisection steps; the float32
arithmetic is the reference's, in its order.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.bvh import Bvh, build_bvh
from repro_torch.core.geometry import scene_bounds
from repro_torch.core.query import query_geometry, within
from repro_torch.device import as_tensor_on, resolve_device
from repro_torch.kernels.wavefront import shared_pack, wavefront_sphere_count

__all__ = ["SoMassResult", "sphere_counts", "so_masses",
           "so_masses_from_counts"]

# A Python float, as the reference's; it becomes float32 where it meets
# a float32 tensor.
_FOUR_THIRDS_PI = 4.0 / 3.0 * math.pi


class SoMassResult(NamedTuple):
    r_delta: torch.Tensor    # (H,) f32, SO radius (0 at invalid slots)
    m_delta: torch.Tensor    # (H,) f32, count(R_Δ) * particle_mass
    count: torch.Tensor      # (H,) int32, particles inside R_Δ
    bracketed: torch.Tensor  # (H,) bool, density fell below Δρ_ref by
    #   r_max; False means R_Δ >= r_max and r_delta/m_delta are clamped
    #   underestimates (raise r_max), not converged values.


def sphere_counts(bvh: Bvh, points, centers: torch.Tensor,
                  radii) -> torch.Tensor:
    """Range counts (int32) with a radius per query (``radii``: scalar or
    (q,)), ``query_count(bvh, within(centers, radii))``'s, squared as it
    squares them. ``points`` is kept for the reference's signature; the
    tree's leaves are the points."""
    del points
    qa, qb, _ = query_geometry(within(centers.to(torch.float32), radii))
    return wavefront_sphere_count(bvh, qa, qb)


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def so_masses_from_counts(count_fn, centers: torch.Tensor,
                          valid: torch.Tensor, *, delta, particle_mass,
                          n_particles, box_volume, r_max,
                          iters: int) -> SoMassResult:
    """The bisection, whatever gives the counts:
    ``count_fn(centers, radii) -> (H,) int`` returns the enclosed particle
    counts. ``n_particles`` is the particle count that defines the
    reference density ``n × particle_mass / box_volume``. It calls
    ``count_fn`` ``iters + 2`` times."""
    dev = centers.device
    rho_ref = (_f32(delta, dev) * _f32(n_particles, dev)
               * _f32(particle_mass, dev) / _f32(box_volume, dev))
    m = _f32(particle_mass, dev)
    valid_f = valid.to(torch.float32)

    def density(cnt, r):
        return cnt.to(torch.float32) * m / (_FOUR_THIRDS_PI * (r * r * r))

    r0 = torch.full((centers.shape[0],), float(r_max), dtype=torch.float32,
                    device=dev)
    r_lo, r_hi = torch.zeros_like(r0), r0
    for _ in range(iters):
        mid = 0.5 * (r_lo + r_hi)
        cnt = count_fn(centers, mid * valid_f)
        above = density(cnt, torch.clamp(mid, min=1e-12)) >= rho_ref
        r_lo, r_hi = torch.where(above, mid, r_lo), torch.where(above, r_hi, mid)
    r_delta = torch.where(valid, r_lo, 0.0)
    count = count_fn(centers, r_delta * valid_f)
    count = torch.where(valid, count, 0).to(torch.int32)
    # Bracket check: did the density cross Δρ_ref inside [0, r_max]?
    cnt_edge = count_fn(centers, r0 * valid_f)
    return SoMassResult(r_delta=r_delta,
                        m_delta=count.to(torch.float32) * m,
                        count=count,
                        bracketed=valid & (density(cnt_edge, r0) < rho_ref))


def so_masses(points, centers, valid, *, delta=200.0, particle_mass=1.0,
              box_volume=1.0, r_max=0.25, iters: int = 20,
              bvh: Bvh | None = None, use_64bit: bool = True,
              device=None) -> SoMassResult:
    """M_Δ / R_Δ around ``centers`` (e.g. the catalog's centers or the
    most-bound centers), on ``device`` (``None``: the CUDA card; raises
    without one). ``valid`` masks real halo slots; invalid slots are
    probed at radius 0 and return zeros. ``bvh``: a tree over ``points``
    already built (on ``device``), which skips the build. Its
    ``iters + 2`` counts share one packed copy of the tree and its spans.

    The reference density is the mean particle density
    ``n × particle_mass / box_volume``."""
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    centers = as_tensor_on(centers, torch.float32, dev)
    valid = as_tensor_on(valid, torch.bool, dev)
    if bvh is None:
        bvh = build_bvh(points, *scene_bounds(points), use_64bit=use_64bit)

    def count_fn(c, r):
        return sphere_counts(bvh, points, c, r)

    with shared_pack(bvh):
        return so_masses_from_counts(
            count_fn, centers, valid, delta=delta,
            particle_mass=particle_mass, n_particles=points.shape[0],
            box_volume=box_volume, r_max=r_max, iters=iters)
