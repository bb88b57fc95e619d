"""Halo catalogs from DBSCAN labels; port of ``repro/halos/catalog.py``.

1. ``canonicalize_labels``: a stable sort by root label (noise last) and
   ``cumsum`` of run heads give dense provisional halo ids in ascending-root
   order; ids past ``capacity`` are dropped and flagged.
2. ``feature_sums``: the 8-wide row ``[1, x, y, z, vx, vy, vz, |v|²]`` of
   each sorted particle is summed per halo by ``segment_sum_sorted``.
3. ``derive_catalog``: centers, mean velocities, dispersions, the mass cut
   and a stable compaction; ``halo_catalog`` adds the max radius through
   ``segment_max_sorted``.

The device of the inputs decides the path: the CUDA segment kernels on the
card, their plain versions on the CPU. Labels keep their dtype, int32 or
int64 (the sharded path's global ids), and so does ``root``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import as_tensor_on, resolve_device
from repro_torch.kernels.segment import (SEG_NEG_BIG, segment_max_sorted,
                                         segment_sum_sorted)

NOISE = -1

__all__ = ["NOISE", "HaloCatalog", "canonicalize_labels", "feature_sums",
           "derive_catalog", "halo_catalog"]


def _sort_last(dtype: torch.dtype) -> int:
    """The sort-to-the-back sentinel of a label dtype: its iinfo max, so
    that int64 global labels keep a sentinel above every real root."""
    return torch.iinfo(dtype).max


class HaloCatalog(NamedTuple):
    """Fixed-capacity halo catalog. Valid halos occupy slots
    ``0..num_halos-1`` (ascending DBSCAN root label); the rest are zeroed
    with ``root == -1``."""

    num_halos: torch.Tensor      # () int32, halos surviving the mass cut
    overflow: torch.Tensor       # () bool, provisional halos exceeded capacity
    root: torch.Tensor           # (H,) label dtype, DBSCAN root label, -1 empty
    count: torch.Tensor          # (H,) int32, particles in halo
    mass: torch.Tensor           # (H,) f32, count * particle_mass
    center: torch.Tensor         # (H, 3) f32, center of mass
    vmean: torch.Tensor          # (H, 3) f32, mean velocity
    vdisp: torch.Tensor          # (H,) f32, 3-D velocity dispersion
    rmax: torch.Tensor           # (H,) f32, max |x - center| over members
    particle_halo: torch.Tensor  # (n,) int32, final slot per particle, -1 none


def label_dtype(labels) -> torch.dtype:
    """int64 for int64 labels (a tensor or an array), int32 otherwise."""
    dt = labels.dtype if isinstance(labels, torch.Tensor) else \
        np.asarray(labels).dtype
    return torch.int64 if dt in (torch.int64, np.int64) else torch.int32


def _sum3(a: torch.Tensor) -> torch.Tensor:
    """Sum over a last axis of 3, left to right, as XLA sums it."""
    return (a[:, 0] + a[:, 1]) + a[:, 2]


def canonicalize_labels(labels: torch.Tensor, capacity: int):
    """Labels -> dense provisional halo ids.

    Returns ``(perm, pid_sorted, labels_sorted, member_sorted, nprov,
    overflow)`` as the reference does: ``perm`` sorts particles by root
    (noise last); ``pid_sorted`` is clipped into ``[0, capacity)``;
    ``member_sorted`` is False for noise and for halos past capacity."""
    n = labels.shape[0]
    valid = labels >= 0
    key = torch.where(valid, labels, _sort_last(labels.dtype))
    perm = torch.sort(key, stable=True).indices
    lab_s = labels[perm]
    valid_s = valid[perm]
    head = valid_s.clone()
    head[1:] &= lab_s[1:] != lab_s[:-1]
    pid_raw = torch.cumsum(head.to(torch.int32), 0, dtype=torch.int32) - 1
    nprov = pid_raw[-1] + 1 if n else torch.zeros((), dtype=torch.int32,
                                                  device=labels.device)
    overflow = nprov > capacity
    member_s = valid_s & (pid_raw < capacity)
    pid_s = pid_raw.clamp(0, capacity - 1)
    return perm.to(torch.int32), pid_s, lab_s, member_s, nprov, overflow


def feature_sums(points, velocities, labels, *, capacity: int):
    """Per-provisional-halo raw sums ``[count, Σx, Σv, Σ|v|²]`` (H, 8),
    the root label per halo and the canonicalization artifacts."""
    perm, pid_s, lab_s, member_s, nprov, overflow = \
        canonicalize_labels(labels, capacity)
    pl = perm.long()
    pts_s = points[pl].float()
    vel_s = velocities[pl].float()
    w = member_s.float()[:, None]
    feats = torch.cat([w, pts_s * w, vel_s * w,
                       _sum3(vel_s * vel_s)[:, None] * w], dim=1).contiguous()
    sums = segment_sum_sorted(feats, pid_s, capacity)
    sl = _sort_last(lab_s.dtype)
    root = torch.full((capacity,), sl, dtype=lab_s.dtype, device=labels.device)
    root = root.scatter_reduce(0, pid_s.long(),
                               torch.where(member_s, lab_s, sl), "amin",
                               include_self=True)
    root = torch.where(root == sl, NOISE, root)
    return sums, root, overflow, perm, pid_s, member_s


def derive_catalog(sums, root, min_count, particle_mass, d: int = 3):
    """Raw sums -> derived per-halo quantities, mass cut and a stable
    compaction. Returns ``(num_halos, root, count, mass, center, vmean,
    vdisp, slot_of_prov)``; ``slot_of_prov[p]`` is provisional halo p's
    final slot, -1 if cut."""
    capacity = sums.shape[0]
    dev = sums.device
    cnt_f = sums[:, 0]
    count = torch.round(cnt_f).to(torch.int32)
    safe = torch.clamp(cnt_f, min=1.0)
    center = sums[:, 1:1 + d] / safe[:, None]
    vmean = sums[:, 1 + d:1 + 2 * d] / safe[:, None]
    ev2 = sums[:, 1 + 2 * d] / safe
    vdisp = torch.sqrt(torch.clamp(ev2 - _sum3(vmean * vmean), min=0.0))

    keep = count >= max(int(min_count), 1)
    order = torch.sort((~keep).to(torch.int8), stable=True).indices
    kept = keep[order]
    num_halos = keep.sum(dtype=torch.int32)
    slots = torch.arange(capacity, dtype=torch.int32, device=dev)
    slot_of_prov = torch.empty_like(slots).scatter_(0, order, slots)
    slot_of_prov = torch.where(keep, slot_of_prov, -1)

    def compact(a, fill):
        out = a[order]
        mask = kept if a.ndim == 1 else kept[:, None]
        return torch.where(mask, out, torch.full_like(out, fill))

    mass = cnt_f * torch.tensor(particle_mass, dtype=torch.float32, device=dev)
    return (num_halos, compact(root, NOISE), compact(count, 0),
            compact(mass, 0.0), compact(center, 0.0), compact(vmean, 0.0),
            compact(vdisp, 0.0), slot_of_prov)


def halo_catalog(points, velocities, labels, *, capacity: int, min_count=2,
                 particle_mass=1.0, device=None) -> HaloCatalog:
    """DBSCAN labels + phase-space coordinates -> halo catalog, on
    ``device`` (``None``: the CUDA card; raises without one).

    ``labels``: (n,) int32 or int64 cluster roots (an int64 numpy array
    stays int64; other integer types become int32), noise = -1; ``root``
    keeps their dtype. ``capacity``: max halos; more sets ``overflow`` and
    drops the largest-root surplus. ``min_count``: minimum members (the
    mass cut)."""
    dev = resolve_device(device)
    points = as_tensor_on(points, torch.float32, dev)
    velocities = as_tensor_on(velocities, torch.float32, dev)
    labels = as_tensor_on(labels, label_dtype(labels), dev)
    n, d = points.shape
    sums, root_p, overflow, perm, pid_s, member_s = feature_sums(
        points, velocities, labels, capacity=capacity)
    (num_halos, root, count, mass, center, vmean, vdisp,
     slot_of_prov) = derive_catalog(sums, root_p, min_count, particle_mass, d)

    # Second pass: max radius about the provisional center of mass.
    center_p = sums[:, 1:1 + d] / torch.clamp(sums[:, 0], min=1.0)[:, None]
    diff = points[perm.long()] - center_p[pid_s.long()]
    r2_s = torch.where(member_s, _sum3(diff * diff), -SEG_NEG_BIG)
    rmax2_p = segment_max_sorted(r2_s[:, None].contiguous(), pid_s,
                                 capacity)[:, 0]
    rmax_p = torch.sqrt(torch.clamp(rmax2_p, min=0.0))
    # Route each surviving provisional halo's rmax to its compacted slot
    # (cut halos collapse onto slot 0 with a harmless 0-valued max update).
    rmax = torch.zeros(capacity, dtype=torch.float32, device=dev).scatter_reduce(
        0, slot_of_prov.clamp(0, capacity - 1).long(),
        torch.where(slot_of_prov >= 0, rmax_p, 0.0), "amax", include_self=True)

    halo_s = torch.where(member_s, slot_of_prov[pid_s.long()], -1)
    particle_halo = torch.empty(n, dtype=torch.int32, device=dev).scatter_(
        0, perm.long(), halo_s)
    return HaloCatalog(num_halos=num_halos, overflow=overflow, root=root,
                       count=count, mass=mass, center=center, vmean=vmean,
                       vdisp=vdisp, rmax=rmax, particle_halo=particle_halo)
