"""Linear BVH construction; port of ``repro/core/bvh.py`` (``build_bvh``
and ``build_bvh_objects``, over 63-bit or 30-bit Morton codes).

Karras (2012) ranges over the sorted Morton codes, closed-form ropes and a
bottom-up AABB fixpoint, all as torch ops vectorised over nodes (the
reference build is not a Pallas kernel either). Every field comes out
bit-identical to the reference: integer topology exactly, boxes because
they are mins and maxes of the same float32 leaf boxes, taken with XLA's
semantics for NaN and signed zeros. Clustered clouds share 30-bit codes
heavily (the paper's Table 1), so in the 32-bit build the index
tie-break of ``common_prefix_length32`` shapes much of the tree.

Node numbering (ArborX convention): internal nodes ``0 .. n-2`` (root 0),
leaf ``k`` in Morton order is node ``(n-1) + k``; ``SENTINEL = -1``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import morton as _morton
from repro_torch.core.geometry import ieee_maximum, ieee_minimum

SENTINEL = -1

__all__ = ["Bvh", "build_bvh", "build_bvh_objects", "SENTINEL", "node_depths"]


class Bvh(NamedTuple):
    """Array-of-structs LBVH: n leaves, n-1 internal nodes. Index fields
    are int32 and boxes float32, as in the reference."""

    leaf_perm: torch.Tensor    # (n,) sorted leaf k -> original point index
    left_child: torch.Tensor   # (n-1,) node ids
    right_child: torch.Tensor  # (n-1,)
    rope: torch.Tensor         # (2n-1,) escape index of every node
    node_lo: torch.Tensor      # (2n-1, 3)
    node_hi: torch.Tensor      # (2n-1, 3)
    range_left: torch.Tensor   # (n-1,) inclusive leaf range per internal node
    range_right: torch.Tensor  # (n-1,)
    # Whether leaf boxes may have extent (``build_bvh_objects``); False
    # where every leaf box is a point (``build_bvh``); None: unknown, to
    # be read from the boxes. The kernel's leaf records depend on it.
    box_leaves: bool | None = None

    @property
    def num_leaves(self) -> int:
        return self.leaf_perm.shape[0]


def _karras_ranges(codes: torch.Tensor, prefix):
    """(first, last, gamma) per internal node, int64, over sorted codes,
    with ``prefix(codes, i, j)`` Karras' delta for their width.

    The reference runs the exponential search as a ``while_loop`` and the
    two binary searches as fixed 32-step scans per node; here each search
    is one vectorised loop that runs until every node is done. A finished
    node never moves again, so the results are the reference's."""
    n = codes.shape[0]

    def delta(i, j):
        return prefix(codes, i, j)

    i = torch.arange(n - 1, device=codes.device, dtype=torch.int64)
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    delta_min = delta(i, i - d)

    # Exponential search for the range-length upper bound.
    l_max = torch.full_like(i, 2)
    act = torch.arange(n - 1, device=codes.device)
    while act.numel():
        go = delta(i[act], i[act] + l_max[act] * d[act]) > delta_min[act]
        act = act[go]
        l_max[act] *= 2

    # Binary search for the other end of the range.
    l = torch.zeros_like(i)
    t = l_max // 2
    while bool((t > 0).any()):
        go = (delta(i, i + (l + t) * d) > delta_min) & (t > 0)
        l = torch.where(go, l + t, l)
        t = t // 2
    j = i + l * d

    # Split search: the largest s with delta(i, i + s*d) > delta(i, j).
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    t = l
    while bool((t > 0).any()):
        t_here = (t + 1) // 2
        go = (delta(i, i + (s + t_here) * d) > delta_node) & (t > 0)
        s = torch.where(go, s + t_here, s)
        t = torch.where(t > 1, t_here, torch.zeros_like(t))
    # Karras' split lies in [first, last - 1], inside [0, n - 2]; the clamp
    # changes no value but states the bound where an interval analysis
    # (``staticcheck.absint``) can read it.
    gamma = (i + s * d + torch.clamp(d, max=0)).clamp(0, max(n - 2, 0))
    return torch.minimum(i, j), torch.maximum(i, j), gamma


def build_bvh(points: torch.Tensor, scene_lo: torch.Tensor,
              scene_hi: torch.Tensor, use_64bit: bool = True) -> Bvh:
    """Build an LBVH over (n, 3) float32 points (leaf box = point), on the
    points' device, over 63-bit Morton codes or, with ``use_64bit=False``,
    30-bit ones. n must be >= 2."""
    return _build(points, points, points, scene_lo, scene_hi, use_64bit,
                  box_leaves=False)


def build_bvh_objects(leaf_lo: torch.Tensor, leaf_hi: torch.Tensor,
                      scene_lo: torch.Tensor, scene_hi: torch.Tensor,
                      use_64bit: bool = True) -> Bvh:
    """Build an LBVH over boxed objects, (n, 3) float32 corners, on their
    device; Morton codes from the box centres ``(lo + hi) * 0.5`` in
    float32, as the reference takes them. n must be >= 2."""
    return _build((leaf_lo + leaf_hi) * 0.5, leaf_lo, leaf_hi, scene_lo,
                  scene_hi, use_64bit, box_leaves=True)


def _build(centers, leaf_lo, leaf_hi, scene_lo, scene_hi, use_64bit: bool,
           *, box_leaves: bool) -> Bvh:
    n = centers.shape[0]
    if n < 2:
        raise ValueError(f"a BVH needs at least 2 objects, got {n}")
    dev = centers.device
    unit = _morton.normalize_points(centers, scene_lo, scene_hi)
    if use_64bit:
        codes = _morton.morton64(unit)
        perm = _morton.sort_by_morton64(codes)
        prefix = _morton.common_prefix_length64
    else:
        codes = _morton.morton32(unit)
        perm = _morton.sort_by_morton32(codes)
        prefix = _morton.common_prefix_length32
    first, last, gamma = _karras_ranges(codes[perm], prefix)

    left = torch.where(first == gamma, gamma + (n - 1), gamma)
    right = torch.where(last == gamma + 1, gamma + n, gamma + 1)

    # Ropes in closed form: split positions are a permutation of 0..n-2,
    # and the node whose split is at ``end`` decides where ``end``'s
    # successor hangs.
    split_end = torch.empty_like(last).scatter_(0, gamma, last)

    def rope_of(end):
        p_end = split_end[end.clamp(0, n - 2)]
        r = torch.where(p_end == end + 1, end + n, end + 1)
        return torch.where(end >= n - 1, torch.full_like(r, SENTINEL), r)

    rope = torch.cat([rope_of(last),
                      rope_of(torch.arange(n, device=dev, dtype=torch.int64))])

    # Boxes: leaves from the objects, internal nodes bottom-up until all
    # ready.
    inf = torch.full((n - 1, 3), float("inf"), dtype=leaf_lo.dtype, device=dev)
    node_lo = torch.cat([inf, leaf_lo[perm]])
    node_hi = torch.cat([-inf, leaf_hi[perm]])
    ready = torch.cat([torch.zeros(n - 1, dtype=torch.bool, device=dev),
                       torch.ones(n, dtype=torch.bool, device=dev)])
    pending = torch.arange(n - 1, device=dev)
    while pending.numel():
        lc, rc = left[pending], right[pending]
        ok = ready[lc] & ready[rc]
        done = pending[ok]
        lc, rc = lc[ok], rc[ok]
        node_lo[done] = ieee_minimum(node_lo[lc], node_lo[rc])
        node_hi[done] = ieee_maximum(node_hi[lc], node_hi[rc])
        ready[done] = True
        pending = pending[~ok]

    i32 = torch.int32
    return Bvh(leaf_perm=perm.to(i32), left_child=left.to(i32),
               right_child=right.to(i32), rope=rope.to(i32),
               node_lo=node_lo, node_hi=node_hi,
               range_left=first.to(i32), range_right=last.to(i32),
               box_leaves=box_leaves)


def node_depths(bvh: Bvh) -> torch.Tensor:
    """(2n-1,) int32 depth of every node, the root at 0; the table of
    ``_node_depths`` (``repro/core/query.py:257-271``). The reference
    propagates depths top-down for a fixed 96 levels, the most a tree of
    64 code bits and 32 index bits can have; here one level at a time
    until the last, which gives the same table."""
    n = bvh.num_leaves
    depth = torch.zeros(2 * n - 1, dtype=torch.int32,
                        device=bvh.left_child.device)
    level = torch.zeros(1, dtype=torch.int64, device=depth.device)
    d = 0
    while level.numel():
        d += 1
        kids = torch.cat([bvh.left_child[level], bvh.right_child[level]]).long()
        depth[kids] = d
        level = kids[kids < n - 1]
    return depth
