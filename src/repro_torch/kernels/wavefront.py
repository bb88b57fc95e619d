"""Rope traversal with a fused epilogue; port of the Pallas TPU kernels
``wavefront_traverse`` (``repro/kernels/wavefront.py:97``) and
``wavefront_fill_round`` (``repro/kernels/wavefront.py:245``).

The reference kernel takes arbitrary Python callbacks through a
``make_fns`` factory. A CUDA kernel cannot, so the port has a closed set
of nine epilogues, one wrapper each (the two of DenseBox share one C
entry), all instantiations of one template in ``csrc/wavefront.cu``:

* :func:`wavefront_count` — ε-hit counts with optional early exit at
  ``stop_at`` (``query_count``, ``repro/core/query.py:990-993``); with a
  node depth table it also returns the reference's per-lane traversal
  counters (``with_stats``, ``repro/kernels/wavefront.py:203-207``);
* :func:`wavefront_min_label` — the minimum ``obj_labels[j]`` over core
  objects ``j`` hit, ``sentinel`` if none, for queries in ``queries_mask``
  (``min_core_label_on``, ``repro/core/dbscan.py:111-113``), over int32
  labels or, in an instance of its own (MIN_LABEL64), int64 ones (the
  sharded path's global ids, ``repro/core/distributed.py:401``);
* :func:`wavefront_fill` — the fill pass of the count-then-fill CSR
  protocol: hit ``k`` of query ``qi`` goes to ``offsets[qi] + k`` when that
  is below ``capacity`` (``_csr_fill``, ``repro/core/query.py:1039``), in
  one traversal where the reference resumes chunk rounds of
  ``wavefront_fill_round``;
* :func:`wavefront_fixed` — per-query buffers of ``capacity`` slots, surplus
  hits overwriting the last slot, and the true counts (``query_fixed``,
  ``repro/core/query.py:1000``);
* :func:`wavefront_potential` — the softened, ε-truncated potential
  ``-Σ 1/sqrt(d² + soft²)`` over the hits, in rope order, for queries in
  ``active`` (``halo_potentials``, ``repro/halos/centers.py:64-65``);
* :func:`wavefront_edge` — ``fdbscan_pair``'s capture
  (``repro/core/dbscan.py:239-252``): per query up to ``capacity`` hit
  objects that are core and have another root than the query, done when
  the buffer is full; the queries are the tree's leaves in order, each
  from ``rope[leaf]`` (the pair backend, :func:`pair_starts`);
* :func:`wavefront_histogram` — ``pair_count_histogram``'s DD bins
  (``repro/core/correlation.py:146-149``): each hit's distance bin, summed
  over the queries (integer counts, so in any order);
* :func:`wavefront_dense_count` and :func:`wavefront_dense_min_label` —
  DenseBox's two callbacks on its mixed tree of cell boxes and points
  (``repro/core/dbscan.py:355-425``): a dense cell within r wholesale or
  point by point, a point by its test, a dense non-head point skipped.

Every wrapper takes a start node per query (``start``, the reference's
``start_nodes``, ``repro/kernels/wavefront.py:135-139``); a query that
starts at ``SENTINEL`` walks nothing and keeps its initial carry.

The reference kernel builds its tests in the kernel from ``_pred_fns``
(``repro/core/query.py:566-624``) for any predicate on any tree. COUNT,
FILL and FIXED take ``pred=`` one of :data:`PREDICATES`, each with its
per-query geometry ``(qa, qb)``:

* ``"sphere"`` (``Within``): centres (q, 3) and squared radii (q,);
* ``"box"`` (``IntersectsBox``): box corners lo (q, 3) and hi (q, 3);
* ``"ray"`` (the all-hits ``Ray``): origins (q, 3) and inverse directions
  (q, 3), ``core.geometry.safe_inv`` of the directions;

on trees whose leaves are points (``build_bvh``) or boxes
(``build_bvh_objects``). MIN_LABEL, POTENTIAL, EDGE and HISTOGRAM take
spheres on point trees only, DenseBox's two spheres on box-leaf trees
only; anything else raises ``ValueError``.

A wrapper launches the kernel for CUDA tensors and runs the plain PyTorch
version for CPU tensors; ``<wrapper>.launches`` counts kernel launches,
and ``<wrapper>.instances`` counts them by ``"<pred>/<leaf kind>"``
(``"sphere/point"``, ``"ray/box"``, ...; MIN_LABEL over int64 labels
``"sphere/point/int64"``); ``wavefront_count.counters.launches`` counts
those of COUNT's counter instance.
The plain version is the lockstep wavefront of the reference kernel
(``repro/kernels/wavefront.py:180-215``): every live query advances one
rope hop per iteration, and queries drop out of the working set when they
finish.

The kernel reads the tree as packed node records (:func:`pack_tree`):
an internal node's box with its left child and rope in 32 bytes, a leaf's
point with its rope in 16 (a box leaf's lo and hi, each with the rope, in
32), indices as raw int32 bits. A wrapper packs the
tree before it launches the traversal, once per call, or once for all the
traversals of a tree inside :func:`shared_pack`; a leaf hop reads one
int32 key (:func:`min_label_keys` for MIN_LABEL, ``leaf_perm`` for FILL
and FIXED), or MIN_LABEL64's int64 key.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import threading
import types
from typing import NamedTuple

import torch

from repro_torch.core.bvh import SENTINEL, Bvh
from repro_torch.core.geometry import (aabb_aabb_dist2, flush,
                                       point_aabb_dist2, ray_box, sum_sq)
from repro_torch.kernels import _build
from repro_torch.obs.stats import TraversalStats

__all__ = ["PREDICATES", "pred_test", "leaf_boxes", "wavefront_count",
           "wavefront_min_label", "wavefront_fill", "wavefront_fixed",
           "wavefront_potential", "wavefront_edge", "wavefront_histogram",
           "wavefront_dense_count", "wavefront_dense_min_label",
           "PackedTree", "pack_tree", "pack_tree_plain",
           "shared_pack", "min_label_keys", "pair_starts", "pair_keys",
           "dense_leaves", "DENSE_POINT", "DENSE_CELL", "DENSE_SKIP",
           "SHARED_HISTOGRAM_BINS",
           "wavefront_count_plain", "wavefront_min_label_plain",
           "wavefront_fill_plain", "wavefront_fixed_plain",
           "wavefront_potential_plain", "wavefront_edge_plain",
           "wavefront_histogram_plain", "wavefront_dense_count_plain",
           "wavefront_dense_min_label_plain", "lockstep_traverse",
           "count_epilogue", "min_label_epilogue", "fill_epilogue",
           "fixed_epilogue", "potential_epilogue", "edge_epilogue",
           "histogram_epilogue", "dense_epilogue", "histogram_bins",
           "fill_lanes", "fixed_carry", "inv_sqrt_rn", "inv_sqrt_plain",
           "histogram_bins_rn"]

_INT32_MAX = 2**31 - 1
# The per-lane counters, one row each in the order of ``TraversalStats``'s
# fields: nodes_visited, aabb_tests, leaf_tests, callback_hits,
# early_exits (0/1), max_depth.
_N_STATS = len(TraversalStats._fields)
# The predicates of the kernel's template, by their enum value there.
PREDICATES = {"sphere": 0, "box": 1, "ray": 2}
# What a leaf of DenseBox's mixed tree is, by the kernel's enum value.
DENSE_POINT, DENSE_CELL, DENSE_SKIP = 0, 1, 2
# Up to this many histogram bins sit in a block's shared memory, 8 bytes
# each (48 KiB); more go straight to the global bins.
SHARED_HISTOGRAM_BINS = 6144


def _check_inputs(bvh: Bvh, qa, qb, order, pred: str = "sphere"):
    if pred not in PREDICATES:
        raise ValueError(f"pred must be one of {sorted(PREDICATES)}, got "
                         f"{pred!r}")
    q = qa.shape[0]
    if qa.dtype != torch.float32 or qa.shape != (q, 3):
        raise ValueError(f"queries must be (q, 3) float32, got "
                         f"{tuple(qa.shape)} {qa.dtype}")
    want = (q,) if pred == "sphere" else (q, 3)
    if qb.dtype != torch.float32 or qb.shape != want:
        raise ValueError(f"{pred} queries take a second {want} float32 array "
                         f"(r2, hi or inverse directions), got "
                         f"{tuple(qb.shape)} {qb.dtype}")
    if order is not None and (order.dtype != torch.int32 or order.shape != (q,)):
        raise ValueError("order must be a (q,) int32 permutation")
    if bvh.node_lo.device != qa.device or qb.device != qa.device:
        raise ValueError("the tree and the queries must be on one device")


def _spheres_on_points(bvh: Bvh, what: str):
    if leaf_boxes(bvh):
        raise ValueError(f"{what} takes trees whose leaves are points; on "
                         "box leaves the traversal runs DenseBox's epilogues "
                         "(ROADMAP B1 (d))")


def _spheres_on_boxes(bvh: Bvh, what: str):
    if not leaf_boxes(bvh):
        raise ValueError(f"{what} takes DenseBox's mixed tree, whose leaves "
                         "are boxes (build_bvh_objects)")


def _ptr(t: torch.Tensor | None) -> int | None:
    if t is None:
        return None
    if not t.is_contiguous():
        raise ValueError("kernel inputs must be contiguous")
    return t.data_ptr()


def _vec_ptr(t: torch.Tensor) -> int:
    """The address of a tensor the kernel reads as float4 records."""
    if t.data_ptr() % 16:
        raise ValueError("packed tree records must be 16-byte aligned, got "
                         f"address {t.data_ptr():#x}")
    return _ptr(t)


def _tree_args(packed: "PackedTree", key: torch.Tensor | None):
    return [_vec_ptr(packed.inner), _vec_ptr(packed.leaves), _ptr(key),
            packed.leaves.shape[0], int(packed.box_leaves)]


def _query_args(order, qa, qb, pred: str, start):
    return [_ptr(order), _ptr(qa), _ptr(qb), PREDICATES[pred], qa.shape[0],
            _ptr(start)]


def _launched(wrapper, pred: str, packed: "PackedTree", key: str = "") -> None:
    leaf = "box" if packed.box_leaves else "point"
    _build.count_launch(wrapper, 1, f"{pred}/{leaf}{key}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_TREE = [_P, _P, _P, _I, _I]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("wavefront")
    lib.wavefront_pack.argtypes = [_P, _P, _P, _P, _I, _I, _P, _P, _P]
    # Every traversal entry: tree (records, key, n, box_leaves), then
    # order, qa, qb, pred, q, start, then its own.
    query = _TREE + [_P, _P, _P, _I, _I, _P]
    lib.wavefront_count.argtypes = query + [_I, _P, _P, _P, _P]
    lib.wavefront_min_label.argtypes = query + [_P, _I, _P, _P]
    lib.wavefront_min_label64.argtypes = query + [_P, _L, _P, _P]
    lib.wavefront_fill.argtypes = query + [_P, _I, _L, _P, _P]
    lib.wavefront_fixed.argtypes = query + [_L, _P, _P, _P]
    lib.wavefront_potential.argtypes = query + [_P, ctypes.c_float, _P, _P]
    lib.wavefront_edge.argtypes = query + [_P, _L, _P, _P, _P]
    lib.wavefront_histogram.argtypes = query + [ctypes.c_float, _I, _P, _P]
    lib.wavefront_dense.argtypes = query + [_I, _P, _P, _P, ctypes.c_float,
                                            _I, _P, _I, _P, _P]
    lib.wavefront_rsqrt_probe.argtypes = [_P, _P, _I, _P]
    lib.wavefront_bin_probe.argtypes = [_P, _P, _I, ctypes.c_float, _I, _P]
    for fn in (lib.wavefront_pack, lib.wavefront_count,
               lib.wavefront_min_label, lib.wavefront_min_label64,
               lib.wavefront_fill,
               lib.wavefront_fixed, lib.wavefront_potential,
               lib.wavefront_edge, lib.wavefront_histogram,
               lib.wavefront_dense, lib.wavefront_rsqrt_probe,
               lib.wavefront_bin_probe):
        fn.restype = _I
    lib.cuda_error_string.argtypes = [_I]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


# ---------------------------------------------------------------------------
# Packed node records
# ---------------------------------------------------------------------------

class PackedTree(NamedTuple):
    """The tree as the kernel reads it, float32 with int32 bits in the
    last column (``Tensor.view``, never a conversion: ``SENTINEL`` is a NaN
    pattern). ``inner[i]`` = lo.xyz, left_child, hi.xyz, rope of internal
    node i; ``leaves[k]`` = x, y, z, rope of leaf k (node n-1+k), whose
    box is its point, or, where leaves are boxes, lo.xyz, rope, hi.xyz,
    rope."""

    inner: torch.Tensor   # (n-1, 8)
    leaves: torch.Tensor  # (n, 4), or (n, 8) with box leaves

    @property
    def box_leaves(self) -> bool:
        return self.leaves.shape[1] == 8


def leaf_boxes(bvh: Bvh) -> bool:
    """Whether the tree's leaves need box records: ``bvh.box_leaves``
    where the tree carries it, else read from the boxes (one host sync)."""
    if bvh.box_leaves is not None:
        return bool(bvh.box_leaves)
    n = bvh.num_leaves
    return not torch.equal(bvh.node_lo[n - 1:].view(torch.int32),
                           bvh.node_hi[n - 1:].view(torch.int32))


def pack_tree_plain(bvh: Bvh) -> PackedTree:
    """:func:`pack_tree` in torch ops: bit copies of the ``Bvh`` fields."""
    n, i32 = bvh.num_leaves, torch.int32
    lo, hi, rope = bvh.node_lo.view(i32), bvh.node_hi.view(i32), bvh.rope
    inner = torch.cat([lo[:n - 1], bvh.left_child[:, None], hi[:n - 1],
                       rope[:n - 1, None]], 1)
    parts = [lo[n - 1:], rope[n - 1:, None]]
    if leaf_boxes(bvh):
        parts += [hi[n - 1:], rope[n - 1:, None]]
    leaves = torch.cat(parts, 1)
    return PackedTree(inner.view(torch.float32), leaves.view(torch.float32))


def pack_tree(bvh: Bvh) -> PackedTree:
    """The node records of ``bvh``, with box leaf records where
    :func:`leaf_boxes` says the tree needs them (a ``build_bvh_objects``
    tree is never packed as points). On the card the pack kernel of
    ``csrc/wavefront.cu`` writes them; for CPU tensors its plain version.
    Extra memory: (n-1)·32 + n·16 bytes (n·32 with box leaves)."""
    if bvh.leaf_perm.dtype != torch.int32 or bvh.node_lo.dtype != torch.float32:
        raise ValueError("Bvh index fields must be int32 and boxes float32")
    if not bvh.node_lo.is_cuda:
        return pack_tree_plain(bvh)
    n, f32, dev = bvh.num_leaves, torch.float32, bvh.node_lo.device
    box = leaf_boxes(bvh)
    packed = PackedTree(torch.empty((n - 1, 8), dtype=f32, device=dev),
                        torch.empty((n, 8 if box else 4), dtype=f32, device=dev))
    lib = _lib()
    code = lib.wavefront_pack(
        _ptr(bvh.node_lo), _ptr(bvh.node_hi), _ptr(bvh.left_child),
        _ptr(bvh.rope), n, int(box), _vec_ptr(packed.inner),
        _vec_ptr(packed.leaves), _stream())
    _build.check(lib, code, "wavefront_pack")
    return packed


_open = threading.local()   # .packs: [bvh, PackedTree or None] per block


@contextlib.contextmanager
def shared_pack(bvh: Bvh):
    """Inside the block, this thread's traversals of ``bvh`` (this very
    object, which must not change there) share one packed copy, made at
    the first launch, instead of packing at each launch."""
    packs = _open.__dict__.setdefault("packs", [])
    packs.append([bvh, None])
    try:
        yield
    finally:
        packs.pop()


def _packed(bvh: Bvh) -> PackedTree:
    for entry in getattr(_open, "packs", ()):
        if entry[0] is bvh:
            if entry[1] is None:
                entry[1] = pack_tree(bvh)
            return entry[1]
    return pack_tree(bvh)


def min_label_keys(bvh: Bvh, obj_labels, obj_core, sentinel: int):
    """MIN_LABEL's key per leaf, (n,) in leaf order and ``obj_labels``'s
    dtype (int32 or int64): the label of the leaf's object where it is
    core, ``sentinel`` elsewhere. A query's carry starts at ``sentinel``
    and only decreases, so the min over the keys of its hits is the min
    over its core hits' labels."""
    perm = bvh.leaf_perm
    return torch.where(obj_core.index_select(0, perm),
                       obj_labels.index_select(0, perm), int(sentinel))


def pair_starts(bvh: Bvh) -> torch.Tensor:
    """(n,) int32 start nodes of the pair backend: leaf k's rope, so that
    query k (leaf k's point) visits only the leaves after k in rope
    order, and each unordered pair once."""
    return bvh.rope[bvh.num_leaves - 1:].contiguous()


def pair_keys(bvh: Bvh, parent, core) -> torch.Tensor:
    """EDGE's key per leaf, (n, 2) int32 in leaf order: the object index
    and its root ``parent[j]`` where it is core, -1 elsewhere. Query k's
    own root is row k's, since query k is leaf k's point."""
    perm = bvh.leaf_perm
    root = torch.where(core.index_select(0, perm),
                       parent.to(torch.int32).index_select(0, perm), -1)
    return torch.stack([perm, root], 1).contiguous()


def dense_leaves(bvh: Bvh, run_start, run_length, label, kind) -> torch.Tensor:
    """DenseBox's word per leaf, (n, 4) int32 in leaf order, from per
    object (grid-sorted) values: the start and length of the object's
    cell run, its label (the cell's least label for a cell leaf, the
    point's key for a point leaf) and its kind (``DENSE_POINT``,
    ``DENSE_CELL`` or ``DENSE_SKIP``)."""
    words = torch.stack([run_start.to(torch.int32), run_length.to(torch.int32),
                         label.to(torch.int32), kind.to(torch.int32)], 1)
    return words.index_select(0, bvh.leaf_perm.long()).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def pred_test(pred: str, qa, qb, lo, hi):
    """``(value, hit)`` of queries (m rows of ``qa``, ``qb``) against
    boxes (m, 3), the plain version of the kernel's test for ``pred``:
    ``"sphere"`` the point-box distance² and ``d2 <= r2``; ``"box"``
    ``aabb_aabb_dist2`` and ``<= 0``; ``"ray"`` the slab test's entry ``t``
    and its hit. ``value`` is what a callback gets in the reference's
    ``d2`` slot."""
    if pred == "sphere":
        d2 = point_aabb_dist2(qa, lo, hi)
        return d2, d2 <= qb
    if pred == "box":
        d2 = aabb_aabb_dist2(qa, qb, lo, hi)
        return d2, d2 <= 0.0
    return ray_box(qa, qb, lo, hi)


def lockstep_traverse(bvh: Bvh, qa, qb, lanes, carry0, epilogue, *,
                      start=None, depths=None, pred: str = "sphere"):
    """Lockstep rope walk over the query indices ``lanes``, the algorithm of
    the reference kernel in torch ops, with the test of ``pred`` on the
    queries' ``(qa, qb)`` (:func:`pred_test`) against the tree's node and
    leaf boxes, points or boxes alike. Query ``qi`` starts at
    ``start[qi]`` (the root where ``start`` is None); one that starts at
    ``SENTINEL`` walks nothing. ``epilogue(carry, node, leaf_hit, value) ->
    (carry, done)`` runs on the live lanes each hop, with ``value`` the
    hop's test value (d², or a ray's ``t``), and must leave lanes without
    ``leaf_hit`` unchanged. Returns the final carry per lane, in ``lanes``
    order, and the number of node visits (hops) it took; with a node depth
    table ``depths`` also the lanes' counters, (6, m) int32 in
    ``TraversalStats`` order, as ``_one_stackless_stats`` counts them
    (``repro/core/query.py:274-309``): every iteration, internal and leaf
    iterations, leaf hits, whether the epilogue ended the walk, and the
    deepest node visited."""
    n = bvh.num_leaves
    left, rope = bvh.left_child.long(), bvh.rope.long()
    out = carry0.clone()
    node = torch.zeros_like(lanes) if start is None else start[lanes].long()
    stats = None if depths is None else torch.zeros(
        (_N_STATS, lanes.numel()), dtype=torch.int32,
        device=lanes.device)
    walks = node != SENTINEL
    pos = torch.nonzero(walks).flatten()
    node, carry = node[walks], carry0[walks]
    a, b = qa[lanes[walks]], qb[lanes[walks]]
    hops = 0
    while pos.numel():
        hops += pos.numel()
        val, hit = pred_test(pred, a, b, bvh.node_lo[node], bvh.node_hi[node])
        is_leaf = node >= n - 1
        carry, done = epilogue(carry, node, is_leaf & hit, val)
        if stats is not None:
            stats[:4, pos] += torch.stack([torch.ones_like(hit), ~is_leaf,
                                           is_leaf, is_leaf & hit]).int()
            stats[5, pos] = torch.maximum(stats[5, pos], depths[node])
        node = torch.where(hit & ~is_leaf, left[node.clamp(max=n - 2)],
                           rope[node])
        live = (node != SENTINEL) & ~done
        fin = ~live
        out[pos[fin]] = carry[fin]
        if stats is not None:
            stats[4, pos[fin]] = done[fin].int()
        pos, node, carry = pos[live], node[live], carry[live]
        a, b = a[live], b[live]
    return (out, hops) if stats is None else (out, hops, stats)


def count_epilogue(stop_at: int | None):
    """COUNT: one more per leaf hit; done once the count reaches stop_at."""
    stop = _INT32_MAX if stop_at is None else int(stop_at)

    def epilogue(count, _node, leaf_hit, _d2):
        count = count + leaf_hit.to(count.dtype)
        return count, leaf_hit & (count >= stop)
    return epilogue


def min_label_epilogue(bvh: Bvh, obj_labels, obj_core):
    """MIN_LABEL: min of ``obj_labels`` over core objects hit; never done."""
    n = bvh.num_leaves
    leaf_perm = bvh.leaf_perm.long()

    def epilogue(best, node, leaf_hit, _d2):
        obj = leaf_perm[(node - (n - 1)).clamp(0, n - 1)]
        cand = torch.where(leaf_hit & obj_core[obj], obj_labels[obj], best)
        return torch.minimum(best, cand), torch.zeros_like(leaf_hit)
    return epilogue


def fill_epilogue(bvh: Bvh, indices):
    """FILL: the carry is the next write position (int64). A hit goes to
    ``indices[position]``; done once the position reaches
    ``indices.numel()``, since every later hit would be dropped."""
    n, capacity = bvh.num_leaves, indices.numel()
    leaf_perm = bvh.leaf_perm

    def epilogue(pos, node, leaf_hit, _d2):
        w = torch.nonzero(leaf_hit).flatten()
        indices[pos[w]] = leaf_perm[node[w] - (n - 1)]
        pos = pos + leaf_hit.to(pos.dtype)
        return pos, pos >= capacity
    return epilogue


def fixed_epilogue(bvh: Bvh, buf):
    """FIXED: the carry is ``(m, 2)`` int64, the hits so far and the query
    index. Hit ``k`` goes to ``buf[query, min(k, capacity - 1)]``; never
    done."""
    n, capacity = bvh.num_leaves, buf.shape[1]
    leaf_perm, flat = bvh.leaf_perm, buf.view(-1)

    def epilogue(carry, node, leaf_hit, _d2):
        count, qi = carry[:, 0], carry[:, 1]
        if capacity:
            w = torch.nonzero(leaf_hit).flatten()
            slot = count[w].clamp(max=capacity - 1)
            flat[qi[w] * capacity + slot] = leaf_perm[node[w] - (n - 1)]
        count = count + leaf_hit.to(count.dtype)
        return torch.stack([count, qi], 1), torch.zeros_like(leaf_hit)
    return epilogue


def inv_sqrt_plain(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x) of float32 ``x`` with the square root and the reciprocal
    each rounded correctly to float32, as the kernel computes it
    (``__frcp_rn(__fsqrt_rn(x))``). Each step is taken in float64 and
    rounded to float32, which for a square root or a quotient gives the
    correctly rounded float32 result (53 bits >= 2·24 + 2). On the card
    the float64 steps are exact IEEE operations, so this equals the kernel
    bit for bit; torch's float32 ``sqrt`` on the CPU is not always
    correctly rounded, and its float64 one is within an ulp of float64,
    which the rounding to float32 absorbs."""
    s = x.double().sqrt().float()
    return s.double().reciprocal().float()


def potential_epilogue(soft2: torch.Tensor):
    """POTENTIAL: ``acc - 1/sqrt(d2 + soft2)`` on each leaf hit, with
    ``soft2`` a float32 scalar tensor, the reciprocal square root by
    :func:`inv_sqrt_plain`; never done."""
    def epilogue(acc, _node, leaf_hit, d2):
        term = inv_sqrt_plain(d2 + soft2)
        return torch.where(leaf_hit, acc - term, acc), torch.zeros_like(leaf_hit)
    return epilogue


def edge_epilogue(bvh: Bvh, keys, buf):
    """EDGE: the carry is ``(m, 2)`` int64, the edges taken and the query
    (leaf) index. A hit object that is core with another root than the
    query's (:func:`pair_keys`) goes to ``buf[query, min(taken, capacity
    - 1)]``; done once ``capacity`` are taken."""
    n, capacity = bvh.num_leaves, buf.shape[1]
    flat = buf.view(-1)

    def epilogue(carry, node, leaf_hit, _d2):
        count, qi = carry[:, 0], carry[:, 1]
        row = keys[(node - (n - 1)).clamp(0, n - 1)]
        take = leaf_hit & (row[:, 1] >= 0) & (row[:, 1] != keys[qi, 1])
        w = torch.nonzero(take).flatten()
        slot = count[w].clamp(max=capacity - 1)
        flat[qi[w] * capacity + slot] = row[w, 0]
        count = count + take.to(count.dtype)
        return torch.stack([count, qi], 1), take & (count >= capacity)
    return epilogue


def histogram_bins(d2: torch.Tensor, r_max: float, n_bins: int) -> torch.Tensor:
    """int64 bin of each squared distance: ``floor(sqrt(max(d2, 1e-30)) /
    r_max * n_bins)`` clipped to ``[0, n_bins - 1]``, each step a float32
    operation rounded correctly (the square root and the quotient taken
    in float64 and rounded, as :func:`inv_sqrt_plain` does) and flushed
    as XLA:CPU flushes subnormals."""
    f32 = torch.float32
    floor = torch.tensor(1e-30, dtype=f32, device=d2.device)
    dist = torch.maximum(d2, floor).double().sqrt().float()
    r = float(torch.tensor(r_max, dtype=f32))
    x = flush(flush((dist.double() / r).float()) * float(n_bins))
    return torch.floor(x).long().clamp(0, n_bins - 1)


def histogram_epilogue(hist, r_max: float):
    """HISTOGRAM: each hit's bin (:func:`histogram_bins`) added to
    ``hist`` (n_bins,) int64; the carry is unused; never done."""
    n_bins = hist.numel()

    def epilogue(carry, _node, leaf_hit, d2):
        b = histogram_bins(d2[leaf_hit], r_max, n_bins)
        hist.index_add_(0, b, torch.ones_like(b))
        return carry, torch.zeros_like(leaf_hit)
    return epilogue


def dense_epilogue(bvh: Bvh, words, pts, centers, r2, half: float, *,
                   scan_lab=None, stop_at: int | None = None,
                   tally: dict | None = None):
    """DENSE_COUNT (``scan_lab`` None) or DENSE_MIN_LABEL on DenseBox's
    mixed tree. The carry is ``(m, 2)`` int64, the count or label and the
    query index. On a leaf hit, by the leaf's word (:func:`dense_leaves`):
    a cell whose farthest corner, ``sum((|centre - (lo + hi) * 0.5| +
    half)^2)``, is within r² adds its run's length (COUNT) or takes its
    label (MIN_LABEL); a cell that is not scans its run of ``pts``
    (grid-sorted), each point within r counting 1 or giving its
    ``scan_lab``; a point counts 1 or gives its label; a skip leaf
    nothing. COUNT is done once the count reaches ``stop_at``; MIN_LABEL
    never. ``tally``, where given, adds up the cell hits taken whole
    (``"whole"``), those scanned (``"scanned"``) and the points scanned
    (``"scan_tests"``)."""
    n = bvh.num_leaves
    stop = _INT32_MAX if stop_at is None else int(stop_at)
    h = torch.tensor(half, dtype=torch.float32, device=pts.device)
    count = scan_lab is None

    def epilogue(carry, node, leaf_hit, _d2):
        val, qi = carry[:, 0].clone(), carry[:, 1]
        w = words[(node - (n - 1)).clamp(0, n - 1)].long()
        point = leaf_hit & (w[:, 3] == DENSE_POINT)
        if count:
            val += point.long()
        else:
            val = torch.where(point, torch.minimum(val, w[:, 2]), val)
        c = torch.nonzero(leaf_hit & (w[:, 3] == DENSE_CELL)).flatten()
        if c.numel():
            mid = (bvh.node_lo[node[c]] + bvh.node_hi[node[c]]) * 0.5
            ctr, rr = centers[qi[c]], r2[qi[c]]
            whole = sum_sq((ctr - mid).abs() + h) <= rr
            cw = c[whole]
            if count:
                val[cw] += w[cw, 1]
            else:
                val[cw] = torch.minimum(val[cw], w[cw, 2])
            part = c[~whole]
            if tally is not None:
                tally["whole"] = tally.get("whole", 0) + int(cw.numel())
                tally["scanned"] = tally.get("scanned", 0) + int(part.numel())
                tally["scan_tests"] = tally.get("scan_tests", 0) + int(
                    w[part, 1].sum())
            if part.numel():
                lens = w[part, 1]
                owner = torch.repeat_interleave(
                    torch.arange(part.numel(), device=part.device), lens)
                first = torch.cumsum(lens, 0) - lens
                u = w[part, 0][owner] + (torch.arange(owner.numel(),
                                                      device=part.device)
                                         - first[owner])
                q = qi[part][owner]
                inside = sum_sq(pts[u] - centers[q]) <= r2[q]
                if count:
                    val[part] += torch.zeros_like(lens).index_add_(
                        0, owner, inside.long())
                else:
                    cand = torch.where(inside, scan_lab[u].long(), _INT32_MAX)
                    least = torch.full_like(lens, _INT32_MAX).scatter_reduce(
                        0, owner, cand, "amin")
                    val[part] = torch.minimum(val[part], least)
        done = (leaf_hit & (val >= stop)) if count else torch.zeros_like(leaf_hit)
        return torch.stack([val, qi], 1), done
    return epilogue


def wavefront_count_plain(bvh: Bvh, qa, qb, stop_at=None, start=None,
                          depths=None, *, pred: str = "sphere"):
    """Hit counts per query of ``pred`` (ε-counts for spheres), saturating
    at ``stop_at`` when it is set; with ``depths``, ``(counts, stats)`` as
    :func:`wavefront_count`."""
    q = qa.shape[0]
    lanes = torch.arange(q, device=qa.device)
    zeros = torch.zeros(q, dtype=torch.int32, device=qa.device)
    res = lockstep_traverse(bvh, qa, qb, lanes, zeros,
                            count_epilogue(stop_at), start=start,
                            depths=depths, pred=pred)
    return res[0] if depths is None else (res[0], res[2])


def wavefront_min_label_plain(bvh: Bvh, centers, r2, obj_labels, obj_core,
                              queries_mask, sentinel: int, start=None):
    """Min ``obj_labels[j]`` over core objects within r of each query in
    ``queries_mask``; ``sentinel`` for the rest and where none is hit. In
    ``obj_labels``'s dtype, int32 or int64."""
    _spheres_on_points(bvh, "MIN_LABEL")
    out = torch.full((centers.shape[0],), int(sentinel),
                     dtype=obj_labels.dtype, device=centers.device)
    lanes = torch.nonzero(queries_mask).flatten()
    out[lanes] = lockstep_traverse(
        bvh, centers, r2, lanes, out[lanes],
        min_label_epilogue(bvh, obj_labels, obj_core), start=start)[0]
    return out


def fill_lanes(offsets, capacity: int):
    """The queries FILL walks, those whose row starts below ``capacity``,
    and their first write positions (int64)."""
    first = offsets[:-1].long()
    lanes = torch.nonzero(first < capacity).flatten()
    return lanes, first[lanes]


def wavefront_fill_plain(bvh: Bvh, qa, qb, offsets, capacity: int,
                         start=None, *, pred: str = "sphere"):
    """(capacity,) int32: hit ``k`` of query ``qi``, in traversal order, at
    ``offsets[qi] + k`` when that is below ``capacity``; -1 elsewhere."""
    indices = torch.full((capacity,), -1, dtype=torch.int32,
                         device=qa.device)
    lanes, first = fill_lanes(offsets, capacity)
    lockstep_traverse(bvh, qa, qb, lanes, first, fill_epilogue(bvh, indices),
                      start=start, pred=pred)
    return indices


def fixed_carry(q: int, device):
    """FIXED's initial carry: zero hits, and each query's own index."""
    lanes = torch.arange(q, device=device)
    return lanes, torch.stack([torch.zeros_like(lanes), lanes], 1)


def wavefront_fixed_plain(bvh: Bvh, qa, qb, capacity: int, start=None, *,
                          pred: str = "sphere"):
    """``(buf (q, capacity) int32, counts (q,) int32)``: hit ``k`` of each
    query at slot ``min(k, capacity - 1)`` of its row, -1 in unused slots,
    and the true hit counts."""
    buf = torch.full((qa.shape[0], capacity), -1, dtype=torch.int32,
                     device=qa.device)
    lanes, carry0 = fixed_carry(qa.shape[0], qa.device)
    carry = lockstep_traverse(bvh, qa, qb, lanes, carry0,
                              fixed_epilogue(bvh, buf), start=start,
                              pred=pred)[0]
    return buf, carry[:, 0].to(torch.int32)


def wavefront_potential_plain(bvh: Bvh, centers, r2, soft2: float,
                              active=None, start=None):
    """(q,) float32: ``-Σ 1/sqrt(d2 + soft2)`` over each active query's
    hits, summed in rope order; 0 outside ``active``."""
    _spheres_on_points(bvh, "POTENTIAL")
    q = centers.shape[0]
    out = torch.zeros(q, dtype=torch.float32, device=centers.device)
    lanes = (torch.arange(q, device=centers.device) if active is None
             else torch.nonzero(active).flatten())
    s2 = torch.tensor(soft2, dtype=torch.float32, device=centers.device)
    out[lanes] = lockstep_traverse(bvh, centers, r2, lanes, out[lanes],
                                   potential_epilogue(s2), start=start)[0]
    return out


def wavefront_edge_plain(bvh: Bvh, centers, r2, keys, capacity: int,
                         start=None):
    """``(buf (q, capacity) int32, counts (q,) int32)``: the edges
    :func:`edge_epilogue` takes for each query whose own key is core, -1
    in unused slots; queries that are not core walk nothing."""
    q = centers.shape[0]
    buf = torch.full((q, capacity), -1, dtype=torch.int32,
                     device=centers.device)
    counts = torch.zeros(q, dtype=torch.int32, device=centers.device)
    lanes = torch.nonzero(keys[:q, 1] >= 0).flatten()
    carry0 = torch.stack([torch.zeros_like(lanes), lanes], 1)
    carry = lockstep_traverse(bvh, centers, r2, lanes, carry0,
                              edge_epilogue(bvh, keys, buf), start=start)[0]
    counts[lanes] = carry[:, 0].to(torch.int32)
    return buf, counts


def wavefront_histogram_plain(bvh: Bvh, centers, r2, r_max: float,
                              n_bins: int, start=None):
    """(n_bins,) int64: the hits of every query, binned by distance."""
    hist = torch.zeros(n_bins, dtype=torch.int64, device=centers.device)
    q = centers.shape[0]
    lanes = torch.arange(q, device=centers.device)
    lockstep_traverse(bvh, centers, r2, lanes, torch.zeros_like(lanes),
                      histogram_epilogue(hist, r_max), start=start)
    return hist


def _dense_plain(bvh, centers, r2, words, pts, half, qmask, init, **kw):
    q = centers.shape[0]
    out = torch.full((q,), int(init), dtype=torch.int32, device=centers.device)
    lanes = (torch.arange(q, device=centers.device) if qmask is None
             else torch.nonzero(qmask).flatten())
    carry0 = torch.stack([torch.full_like(lanes, int(init)), lanes], 1)
    carry = lockstep_traverse(bvh, centers, r2, lanes, carry0,
                              dense_epilogue(bvh, words, pts, centers, r2,
                                             half, **kw))[0]
    out[lanes] = carry[:, 0].to(torch.int32)
    return out


def wavefront_dense_count_plain(bvh: Bvh, centers, r2, words, pts,
                                half: float, stop_at=None, qmask=None,
                                tally=None):
    """(q,) int32 DENSE_COUNT counts, 0 outside ``qmask`` (``tally``: see
    :func:`dense_epilogue`)."""
    _spheres_on_boxes(bvh, "DENSE_COUNT")
    return _dense_plain(bvh, centers, r2, words, pts, half, qmask, 0,
                        stop_at=stop_at, tally=tally)


def wavefront_dense_min_label_plain(bvh: Bvh, centers, r2, words, pts,
                                    scan_lab, half: float, qmask,
                                    sentinel: int, tally=None):
    """(q,) int32 DENSE_MIN_LABEL labels, ``sentinel`` outside ``qmask``
    and where nothing is hit (``tally``: see :func:`dense_epilogue`)."""
    _spheres_on_boxes(bvh, "DENSE_MIN_LABEL")
    return _dense_plain(bvh, centers, r2, words, pts, half, qmask, sentinel,
                        scan_lab=scan_lab, tally=tally)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_start(start, q: int, device):
    if start is not None and (start.dtype != torch.int32
                              or start.shape != (q,)
                              or start.device != device):
        raise ValueError("start must be (q,) int32 node ids on the queries' "
                         "device")


def wavefront_count(bvh: Bvh, qa: torch.Tensor, qb: torch.Tensor, *,
                    pred: str = "sphere", stop_at: int | None = None,
                    order: torch.Tensor | None = None,
                    start: torch.Tensor | None = None,
                    depths: torch.Tensor | None = None):
    """(q,) int32 hit counts of the queries ``(qa, qb)`` of ``pred`` (for
    spheres, centres and squared radii: ε-counts), saturating at
    ``stop_at``. ``order`` (int32 permutation) is the order in which
    threads take queries; it changes no result. ``start`` (int32 node per
    query, ``SENTINEL``: no walk) replaces the root.

    With ``depths``, the (2n-1,) int32 node depth table
    (``repro_torch.core.query.node_depths``), returns ``(counts, stats)``:
    ``stats`` (6, q) int32, a row per ``TraversalStats`` field (``early_exits``
    as 0/1), from the kernel's counter instance."""
    _check_inputs(bvh, qa, qb, order, pred)
    q = qa.shape[0]
    _check_start(start, q, qa.device)
    if depths is not None and (depths.dtype != torch.int32
                               or depths.shape != (2 * bvh.num_leaves - 1,)):
        raise ValueError("depths must be the (2n-1,) int32 node depth table")
    if not qa.is_cuda:
        return wavefront_count_plain(bvh, qa, qb, stop_at, start, depths,
                                     pred=pred)
    out = torch.empty(q, dtype=torch.int32, device=qa.device)
    stats = None if depths is None else torch.empty(
        (_N_STATS, q), dtype=torch.int32, device=qa.device)
    if q:
        packed = _packed(bvh)
        lib = _lib()
        code = lib.wavefront_count(
            *_tree_args(packed, None), *_query_args(order, qa, qb, pred, start),
            -1 if stop_at is None else int(stop_at), _ptr(depths), _ptr(stats),
            _ptr(out), _stream())
        _build.check(lib, code, "wavefront_count")
        _launched(wavefront_count, pred, packed)
        if depths is not None:
            _build.count_launch(wavefront_count.counters)
    return out if depths is None else (out, stats)


def wavefront_min_label(bvh: Bvh, centers: torch.Tensor, r2: torch.Tensor,
                        obj_labels: torch.Tensor, obj_core: torch.Tensor,
                        queries_mask: torch.Tensor, sentinel: int, *,
                        order: torch.Tensor | None = None,
                        start: torch.Tensor | None = None) -> torch.Tensor:
    """(q,) in ``obj_labels``'s dtype: for each query in ``queries_mask``,
    the min over core objects within r of ``obj_labels`` (int32 or int64,
    tree object index); ``sentinel`` where none is hit and outside the
    mask. int64 labels take the MIN_LABEL64 instance (instance key
    ``"sphere/point/int64"``). Spheres on a point tree only."""
    _check_inputs(bvh, centers, r2, order)
    _spheres_on_points(bvh, "MIN_LABEL")
    if obj_labels.dtype not in (torch.int32, torch.int64) \
            or obj_core.dtype != torch.bool or queries_mask.dtype != torch.bool:
        raise ValueError("obj_labels must be int32 or int64, obj_core and "
                         "queries_mask bool")
    wide = obj_labels.dtype == torch.int64
    info = torch.iinfo(obj_labels.dtype)
    if not info.min <= int(sentinel) <= info.max:
        raise ValueError(f"sentinel {sentinel} is outside {obj_labels.dtype}")
    q = centers.shape[0]
    _check_start(start, q, centers.device)
    if not centers.is_cuda:
        return wavefront_min_label_plain(bvh, centers, r2, obj_labels,
                                         obj_core, queries_mask, sentinel,
                                         start)
    out = torch.empty(q, dtype=obj_labels.dtype, device=centers.device)
    if q == 0:
        return out
    packed = _packed(bvh)
    key = min_label_keys(bvh, obj_labels, obj_core, sentinel)
    lib = _lib()
    entry = lib.wavefront_min_label64 if wide else lib.wavefront_min_label
    code = entry(
        *_tree_args(packed, key), *_query_args(order, centers, r2, "sphere", start),
        _ptr(queries_mask), int(sentinel), _ptr(out), _stream())
    _build.check(lib, code, "wavefront_min_label")
    _launched(wavefront_min_label, "sphere", packed, "/int64" if wide else "")
    return out


def wavefront_fill(bvh: Bvh, qa: torch.Tensor, qb: torch.Tensor,
                   offsets: torch.Tensor, capacity: int, *,
                   pred: str = "sphere", order: torch.Tensor | None = None,
                   start: torch.Tensor | None = None) -> torch.Tensor:
    """(capacity,) int32 CSR indices: hit ``k`` of query ``qi`` of ``pred``,
    in traversal order, at ``offsets[qi] + k`` when that is below
    ``capacity``; hits at or past it are dropped, and -1 fills the rest.
    ``offsets`` is the (q+1,) int32 or int64 exclusive scan of the counts;
    positions are int64 in the kernel either way. ``order`` is the order
    in which threads take queries; it changes no result."""
    _check_inputs(bvh, qa, qb, order, pred)
    q, capacity = qa.shape[0], int(capacity)
    _check_start(start, q, qa.device)
    if offsets.dtype not in (torch.int32, torch.int64) \
            or offsets.shape != (q + 1,) or capacity < 0:
        raise ValueError("offsets must be (q+1,) int32 or int64 and "
                         "capacity >= 0")
    if not qa.is_cuda:
        return wavefront_fill_plain(bvh, qa, qb, offsets, capacity, start,
                                    pred=pred)
    indices = torch.full((capacity,), -1, dtype=torch.int32, device=qa.device)
    if q == 0 or capacity == 0:
        return indices
    packed = _packed(bvh)
    lib = _lib()
    code = lib.wavefront_fill(
        *_tree_args(packed, bvh.leaf_perm),
        *_query_args(order, qa, qb, pred, start), _ptr(offsets),
        int(offsets.dtype == torch.int64), capacity, _ptr(indices), _stream())
    _build.check(lib, code, "wavefront_fill")
    _launched(wavefront_fill, pred, packed)
    return indices


def wavefront_fixed(bvh: Bvh, qa: torch.Tensor, qb: torch.Tensor,
                    capacity: int, *, pred: str = "sphere",
                    order: torch.Tensor | None = None,
                    start: torch.Tensor | None = None):
    """``(buf, counts)``: ``buf`` (q, capacity) int32 holds hit ``k`` of
    each query of ``pred``, in traversal order, at slot ``min(k, capacity
    - 1)`` (so the last slot ends with the last hit), -1 in unused slots;
    ``counts`` (q,) int32 the true hit counts. ``order`` changes no
    result."""
    _check_inputs(bvh, qa, qb, order, pred)
    q, capacity = qa.shape[0], int(capacity)
    _check_start(start, q, qa.device)
    if capacity < 0:
        raise ValueError("capacity must be >= 0")
    if not qa.is_cuda:
        return wavefront_fixed_plain(bvh, qa, qb, capacity, start, pred=pred)
    buf = torch.full((q, capacity), -1, dtype=torch.int32, device=qa.device)
    counts = torch.empty(q, dtype=torch.int32, device=qa.device)
    if q == 0:
        return buf, counts
    packed = _packed(bvh)
    lib = _lib()
    code = lib.wavefront_fixed(
        *_tree_args(packed, bvh.leaf_perm),
        *_query_args(order, qa, qb, pred, start), capacity, _ptr(buf),
        _ptr(counts), _stream())
    _build.check(lib, code, "wavefront_fixed")
    _launched(wavefront_fixed, pred, packed)
    return buf, counts


def wavefront_potential(bvh: Bvh, centers: torch.Tensor, r2: torch.Tensor,
                        soft2: float, active: torch.Tensor | None = None, *,
                        order: torch.Tensor | None = None,
                        start: torch.Tensor | None = None) -> torch.Tensor:
    """(q,) float32: for each query in ``active`` (bool; None: all), the
    softened potential ``-Σ 1/sqrt(d2 + soft2)`` over the objects within
    r, summed in rope order; 0 outside ``active``, whose queries walk
    nothing. ``soft2`` is taken as float32. ``order`` changes no result.
    Spheres on a point tree only."""
    _check_inputs(bvh, centers, r2, order)
    _spheres_on_points(bvh, "POTENTIAL")
    q = centers.shape[0]
    _check_start(start, q, centers.device)
    if active is not None and (active.dtype != torch.bool
                               or active.shape != (q,)):
        raise ValueError("active must be a (q,) bool mask")
    if not centers.is_cuda:
        return wavefront_potential_plain(bvh, centers, r2, soft2, active,
                                         start)
    out = torch.empty(q, dtype=torch.float32, device=centers.device)
    if q == 0:
        return out
    packed = _packed(bvh)
    lib = _lib()
    code = lib.wavefront_potential(
        *_tree_args(packed, None),
        *_query_args(order, centers, r2, "sphere", start), _ptr(active),
        float(soft2), _ptr(out), _stream())
    _build.check(lib, code, "wavefront_potential")
    _launched(wavefront_potential, "sphere", packed)
    return out


def wavefront_edge(bvh: Bvh, centers: torch.Tensor, r2: torch.Tensor,
                   keys: torch.Tensor, capacity: int, *,
                   start: torch.Tensor | None = None):
    """``(buf, counts)`` of ``fdbscan_pair``'s capture: query k is leaf
    k's point (``centers`` (n, 3) and ``r2`` (n,) in leaf order) walking
    from ``start[k]`` (:func:`pair_starts` for the pair backend); it takes
    hit objects whose key (:func:`pair_keys`) is core with another root
    than its own into ``buf[k, min(taken, capacity - 1)]`` ((n, capacity)
    int32, -1 in unused slots) and stops once ``capacity`` are taken;
    ``counts`` (n,) int32 the edges taken. A query that is not core walks
    nothing. Spheres on a point tree only."""
    _check_inputs(bvh, centers, r2, None)
    _spheres_on_points(bvh, "EDGE")
    q, capacity = centers.shape[0], int(capacity)
    _check_start(start, q, centers.device)
    if q != bvh.num_leaves or keys.dtype != torch.int32 \
            or keys.shape != (q, 2) or keys.device != centers.device \
            or capacity < 1:
        raise ValueError("EDGE's queries are the tree's n leaves, with (n, 2) "
                         "int32 keys on their device, and capacity >= 1")
    if not centers.is_cuda:
        return wavefront_edge_plain(bvh, centers, r2, keys, capacity, start)
    buf = torch.full((q, capacity), -1, dtype=torch.int32, device=centers.device)
    counts = torch.empty(q, dtype=torch.int32, device=centers.device)
    packed = _packed(bvh)
    lib = _lib()
    code = lib.wavefront_edge(
        *_tree_args(packed, None), *_query_args(None, centers, r2, "sphere", start),
        _ptr(keys.contiguous()), capacity, _ptr(buf), _ptr(counts), _stream())
    _build.check(lib, code, "wavefront_edge")
    _launched(wavefront_edge, "sphere", packed)
    return buf, counts


def wavefront_histogram(bvh: Bvh, centers: torch.Tensor, r2: torch.Tensor,
                        r_max: float, n_bins: int, *,
                        start: torch.Tensor | None = None) -> torch.Tensor:
    """(n_bins,) int64: every hit of the queries binned by distance,
    :func:`histogram_bins` with ``r_max`` taken as float32 (for the pair
    correlation: ``centers`` the tree's points in leaf order, ``start``
    :func:`pair_starts`). On the card up to ``SHARED_HISTOGRAM_BINS`` bins
    are summed in a block's shared memory, more straight into the global
    bins; integer sums, so both give the same counts. Spheres on a point
    tree only."""
    _check_inputs(bvh, centers, r2, None)
    _spheres_on_points(bvh, "HISTOGRAM")
    q, n_bins = centers.shape[0], int(n_bins)
    _check_start(start, q, centers.device)
    if n_bins < 1:
        raise ValueError("n_bins must be >= 1")
    if not centers.is_cuda:
        return wavefront_histogram_plain(bvh, centers, r2, r_max, n_bins, start)
    hist = torch.zeros(n_bins, dtype=torch.int64, device=centers.device)
    if q == 0:
        return hist
    packed = _packed(bvh)
    lib = _lib()
    code = lib.wavefront_histogram(
        *_tree_args(packed, None), *_query_args(None, centers, r2, "sphere", start),
        float(r_max), n_bins, _ptr(hist), _stream())
    _build.check(lib, code, "wavefront_histogram")
    _launched(wavefront_histogram, "sphere", packed)
    return hist


def _check_dense(bvh, centers, words, pts, scan_lab, qmask):
    q, n, dev = centers.shape[0], bvh.num_leaves, centers.device
    if words.dtype != torch.int32 or words.shape != (n, 4):
        raise ValueError("words must be the (n, 4) int32 leaf words")
    if pts.dtype != torch.float32 or pts.shape != (n, 3):
        raise ValueError("pts must be the (n, 3) float32 grid-sorted points")
    if scan_lab is not None and (scan_lab.dtype != torch.int32
                                 or scan_lab.shape != (n,)):
        raise ValueError("scan_lab must be (n,) int32")
    if qmask is not None and (qmask.dtype != torch.bool or qmask.shape != (q,)):
        raise ValueError("qmask must be a (q,) bool mask")
    if any(t is not None and t.device != dev for t in (words, pts, scan_lab, qmask)):
        raise ValueError("words, pts, scan_lab and qmask must be on the "
                         "queries' device")


def _dense_launch(wrapper, bvh, centers, r2, words, pts, scan_lab, half,
                  stop_at, qmask, sentinel, order):
    q = centers.shape[0]
    out = torch.empty(q, dtype=torch.int32, device=centers.device)
    if q == 0:
        return out
    packed = _packed(bvh)
    lib = _lib()
    code = lib.wavefront_dense(
        *_tree_args(packed, None), *_query_args(order, centers, r2, "sphere", None),
        int(scan_lab is not None), _ptr(words.contiguous()), _ptr(pts.contiguous()),
        _ptr(scan_lab), float(half), -1 if stop_at is None else int(stop_at),
        _ptr(qmask), int(sentinel), _ptr(out), _stream())
    _build.check(lib, code, "wavefront_dense")
    _launched(wrapper, "sphere", packed)
    return out


def wavefront_dense_count(bvh: Bvh, centers: torch.Tensor, r2: torch.Tensor,
                          words: torch.Tensor, pts: torch.Tensor, half: float,
                          *, stop_at: int | None = None,
                          qmask: torch.Tensor | None = None,
                          order: torch.Tensor | None = None) -> torch.Tensor:
    """(q,) int32: DenseBox's neighbour counts (:func:`dense_epilogue`) on
    its mixed tree, for queries in ``qmask`` (None: all), 0 elsewhere;
    done at ``stop_at``. ``words`` (:func:`dense_leaves`), ``pts`` the
    (n, 3) grid-sorted points, ``half`` half the cell size (float32).
    ``order`` changes no result. Spheres on a box-leaf tree only."""
    _check_inputs(bvh, centers, r2, order)
    _spheres_on_boxes(bvh, "DENSE_COUNT")
    _check_dense(bvh, centers, words, pts, None, qmask)
    if not centers.is_cuda:
        return wavefront_dense_count_plain(bvh, centers, r2, words, pts, half,
                                           stop_at, qmask)
    return _dense_launch(wavefront_dense_count, bvh, centers, r2, words, pts,
                         None, half, stop_at, qmask, 0, order)


def wavefront_dense_min_label(bvh: Bvh, centers: torch.Tensor,
                              r2: torch.Tensor, words: torch.Tensor,
                              pts: torch.Tensor, scan_lab: torch.Tensor,
                              half: float, qmask: torch.Tensor,
                              sentinel: int, *,
                              order: torch.Tensor | None = None) -> torch.Tensor:
    """(q,) int32: DenseBox's min labels (:func:`dense_epilogue`) on its
    mixed tree for queries in ``qmask``, ``sentinel`` elsewhere and where
    nothing is hit; ``scan_lab`` (n,) int32 the label of each grid-sorted
    point. ``order`` changes no result. Spheres on a box-leaf tree
    only."""
    _check_inputs(bvh, centers, r2, order)
    _spheres_on_boxes(bvh, "DENSE_MIN_LABEL")
    _check_dense(bvh, centers, words, pts, scan_lab, qmask)
    if not centers.is_cuda:
        return wavefront_dense_min_label_plain(bvh, centers, r2, words, pts,
                                               scan_lab, half, qmask, sentinel)
    return _dense_launch(wavefront_dense_min_label, bvh, centers, r2, words,
                         pts, scan_lab.contiguous(), half, None, qmask,
                         sentinel, order)


def inv_sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """1/sqrt(x) of float32 values by POTENTIAL's sequence: on the card the
    kernel's own (``rsqrt_probe_kernel``), on the CPU its plain version,
    which the kernel must equal bit for bit."""
    if x.dtype != torch.float32:
        raise ValueError("x must be float32")
    if not x.is_cuda:
        return inv_sqrt_plain(x)
    x = x.contiguous()
    y = torch.empty_like(x)
    if x.numel():
        lib = _lib()
        code = lib.wavefront_rsqrt_probe(_ptr(x), _ptr(y), x.numel(), _stream())
        _build.check(lib, code, "wavefront_rsqrt_probe")
    return y


def histogram_bins_rn(d2: torch.Tensor, r_max: float, n_bins: int) -> torch.Tensor:
    """int64 bins of float32 squared distances by HISTOGRAM's sequence: on
    the card the kernel's own (``bin_probe_kernel``), on the CPU
    :func:`histogram_bins`, which the kernel must equal."""
    if d2.dtype != torch.float32:
        raise ValueError("d2 must be float32")
    if not d2.is_cuda:
        return histogram_bins(d2, r_max, n_bins)
    d2 = d2.contiguous()
    out = torch.empty(d2.shape, dtype=torch.int32, device=d2.device)
    if d2.numel():
        lib = _lib()
        code = lib.wavefront_bin_probe(_ptr(d2), _ptr(out), d2.numel(),
                                       float(r_max), int(n_bins), _stream())
        _build.check(lib, code, "wavefront_bin_probe")
    return out.long()


for _wrapper in (wavefront_count, wavefront_min_label, wavefront_fill,
                 wavefront_fixed, wavefront_potential, wavefront_edge,
                 wavefront_histogram, wavefront_dense_count,
                 wavefront_dense_min_label):
    _wrapper.launches = 0
    _wrapper.instances = collections.Counter()
del _wrapper
# Of COUNT's launches, those of its counter instance (``depths`` given).
wavefront_count.counters = types.SimpleNamespace(launches=0)
