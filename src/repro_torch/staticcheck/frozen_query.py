"""Frozen twin of the port's stats-off spatial count path; the port's
counterpart of ``repro/staticcheck/frozen_query.py``.

This module is a VERBATIM snapshot of what ``core/query.py`` runs for a
``query_count(bvh, within(...))`` call with ``with_stats=False``: the
sphere geometry of ``query_geometry``, then on the stackless (and pallas)
backend ``kernels/wavefront.py``'s ``wavefront_count`` (on the card the
COUNT launch without counters, on the CPU its plain lockstep walk with the
COUNT epilogue), and on the stack backend ``stack_traverse`` with the
same epilogue. The ``obs/stats_path_identity`` audit runs both this twin
and the live engine and requires the same ATen ops on the same shapes and
dtypes, op for op: the machine check that observability costs nothing
when it is off (no counter arithmetic leaks into the hot path). On the
card it also reads the launch counters: the stats-off call launches no
counter instance. The twin's own COUNT launch goes through the wrapper's
counter (``_launched``), as every launch of the kernel does.

Do NOT refactor this file to track engine changes mechanically: it only
moves when the engine's *stats-off* program intentionally changes, and
such a change must be a conscious decision (update both, re-run
``python -m repro_torch.staticcheck --ops``).
"""
from __future__ import annotations

import torch

from repro_torch.core.bvh import SENTINEL, Bvh
from repro_torch.core.geometry import point_aabb_dist2
from repro_torch.core.query import Within
from repro_torch.kernels import _build
from repro_torch.kernels.nearest import STACK_DEPTH
from repro_torch.kernels.wavefront import (_launched, _lib, _packed, _ptr,
                                           _query_args, _stream, _tree_args,
                                           wavefront_count)

__all__ = ["frozen_count_stackless", "frozen_count_stack"]

_INT32_MAX = 2**31 - 1


def _frozen_r2(pred: Within) -> torch.Tensor:
    r = pred.radii.to(torch.float32)
    return r * r


def _frozen_geometry(pred: Within):
    return pred.centers.to(torch.float32).contiguous(), _frozen_r2(pred)


def _frozen_epilogue():
    stop = _INT32_MAX

    def epilogue(count, _node, leaf_hit, _d2):
        count = count + leaf_hit.to(count.dtype)
        return count, leaf_hit & (count >= stop)
    return epilogue


def _frozen_lockstep(bvh: Bvh, qa, qb, lanes, carry0, epilogue):
    n = bvh.num_leaves
    left, rope = bvh.left_child.long(), bvh.rope.long()
    out = carry0.clone()
    node = torch.zeros_like(lanes)
    walks = node != SENTINEL
    pos = torch.nonzero(walks).flatten()
    node, carry = node[walks], carry0[walks]
    a, b = qa[lanes[walks]], qb[lanes[walks]]
    hops = 0
    while pos.numel():  # staticcheck: bvh-loop-ok (frozen twin)
        hops += pos.numel()
        d2 = point_aabb_dist2(a, bvh.node_lo[node], bvh.node_hi[node])
        hit = d2 <= b
        is_leaf = node >= n - 1
        carry, done = epilogue(carry, node, is_leaf & hit, d2)
        node = torch.where(hit & ~is_leaf, left[node.clamp(max=n - 2)],
                           rope[node])
        live = (node != SENTINEL) & ~done
        fin = ~live
        out[pos[fin]] = carry[fin]
        pos, node, carry = pos[live], node[live], carry[live]
        a, b = a[live], b[live]
    return out, hops


def _frozen_stack(bvh: Bvh, qa, qb, lanes, carry0, epilogue):
    n, m, dev = bvh.num_leaves, lanes.numel(), lanes.device
    left, right = bvh.left_child.long(), bvh.right_child.long()
    stack = torch.full((m, STACK_DEPTH), SENTINEL, dtype=torch.int32,
                       device=dev)
    stack[:, 0] = 0
    out = carry0.clone()
    pos = torch.arange(m, device=dev)
    sp = torch.ones(m, dtype=torch.int64, device=dev)
    carry, a, b = carry0, qa[lanes], qb[lanes]
    hops = 0
    while pos.numel():  # staticcheck: bvh-loop-ok (frozen twin)
        hops += pos.numel()
        sp = sp - 1
        node = stack[pos, sp].long()
        d2 = point_aabb_dist2(a, bvh.node_lo[node], bvh.node_hi[node])
        hit = d2 <= b
        is_leaf = node >= n - 1
        carry, done = epilogue(carry, node, is_leaf & hit, d2)
        push = torch.nonzero(hit & ~is_leaf).flatten()
        nc, row, top = node[push], pos[push], sp[push]
        stack[row, top] = right[nc].to(torch.int32)
        stack[row, top + 1] = left[nc].to(torch.int32)
        sp[push] += 2
        live = (sp > 0) & ~done
        fin = ~live
        out[pos[fin]] = carry[fin]
        pos, sp, carry = pos[live], sp[live], carry[live]
        a, b = a[live], b[live]
    return out, hops


def frozen_count_stackless(bvh: Bvh, pred: Within) -> torch.Tensor:
    """What ``query_count(bvh, pred)`` runs with stats off (rope
    backend; ``backend="pallas"`` is the same path)."""
    qa, qb = _frozen_geometry(pred)
    q = qa.shape[0]
    if not qa.is_cuda:
        lanes = torch.arange(q, device=qa.device)
        zeros = torch.zeros(q, dtype=torch.int32, device=qa.device)
        return _frozen_lockstep(bvh, qa, qb, lanes, zeros, _frozen_epilogue())[0]
    out = torch.empty(q, dtype=torch.int32, device=qa.device)
    if q:
        packed = _packed(bvh)
        lib = _lib()
        code = lib.wavefront_count(
            *_tree_args(packed, None), *_query_args(None, qa, qb, "sphere", None),
            -1, _ptr(None), _ptr(None), _ptr(out), _stream())
        _build.check(lib, code, "wavefront_count")
        _launched(wavefront_count, "sphere", packed)
    return out


def frozen_count_stack(bvh: Bvh, pred: Within) -> torch.Tensor:
    """What ``query_count(bvh, pred, backend='stack')`` runs with stats
    off."""
    qa, qb = _frozen_geometry(pred)
    lanes = torch.arange(qa.shape[0], device=qa.device)
    zeros = torch.zeros(qa.shape[0], dtype=torch.int32, device=qa.device)
    return _frozen_stack(bvh, qa, qb, lanes, zeros, _frozen_epilogue())[0]
