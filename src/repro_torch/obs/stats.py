"""Per-query traversal counters; port of ``repro/obs/stats.py``.

``query_count(with_stats=True)`` returns them beside the counts: the
kernel's counter instance writes them on the card, the plain lockstep
walk on the CPU, column for column as the reference's ``stackless`` and
``pallas`` backends count them. Inside a sharded body
(``core/mesh.py``), :meth:`TraversalStats.psum` reduces them across the
shards.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["TraversalStats"]


class TraversalStats(NamedTuple):
    """Per-query traversal counters (all fields shaped ``(q,)``).

    ``nodes_visited``: loop iterations (internal nodes and leaves);
    ``aabb_tests``: internal-node box tests; ``leaf_tests``: leaf tests,
    the exact predicate for point leaves; ``callback_hits``: leaves that
    satisfied the predicate; ``early_exits``: whether the walk ended on
    the epilogue's ``done``; ``max_depth``: depth of the deepest node
    visited."""

    nodes_visited: torch.Tensor  # (q,) int32
    aabb_tests: torch.Tensor     # (q,) int32
    leaf_tests: torch.Tensor     # (q,) int32
    callback_hits: torch.Tensor  # (q,) int32
    early_exits: torch.Tensor    # (q,) bool
    max_depth: torch.Tensor      # (q,) int32

    @classmethod
    def from_rows(cls, rows: torch.Tensor) -> "TraversalStats":
        """From the (6, q) int32 counter rows of the traversal kernel, in
        field order, ``early_exits`` as 0/1."""
        return cls(*(rows[i].bool() if f == "early_exits" else rows[i]
                     for i, f in enumerate(cls._fields)))

    def totals(self) -> dict[str, torch.Tensor]:
        """Batch-level scalars (still on the device): sums of the
        counters, the count of early exits, the max of the depths."""
        zero = torch.zeros((), dtype=torch.int32,
                           device=self.max_depth.device)
        return {
            "nodes_visited": self.nodes_visited.sum(dtype=torch.int32),
            "aabb_tests": self.aabb_tests.sum(dtype=torch.int32),
            "leaf_tests": self.leaf_tests.sum(dtype=torch.int32),
            "callback_hits": self.callback_hits.sum(dtype=torch.int32),
            "early_exits": self.early_exits.sum(dtype=torch.int32),
            "max_depth": torch.cat([self.max_depth, zero.view(1)]).max(),
        }

    def psum(self, axis) -> "TraversalStats":
        """Cross-shard reduction (call inside a ``ShardMesh`` body, ``axis``
        its handle): counters sum, the depth high-water mark maxes,
        ``early_exits`` stays the per-query local column."""
        return TraversalStats(
            nodes_visited=axis.psum(self.nodes_visited),
            aabb_tests=axis.psum(self.aabb_tests),
            leaf_tests=axis.psum(self.leaf_tests),
            callback_hits=axis.psum(self.callback_hits),
            early_exits=self.early_exits,
            max_depth=axis.pmax(self.max_depth),
        )
