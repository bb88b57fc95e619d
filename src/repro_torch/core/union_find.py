"""Pointer jumping; port of ``repro/core/union_find.py`` (``compress``)."""
from __future__ import annotations

import torch

__all__ = ["compress"]


def compress(parent: torch.Tensor) -> torch.Tensor:
    """Full path compression: parent <- parent[parent] until fixpoint."""
    while True:
        p2 = parent[parent.long()]
        if not bool((p2 != parent).any()):
            return p2
        parent = p2
