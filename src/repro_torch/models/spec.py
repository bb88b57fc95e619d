"""Parameter-spec machinery; port of ``repro/models/spec.py``: one source
of truth for shapes, logical axes and initializers.

Every model module builds a nested dict of ``TensorSpec`` leaves, and
from that one tree come ``init_params`` (materialized parameters),
``abstract_params`` (``meta`` tensors: the dry run's stand-ins, no memory
at any size), ``count_params`` and ``param_axes``. The logical axis names
are the reference's ("embed", "mlp", "heads", "kv", "qkv", "vocab",
"experts", "layers", None); ``repro_torch.parallel.sharding`` maps them
onto mesh axes.
"""
from __future__ import annotations

import hashlib
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import keystr

__all__ = ["TensorSpec", "is_spec", "init_params", "abstract_params", "param_axes",
           "count_params", "stack_specs", "spec_map"]


class TensorSpec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"      # normal | zeros | ones | embed
    scale: float | None = None  # stddev override; default fan-in

    def with_leading(self, n: int, axis_name: str | None = "layers") -> "TensorSpec":
        return TensorSpec((n,) + self.shape, (axis_name,) + self.axes, self.init, self.scale)


def is_spec(x: Any) -> bool:
    return isinstance(x, TensorSpec)


def spec_map(fn, spec_tree):
    """``fn`` over the specs of a nested dict of ``TensorSpec`` leaves (a
    spec is a NamedTuple, so the generic tree walk would enter it)."""
    if is_spec(spec_tree):
        return fn(spec_tree)
    return {k: spec_map(fn, v) for k, v in spec_tree.items()}


def _spec_leaves(spec_tree, keys=()):
    """``[(dict keys, spec)]`` in sorted-key order."""
    if is_spec(spec_tree):
        return [(keys, spec_tree)]
    out = []
    for k in sorted(spec_tree):
        out += _spec_leaves(spec_tree[k], keys + (k,))
    return out


def _leaf_seed(seed: int, keys) -> int:
    """The leaf's generator seed: the first four bytes of the md5 of the
    seed and the leaf's path (``['layers']['sub0_mlstm']...``), as the
    reference folds the path's md5 into its key. Four bytes, since torch's
    CPU generator keeps only the low 32 bits of a seed."""
    path = keystr(tuple(f"[{k!r}]" for k in keys))
    return int.from_bytes(hashlib.md5(f"{seed}{path}".encode()).digest()[:4], "big")


def _init_leaf(spec: TensorSpec, gen: torch.Generator, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "embed":
        std = spec.scale if spec.scale is not None else 1.0
    else:
        # fan-in normal: last axis is the output dim by our convention (in, out)
        fan_in = int(np.prod(spec.shape[:-1])) if len(spec.shape) > 1 else spec.shape[0]
        std = spec.scale if spec.scale is not None else fan_in ** -0.5
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)     # in place: one float32 copy of the leaf


def init_params(spec_tree, seed: int = 0, dtype=torch.float32, device=None):
    """Materialize parameters on ``device`` (``None``: the card): one
    ``torch.Generator`` a leaf, on that device, seeded from the seed and
    the leaf's path. The values are torch's draws, not the reference's,
    and the CPU's and the card's generators draw differently for the same
    seed (carry weights across with ``repro_torch.interop.params_from_numpy``
    to compare two runs)."""
    device = resolve_device(device)
    out = {}
    for keys, spec in _spec_leaves(spec_tree):
        gen = torch.Generator(device=device)
        gen.manual_seed(_leaf_seed(seed, keys))
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _init_leaf(spec, gen, dtype, device)
    return out


def abstract_params(spec_tree, dtype=torch.float32):
    """``meta`` tensors of the specs' shapes: dry-run stand-ins that
    allocate nothing."""
    return spec_map(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"),
                    spec_tree)


def param_axes(spec_tree):
    return spec_map(lambda s: s.axes, spec_tree)


def count_params(spec_tree) -> int:
    return int(sum(np.prod(s.shape) for _, s in _spec_leaves(spec_tree)))


def stack_specs(spec_tree, n: int):
    """Add a leading scan-layer axis of size n to every leaf."""
    return spec_map(lambda s: s.with_leading(n), spec_tree)
