"""Sharding rules: logical tensor axes -> mesh axes; port of
``repro/parallel/sharding.py``, as pure data functions.

Training layout (MaxText-class): FSDP/ZeRO-3 over the data axes ("pod" and
"data" compose for multi-pod), tensor parallelism over "model", expert
parallelism over "model" for the MoE expert dim. Serving layouts shard KV
caches batch-over-data and sequence-over-model (SP-decode) because kv-head
counts (1, 4, 8, 10) rarely divide a 16-wide model axis.

Divisibility guard: a mesh axis is only applied to a tensor dim it divides
evenly; otherwise the rule degrades (prefix of the axis tuple, then
replicated). MQA (kv=1) and small head counts fall out automatically.

A mesh is anything with the axis sizes by name: the abstract production
meshes of ``repro_torch.launch.mesh`` (``.shape``, ``.axis_names``) or a
``torch.distributed.device_mesh.DeviceMesh`` (``.mesh_dim_names``).
``PartitionSpec`` is the port's own: one entry per tensor dim, each
``None``, a mesh axis name or a tuple of names.
``param_placements`` maps the specs onto a ``DeviceMesh`` as DTensor
placements. The reference's ``constrain_*`` hooks are not ported: the
port's models run on one device, with no partitioner to read them. The
``set_*`` setters keep the pins the dry run makes, so that it can record
them.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.models.spec import TensorSpec, spec_map
from repro_torch.tree import keystr, leaves_with_path, tree_map


class PartitionSpec:
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (the dim split over their product). Not a tuple,
    so that the port's tree walks keep it whole as a leaf; it iterates
    and compares like the tuple of its entries."""
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec

# logical axis -> mesh axes (tuples compose). None = replicate.
TRAIN_RULES: dict[str | None, Any] = {
    "embed": ("pod", "data"),     # FSDP: parameters sharded over data axes
    "mlp": "model",               # TP: ffn hidden
    "heads": "model",             # TP: attention heads
    "kv": "model",
    "qkv": None,
    "vocab": "model",             # TP: vocab/logits
    "experts": "model",           # EP
    "layers": None,
    None: None,
}

# Serving: weights stay FSDP+TP sharded (gathered on use); activations are
# batch-sharded. Same param rules work for decode.
SERVE_RULES = TRAIN_RULES


def _axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _mesh_axis_sizes(mesh) -> dict[str, int]:
    if getattr(mesh, "mesh_dim_names", None) is not None:   # a DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _fit_axes(dim: int, want, sizes: dict[str, int]):
    """Return the longest prefix of mesh axes whose product divides dim."""
    if want is None:
        return None
    axes = (want,) if isinstance(want, str) else tuple(want)
    out = []
    prod = 1
    for a in axes:
        if a not in sizes:
            continue
        if dim % (prod * sizes[a]) == 0:
            out.append(a)
            prod *= sizes[a]
        else:
            break
    if not out:
        return None
    return tuple(out) if len(out) > 1 else out[0]


def pspec_for(spec: TensorSpec, mesh, rules: dict | None = None) -> PartitionSpec:
    rules = rules or TRAIN_RULES
    sizes = _mesh_axis_sizes(mesh)
    entries = []
    used: set[str] = set()
    for dim, ax in zip(spec.shape, spec.axes):
        want = rules.get(ax)
        fit = _fit_axes(dim, want, sizes)
        # a mesh axis may appear at most once per PartitionSpec
        if fit is not None:
            flat = (fit,) if isinstance(fit, str) else fit
            flat = tuple(a for a in flat if a not in used)
            used.update(flat)
            fit = None if not flat else (flat if len(flat) > 1 else flat[0])
        entries.append(fit)
    return P(*entries)


def param_pspecs(spec_tree, mesh, rules: dict | None = None):
    return spec_map(lambda s: pspec_for(s, mesh, rules), spec_tree)


def placements_for(pspec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``pspec`` on a ``DeviceMesh``: per mesh dim,
    ``Shard(d)`` when tensor dim ``d``'s entry names it, else
    ``Replicate()``. A dim over ``("pod", "data")`` is ``Shard(d)`` on
    both, split pod-major as the reference's tuple entry is."""
    from torch.distributed.tensor import Replicate, Shard
    on = {}
    for d, entry in enumerate(pspec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            on[ax] = d
    return tuple(Shard(on[ax]) if ax in on else Replicate()
                 for ax in _axis_names(mesh))


def param_placements(spec_tree, mesh, rules: dict | None = None):
    """The reference's ``param_shardings`` on a ``DeviceMesh``: the
    placements of each leaf's ``pspec_for``."""
    return spec_map(lambda s: placements_for(pspec_for(s, mesh, rules), mesh),
                    spec_tree)


def batch_axes(mesh) -> tuple[str, ...]:
    names = _axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def data_pspec(mesh, batch: int, ndim: int) -> PartitionSpec:
    """Batch dim over the data axes (when divisible), rest replicated."""
    sizes = _mesh_axis_sizes(mesh)
    axes = batch_axes(mesh)
    prod = math.prod(sizes[a] for a in axes)
    first = axes if axes and batch % prod == 0 else None
    if first is not None and len(first) == 1:
        first = first[0]
    return P(first, *([None] * (ndim - 1)))


def cache_pspec(mesh, leaf_shape: tuple[int, ...],
                batch_dim: int = 1) -> PartitionSpec:
    """Decode-cache layout: batch over data axes if divisible; the largest
    remaining dim (sequence / d_inner / head_dim) over "model" if divisible.
    Stacked caches are (n_groups, B, ...) => batch_dim=1 by default; the
    non-scanned layer0 cache is (B, ...) => batch_dim=0."""
    sizes = _mesh_axis_sizes(mesh)
    axes = batch_axes(mesh)
    dprod = math.prod(sizes[a] for a in axes)
    entries: list = [None] * len(leaf_shape)
    bd = min(batch_dim, len(leaf_shape) - 1)
    if axes and leaf_shape[bd] % dprod == 0:
        entries[bd] = axes if len(axes) > 1 else axes[0]
    m = sizes.get("model", 1)
    if m > 1 and len(leaf_shape) > bd + 1:
        # largest dim after the batch dim divisible by the model axis
        cands = [(d, i) for i, d in enumerate(leaf_shape[bd + 1:], start=bd + 1)
                 if d % m == 0]
        if cands:
            _, idx = max(cands)
            entries[idx] = "model"
    return P(*entries)


def cache_pspecs(cache_tree, mesh):
    """``cache_pspec`` of every leaf of a decode cache (``lm.init_cache``),
    the batch dim 0 under ``layer0`` and 1 elsewhere."""
    specs = {keystr(path): cache_pspec(
        mesh, tuple(x.shape), 0 if "layer0" in keystr(path) else 1)
        for path, x in leaves_with_path(cache_tree)}
    it = iter(specs.values())
    return tree_map(lambda _: next(it), cache_tree)


def cache_shardings(cache_tree, mesh):
    """The placements of ``cache_pspecs`` on a ``DeviceMesh``."""
    return tree_map(lambda s: placements_for(s, mesh), cache_pspecs(cache_tree, mesh))


def decode_score_pspec(mesh) -> PartitionSpec:
    """(B, H, 1, S_kv) decode scores: flash-decode — batch over data,
    KV-seq over model, softmax reduced with tiny cross-shard collectives."""
    axes = batch_axes(mesh)
    first = axes if len(axes) > 1 else (axes[0] if axes else None)
    return P(first, None, None, "model")


def default_activation_pspec(mesh, seq_divisible: bool = True) -> PartitionSpec:
    """(B, S, D) residual stream: batch over data axes, seq over model."""
    axes = batch_axes(mesh)
    first = axes if len(axes) > 1 else (axes[0] if axes else None)
    return P(first, "model" if seq_divisible else None, None)


def default_attn_input_pspec(mesh) -> PartitionSpec:
    """(B, S, D) attention and block inputs: batch over data, the rest
    replicated (the Megatron-SP gather point)."""
    axes = batch_axes(mesh)
    first = axes if len(axes) > 1 else (axes[0] if axes else None)
    return P(first, None, None)


def default_score_pspec(mesh, n_heads: int | None = None) -> PartitionSpec:
    """(B, H, S_q, S_kv): shard heads over "model" when divisible (Megatron
    attention — dk/dv stay local); else shard query-seq (costs a dk/dv
    all-reduce in backward, but never replicates the S x S tensor)."""
    axes = batch_axes(mesh)
    first = axes if len(axes) > 1 else (axes[0] if axes else None)
    m = _mesh_axis_sizes(mesh).get("model", 1)
    if n_heads is not None and n_heads % m == 0:
        return P(first, "model", None, None)
    return P(first, None, "model", None)


# --- the pins a planner sets ------------------------------------------------
# The reference reads these in its ``constrain_*`` hooks; the port's dry run
# sets them as the reference's does and records them (``pinned``).

_PINS: dict[str, PartitionSpec | None] = {
    "activation": None,     # (B, S, D) residual stream (Megatron-SP)
    "attn_input": None,     # attention inputs gathered back to seq-replicated
    "block_input": None,    # (B, S, D) block inputs, feature dim replicated
    "score": None,          # (B, H, S_q, S_kv) attention scores
    "decode_score": None,   # (B, H, 1, S_kv) decode scores
}


def set_activation_pspec(spec: PartitionSpec | None) -> None:
    _PINS["activation"] = spec


def set_attn_input_pspec(spec: PartitionSpec | None) -> None:
    _PINS["attn_input"] = spec


def set_block_input_pspec(spec: PartitionSpec | None) -> None:
    _PINS["block_input"] = spec


def set_score_pspec(spec: PartitionSpec | None) -> None:
    _PINS["score"] = spec


def set_decode_score_pspec(spec: PartitionSpec | None) -> None:
    _PINS["decode_score"] = spec


def pinned() -> dict[str, PartitionSpec | None]:
    """The specs the setters last pinned, by name."""
    return dict(_PINS)
