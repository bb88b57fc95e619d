"""Sublayer/group assembly; port of ``repro/models/blocks.py``: every
architecture is n_groups repeats of a block_pattern of sublayers.

The port builds the xLSTM kinds, ``mlstm`` and ``slstm``; every other
kind, and a dense or MoE FFN (``d_ff > 0``), raises
``NotImplementedError`` (ROADMAP A14 (b)-(d)). The reference's
``constrain_*`` calls are sharding constraints, the identity without a
mesh (``parallel/sharding.py:165-262``), so the port has none.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S

PORTED_KINDS = ("mlstm", "slstm")


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP A14); the port builds the "
        f"{'/'.join(PORTED_KINDS)} blocks of xlstm-350m")


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise unported(f"block kind {kind!r}")
    if cfg.d_ff > 0:
        raise unported(f"the dense FFN (d_ff={cfg.d_ff})")


def sublayer_spec(cfg: ModelConfig, kind: str, layer_in_group: int = 0) -> dict:
    _check_kind(cfg, kind)
    d = cfg.d_model
    spec: dict = {"norm1": L.rmsnorm_spec(d)}
    if kind == "mlstm":
        spec["mlstm"] = S.mlstm_spec(cfg)
    else:
        spec["slstm"] = S.slstm_spec(cfg)
    if cfg.sandwich_norm:
        spec["norm1_post"] = L.rmsnorm_spec(d)
    return spec


def sublayer_cache_shape(cfg: ModelConfig, kind: str, batch: int, cache_len: int):
    """Zero-initialized decode cache for one sublayer: {name: (shape,
    dtype)}. The recurrent states are f32 and do not grow with
    ``cache_len``."""
    _check_kind(cfg, kind)
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    f32 = torch.float32
    if kind == "mlstm":
        return {"C": ((batch, h, hd, hd), f32), "n": ((batch, h, hd), f32)}
    return {"h": ((batch, h, hd), f32), "c": ((batch, h, hd), f32),
            "n": ((batch, h, hd), f32)}


def sublayer_apply(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                   ctx: dict, cache: dict | None):
    """Returns (x, new_cache, aux_loss). ctx keys: positions, mode
    ("train" | "prefill" | "decode"), cache_pos."""
    _check_kind(cfg, kind)
    mode = ctx["mode"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict = {}

    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if kind == "mlstm":
        if mode == "decode":
            out, (C, n) = S.mlstm(p["mlstm"], cfg, h, state=(cache["C"], cache["n"]))
            new_cache = {"C": C, "n": n}
        else:
            out, (C, n) = S.mlstm(p["mlstm"], cfg, h)
            if mode == "prefill":
                new_cache = {"C": C, "n": n}
    else:
        if mode == "decode":
            out, (hs, cs, ns) = S.slstm(p["slstm"], cfg, h,
                                        state=(cache["h"], cache["c"], cache["n"]))
            new_cache = {"h": hs, "c": cs, "n": ns}
        else:
            out, (hs, cs, ns) = S.slstm(p["slstm"], cfg, h)
            if mode == "prefill":
                new_cache = {"h": hs, "c": cs, "n": ns}

    if cfg.sandwich_norm:
        out = L.rmsnorm(p["norm1_post"], out, cfg.norm_eps)
    return x + out, new_cache, aux


def group_spec(cfg: ModelConfig) -> dict:
    return {f"sub{i}_{kind}": sublayer_spec(cfg, kind, i)
            for i, kind in enumerate(cfg.block_pattern)}


def group_apply(cfg: ModelConfig, params: dict, x: torch.Tensor, ctx: dict,
                cache: dict | None):
    """Apply one pattern group. cache: {subkey: subcache} or None."""
    new_cache: dict = {}
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(cfg.block_pattern):
        key = f"sub{i}_{kind}"
        sub_cache = cache.get(key) if cache is not None else None
        x, nc, aux = sublayer_apply(cfg, kind, params[key], x, ctx, sub_cache)
        if nc:
            new_cache[key] = nc
        aux_total = aux_total + aux
    return x, new_cache, aux_total


def group_cache_shapes(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    return {f"sub{i}_{kind}": sublayer_cache_shape(cfg, kind, batch, cache_len)
            for i, kind in enumerate(cfg.block_pattern)}
