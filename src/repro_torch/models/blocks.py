"""Sublayer/group assembly; port of ``repro/models/blocks.py``: every
architecture is n_groups repeats of a block_pattern of sublayers.

Every kind of the reference: self-attention (``attn``, ``attn_local``),
cross-attention to the encoder's or the frontend's memory (``cross``),
Mamba and the xLSTM pair (``mamba``, ``mlstm``, ``slstm``), each with a
dense FFN when ``d_ff > 0`` or an MoE FFN in its ``*_moe`` form, and the
sandwich norms. An unknown kind raises ``ValueError``. The reference's
``constrain_*`` calls are sharding constraints for its partitioner. The
port has the rules and the pins they read
(``repro_torch.parallel.sharding``, set by the dry run), but its models
run on one device, so no block reads them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mlp as M
from repro_torch.models import ssm as S

KINDS = ("attn", "attn_local", "cross", "mamba", "mlstm", "slstm")


def _base(kind: str) -> str:
    """The sublayer kind without its ``_moe`` suffix; ``ValueError`` for an
    unknown one, as the reference raises."""
    base = kind.removesuffix("_moe")
    if base not in KINDS:
        raise ValueError(kind)
    return base


def _ffn_part_spec(cfg: ModelConfig, kind: str) -> dict:
    """FFN spec attached to a sublayer: dense, MoE, or none (d_ff == 0)."""
    if kind.endswith("_moe"):
        return {"moe": M.moe_spec(cfg)}
    if cfg.d_ff > 0:
        return {"ffn": M.ffn_spec(cfg)}
    return {}


def sublayer_spec(cfg: ModelConfig, kind: str, layer_in_group: int = 0) -> dict:
    base = _base(kind)
    d = cfg.d_model
    spec: dict = {"norm1": L.rmsnorm_spec(d)}
    if base in ("attn", "attn_local", "cross"):
        # cross K/V read the memory, pre-projected to d_model: same spec
        spec["attn"] = A.attn_spec(cfg)
    elif base == "mamba":
        spec["mamba"] = S.mamba_spec(cfg)
    elif base == "mlstm":
        spec["mlstm"] = S.mlstm_spec(cfg)
    else:
        spec["slstm"] = S.slstm_spec(cfg)
    if cfg.sandwich_norm:
        spec["norm1_post"] = L.rmsnorm_spec(d)

    ffn_spec = _ffn_part_spec(cfg, kind)
    if ffn_spec:
        spec["norm2"] = L.rmsnorm_spec(d)
        spec.update(ffn_spec)
        if cfg.sandwich_norm:
            spec["norm2_post"] = L.rmsnorm_spec(d)
    return spec


def sublayer_cache_shape(cfg: ModelConfig, kind: str, batch: int, cache_len: int):
    """Zero-initialized decode cache for one sublayer: {name: (shape,
    dtype)}. Attention keeps K and V of ``cache_len`` slots in the
    activations' dtype, cross-attention the memory's K and V of
    ``max(frontend_tokens, 1)`` slots; the recurrent states are f32 (but
    Mamba's conv window, in the activations' dtype) and do not grow with
    ``cache_len``."""
    base = _base(kind)
    kv, hd, h = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_heads
    di = cfg.ssm_expand * cfg.d_model
    f32 = torch.float32
    act = torch.bfloat16 if cfg.dtype == "bfloat16" else f32
    if base in ("attn", "attn_local"):
        return {"k": ((batch, cache_len, kv, hd), act),
                "v": ((batch, cache_len, kv, hd), act)}
    if base == "cross":
        t = max(cfg.frontend_tokens, 1)
        return {"mk": ((batch, t, kv, hd), act), "mv": ((batch, t, kv, hd), act)}
    if base == "mamba":
        return {"state": ((batch, di, cfg.ssm_state), f32),
                "conv": ((batch, cfg.ssm_conv - 1, di), act)}
    if base == "mlstm":
        return {"C": ((batch, h, hd, hd), f32), "n": ((batch, h, hd), f32)}
    return {"h": ((batch, h, hd), f32), "c": ((batch, h, hd), f32),
            "n": ((batch, h, hd), f32)}


def sublayer_apply(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                   ctx: dict, cache: dict | None):
    """Returns (x, new_cache, aux_loss). ctx keys: positions (B,S) or
    (B,1) absolute positions; mode ("train" | "prefill" | "decode");
    cache_pos (decode); causal (optional, default True); memory (B,T,D),
    the cross-attention memory (train and prefill)."""
    base = _base(kind)
    mode = ctx["mode"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: dict = {}

    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps)
    if base in ("attn", "attn_local"):
        window = cfg.sliding_window if base == "attn_local" else None
        if mode == "decode":
            out, kvc = A.self_attention(
                p["attn"], cfg, h, positions=ctx["positions"], window=window,
                cache=A.KvCache(cache["k"], cache["v"]), cache_pos=ctx["cache_pos"])
            new_cache = {"k": kvc.k, "v": kvc.v}
        else:
            out, kvc = A.self_attention(
                p["attn"], cfg, h, positions=ctx["positions"], window=window,
                causal=ctx.get("causal", True))
            if mode == "prefill":  # the prompt's K/V into slots [0, s)
                s = kvc.k.shape[1]
                new_cache = {
                    name: torch.cat([new.to(old.dtype), old[:, s:]], dim=1)
                    for name, new, old in (("k", kvc.k, cache["k"]),
                                           ("v", kvc.v, cache["v"]))}
    elif base == "cross":
        if mode == "decode":
            mem_kv = A.KvCache(cache["mk"], cache["mv"])
            new_cache = dict(cache)
        else:
            mem_kv = A.encode_memory(p["attn"], cfg, ctx["memory"])
            if mode == "prefill":
                new_cache = {"mk": mem_kv.k, "mv": mem_kv.v}
        out = A.cross_attention(p["attn"], cfg, h, mem_kv)
    elif base == "mamba":
        if mode == "decode":
            out, (st, cv) = S.mamba(p["mamba"], cfg, h, state=cache["state"],
                                    conv_state=cache["conv"])
        else:
            out, (st, cv) = S.mamba(p["mamba"], cfg, h)
        if mode != "train":
            new_cache = {"state": st, "conv": cv}
    elif base == "mlstm":
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
    x = x + out

    if kind.endswith("_moe") or "ffn" in p:
        h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps)
        if kind.endswith("_moe"):
            y, aux = M.moe_ffn(p["moe"], cfg, h2)
        else:
            y = M.ffn(p["ffn"], cfg, h2)
        if cfg.sandwich_norm:
            y = L.rmsnorm(p["norm2_post"], y, cfg.norm_eps)
        x = x + y
    return x, new_cache, aux


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
