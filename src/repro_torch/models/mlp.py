"""Dense FFN (SwiGLU / GeGLU / GELU) and the MoE FFN with capacity-based
dispatch; port of ``repro/models/mlp.py``. The products are
``torch.einsum`` in the activations' dtype, as the reference's einsums
are; the router runs in float32."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.spec import TensorSpec


# --- dense FFN --------------------------------------------------------------

def ffn_spec(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    spec = {
        "wi": TensorSpec((d, f), ("embed", "mlp")),
        "wo": TensorSpec((f, d), ("mlp", "embed")),
    }
    if cfg.activation in ("silu", "geglu"):  # gated (SwiGLU / GeGLU)
        spec["wg"] = TensorSpec((d, f), ("embed", "mlp"))
    return spec


def ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = torch.einsum("bsd,df->bsf", x, p["wi"].to(dt))
    if cfg.activation in ("silu", "geglu"):
        g = torch.einsum("bsd,df->bsf", x, p["wg"].to(dt))
        h = L.activate(g, "gelu" if cfg.activation == "geglu" else "silu") * h
    else:
        h = L.activate(h, "gelu")
    return torch.einsum("bsf,fd->bsd", h, p["wo"].to(dt))


# --- MoE FFN ----------------------------------------------------------------

def moe_spec(cfg: ModelConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    spec = {
        "router": TensorSpec((d, e), ("embed", None), scale=d ** -0.5),
        "wi": TensorSpec((e, d, f), ("experts", "embed", "mlp"), scale=d ** -0.5),
        "wg": TensorSpec((e, d, f), ("experts", "embed", "mlp"), scale=d ** -0.5),
        "wo": TensorSpec((e, f, d), ("experts", "mlp", "embed"), scale=f ** -0.5),
    }
    if cfg.n_shared_experts:
        spec["shared"] = ffn_spec(cfg, d_ff=cfg.expert_d_ff * cfg.n_shared_experts)
    return spec


def top_k_lower_first(x: torch.Tensor, k: int):
    """The ``k`` largest entries of the last axis, largest first and, on
    ties, the lower index first, as ``jax.lax.top_k`` orders them
    (``torch.topk`` may pick another of the tied indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """GShard-style grouped capacity dispatch: tokens in groups of
    ``moe_group_size``, capacity per (group, expert), a dense (G, Tg, E,
    C) dispatch. A token whose slot is past the capacity gets an all-zero
    capacity one-hot (as ``jax.nn.one_hot`` of an index out of range
    gives) and so no expert output. Returns (out, aux_loss)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    n_tok = b * s
    tg = min(cfg.moe_group_size, n_tok)
    assert n_tok % tg == 0, (n_tok, tg)
    g = n_tok // tg
    capacity = max(1, min(int(cfg.capacity_factor * tg * k / e), tg))
    dt, dev = x.dtype, x.device
    tokens = x.reshape(g, tg, d)

    logits = torch.einsum("gtd,de->gte", tokens.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = top_k_lower_first(probs, k)        # (G, Tg, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # Buffer slot of each (token, choice) within its (group, expert).
    onehot = (expert_idx[..., None] == torch.arange(e, device=dev)).to(torch.int32)
    flat = onehot.reshape(g, tg * k, e)
    pos = (torch.cumsum(flat, dim=1, dtype=torch.int32) - flat).reshape(g, tg, k, e)
    pos = torch.sum(pos * onehot, dim=-1, dtype=torch.int32)   # (G, Tg, k)
    keep = pos < capacity

    # dispatch one-hot (G, Tg, k, E, C) -> summed over k to (G, Tg, E, C)
    disp = onehot.to(dt) * keep[..., None].to(dt)
    slot = (pos[..., None] == torch.arange(capacity, device=dev)).to(dt)
    disp = disp[..., None] * slot[..., None, :]
    disp_te = disp.sum(2)                                      # (G, Tg, E, C)
    expert_in = torch.einsum("gtec,gtd->gecd", disp_te, tokens)  # (G, E, C, D)

    h = torch.einsum("gecd,edf->gecf", expert_in, p["wi"].to(dt))
    gt = torch.einsum("gecd,edf->gecf", expert_in, p["wg"].to(dt))
    h = L.activate(gt, "silu") * h
    expert_out = torch.einsum("gecf,efd->gecd", h, p["wo"].to(dt))

    combine = disp * gate_vals[..., None, None].to(dt)         # (G, Tg, k, E, C)
    out = torch.einsum("gtkec,gecd->gtd", combine, expert_out)

    if cfg.n_shared_experts:
        out = out + ffn(p["shared"], cfg, tokens)

    # Load-balancing aux loss (Switch-style), averaged over groups.
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = onehot.float().sum(2).mean(dim=(0, 1))                # routed fraction
    aux = e * torch.sum(me * ce)
    return out.reshape(b, s, d), aux
