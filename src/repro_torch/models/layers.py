"""Shared neural-net primitives: norms, RoPE, activations; port of
``repro/models/layers.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.spec import TensorSpec


def rmsnorm_spec(d: int) -> TensorSpec:
    return TensorSpec((d,), (None,), init="ones")


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None, None].float() * freq  # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def remat(fn, *args):
    """``fn(*args)``, recomputed in the backward when autograd records
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint``: only the arguments are kept. Nothing recomputed
    draws random numbers, so no RNG state is saved."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def activate(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "gelu":
        # jax.nn.gelu's default is the tanh approximation; torch's is not.
        return F.gelu(x, approximate="tanh")
    return F.silu(x)
