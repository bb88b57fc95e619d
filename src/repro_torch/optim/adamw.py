"""AdamW with cosine schedule, global-norm clipping, optional low-precision
moments and int8 gradient compression with error feedback; port of
``repro/optim/adamw.py``.

No ``torch.optim``: the update is the reference's arithmetic as written,
in float32 (the bias corrections ``1 - b1 ** step`` included), with the
decoupled decay on the parameter, leaf by leaf over the same trees.
Every function returns new tensors and changes none of its inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

F32 = torch.float32
# Entries of a leaf updated at once: a leaf of an MoE's experts holds 7e8
# of them, and the update's float32 temporaries of a whole one would not
# fit beside two copies of the state.
UPDATE_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "bfloat16"    # m/v dtype
    grad_dtype: str = "float32"       # accumulation dtype
    accum_steps: int = 1
    compress_grads: bool = False      # int8 + error feedback


class OptState(NamedTuple):
    step: torch.Tensor                # () int32
    m: Any
    v: Any
    error: Any | None = None          # compression error-feedback buffers


def _mdt(cfg: OptConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.moment_dtype == "bfloat16" else F32


def init_opt_state(cfg: OptConfig, params) -> OptState:
    def zeros(dtype):
        return lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    dev = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros(_mdt(cfg)), params),
                    v=tree_map(zeros(_mdt(cfg)), params),
                    error=tree_map(zeros(F32), params) if cfg.compress_grads else None)


def abstract_opt_state(cfg: OptConfig, abstract_params) -> OptState:
    """``init_opt_state`` of ``meta`` parameters: ``meta`` moments, no
    allocation at any size (dry run)."""
    return init_opt_state(cfg, abstract_params)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    stepf = step.to(F32)
    warm = torch.clamp(stepf / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((stepf - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(F32))) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, clip: float):
    norm = global_norm(grads)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), norm


# --- int8 gradient compression with error feedback --------------------------

def compress_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    gf = g.to(F32)
    amax = torch.max(torch.abs(gf))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def _pick(tree, i: int):
    """Element ``i`` of each tuple at the leaves of ``tree``."""
    return tree_map(lambda t: t[i], tree, is_leaf=lambda x: isinstance(x, tuple))


def compress_with_feedback(grads, error):
    """Quantize (grad + carried error); new error = residual. Returns the
    dequantized gradients (what the optimizer reads) and the new error."""
    def one(g, e):
        target = g.to(F32) + e
        deq = decompress_int8(*compress_int8(target))
        return deq.to(g.dtype), target - deq

    pairs = tree_map(one, grads, error)
    return _pick(pairs, 0), _pick(pairs, 1)


def apply_updates(cfg: OptConfig, params, grads, opt: OptState):
    """One AdamW step. Returns (new_params, new_opt, metrics)."""
    if cfg.compress_grads and opt.error is not None:
        grads, new_error = compress_with_feedback(grads, opt.error)
    else:
        new_error = opt.error

    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = opt.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(F32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=stepf.device), stepf)

    def upd(p, g, m, v):
        gf = g.to(F32)
        mf = b1 * m.to(F32) + (1 - b1) * gf
        vf = b2 * v.to(F32) + (1 - b2) * gf * gf
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(F32)
        new_p = (p.to(F32) - lr * delta).to(p.dtype)
        return new_p, mf.to(m.dtype), vf.to(v.dtype)

    def upd_sliced(p, g, m, v):
        """``upd`` over slices of at most ``UPDATE_SLICE`` entries of a
        large leaf, written into its new tensors: the same bits (every op
        is elementwise), with float32 temporaries of one slice."""
        if p.numel() <= UPDATE_SLICE:
            return upd(p, g, m, v)
        new = [torch.empty(p.shape, dtype=x.dtype, device=x.device) for x in (p, m, v)]
        flat = [x.reshape(-1) for x in (p, g, m, v)]
        for lo in range(0, p.numel(), UPDATE_SLICE):
            parts = upd(*(x[lo:lo + UPDATE_SLICE] for x in flat))
            for dst, part in zip(new, parts):
                dst.view(-1)[lo:lo + part.numel()] = part
        return tuple(new)

    out = tree_map(upd_sliced, params, grads, opt.m, opt.v)
    new_opt = OptState(step=step, m=_pick(out, 1), v=_pick(out, 2), error=new_error)
    return _pick(out, 0), new_opt, {"grad_norm": gnorm, "lr": lr}
