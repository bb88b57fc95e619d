"""Step functions: train_step (forward, backward, AdamW) and the serve
steps (prefill, one decoded token); port of ``repro/launch/steps.py``.
Each is a plain function of its state: no tensor it is given changes."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch.tree import leaves, tree_map, unflatten_like


class TrainState(NamedTuple):
    params: Any
    opt: adamw.OptState


def value_and_grad(params, cfg: ModelConfig, batch: dict):
    """``lm.train_loss`` and its gradient with respect to every parameter
    (a tree like ``params``, each leaf in its parameter's dtype)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    total, metrics = lm.train_loss(live, cfg, batch)
    flat = leaves(live)
    grads = torch.autograd.grad(total, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return total.detach(), metrics, unflatten_like(params, grads)


def train_step(state: TrainState, batch: dict, *, cfg: ModelConfig,
               opt_cfg: adamw.OptConfig):
    """One optimizer step on one batch."""
    loss, metrics, grads = value_and_grad(state.params, cfg, batch)
    with torch.no_grad():
        new_params, new_opt, opt_metrics = adamw.apply_updates(
            opt_cfg, state.params, grads, state.opt)
    metrics = dict(metrics, **opt_metrics, total_loss=loss)
    return TrainState(new_params, new_opt), metrics


def train_step_accum(state: TrainState, batches: dict, *, cfg: ModelConfig,
                     opt_cfg: adamw.OptConfig):
    """Gradient accumulation over the leading micro-batch axis of every
    entry of ``batches``: the gradients summed in ``opt_cfg.grad_dtype``,
    then averaged, then one AdamW step."""
    gdt = torch.bfloat16 if opt_cfg.grad_dtype == "bfloat16" else torch.float32
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt, device=p.device),
                    state.params)
    lsum = torch.zeros((), dtype=torch.float32, device=leaves(gsum)[0].device)
    for i in range(opt_cfg.accum_steps):
        loss, _, g = value_and_grad(state.params, cfg,
                                    {k: v[i] for k, v in batches.items()})
        gsum = tree_map(lambda a, b: a + b.to(a.dtype), gsum, g)
        lsum = lsum + loss
    n = opt_cfg.accum_steps
    grads = tree_map(lambda g: (g / n).to(torch.float32), gsum)
    with torch.no_grad():
        new_params, new_opt, om = adamw.apply_updates(opt_cfg, state.params,
                                                      grads, state.opt)
    return TrainState(new_params, new_opt), dict(om, total_loss=lsum / n)


@torch.no_grad()
def prefill_step(params, batch: dict, *, cfg: ModelConfig, cache_len: int):
    return lm.prefill(params, cfg, batch, cache_len=cache_len)


@torch.no_grad()
def serve_step(params, cache, token: torch.Tensor, cache_pos, *, cfg: ModelConfig):
    """One new token against the recurrent state. The next token is the
    first maximum of the logits, as ``jnp.argmax`` picks it."""
    logits, new_cache = lm.decode_step(params, cfg, token, cache, cache_pos)
    next_token = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    return next_token, logits, new_cache
