"""The decoder LM and its train / prefill / decode entry points; port of
``repro/models/lm.py`` for the architectures whose blocks are ported
(xlstm-350m: ``mlstm`` and ``slstm``).

Parameters for the repeated block group are stacked on a leading
``n_groups`` axis, as in the reference; the reference's ``lax.scan``
over groups is a loop over that axis here, with no remat (at xlstm-350m's
size the activations are small). Loss is chunked over the sequence
(``LOSS_CHUNK``) so (B, S, vocab) logits never materialize. An encoder,
a modality frontend or a dense layer 0 raises (ROADMAP A14 (b), (d)).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.spec import TensorSpec, stack_specs
from repro_torch.tree import tree_map

LOSS_CHUNK = 512
NEG_INF = -2.0 ** 30  # the reference's masked-logit value (models/attention.py:22)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------

def model_spec(cfg: ModelConfig) -> dict:
    if cfg.first_layer_dense_ff:
        raise B.unported("the dense layer 0")
    if cfg.frontend_dim:
        raise B.unported("the modality frontend")
    if cfg.encoder_layers:
        raise B.unported("the encoder")
    d = cfg.d_model
    spec: dict = {
        # std 1/sqrt(d): tied logits land at O(1)
        "embed": TensorSpec((cfg.padded_vocab, d), ("vocab", "embed"),
                            init="embed", scale=d ** -0.5),
        "layers": stack_specs(B.group_spec(cfg), cfg.n_groups),
        "final_norm": L.rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = TensorSpec((d, cfg.padded_vocab), ("embed", "vocab"))
    return spec


# ---------------------------------------------------------------------------
# Shared stack runner
# ---------------------------------------------------------------------------

def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not advanced indexing: its CUDA backward sums each
    # row's gradients in a fixed order (no float atomics), so a resumed
    # run repeats an uninterrupted one bit for bit.
    h = F.embedding(tokens.long(), params["embed"]).to(_dtype(cfg))
    if cfg.scale_embed:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype, device=h.device)
    return h


def _mask_padded_vocab(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab:
        return logits
    live = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    return torch.where(live, logits, NEG_INF)


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(h, _head(params, cfg).to(h.dtype)).float()
    return _mask_padded_vocab(cfg, L.softcap(logits, cfg.final_softcap))


def _group(tree, g: int):
    """Group ``g``'s slice of a tree stacked on the leading groups axis."""
    return tree_map(lambda x: x[g], tree)


def _run_stack(params, cfg: ModelConfig, h: torch.Tensor, ctx: dict, cache=None):
    """The group stack; with ``cache`` (group-stacked, from ``init_cache``
    or a previous step) it returns the new cache, stacked the same way."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    stacked = cache["layers"] if cache is not None else None
    new_groups = []
    for g in range(cfg.n_groups):
        c_g = _group(stacked, g) if stacked is not None else None
        h, new_c, aux_g = B.group_apply(cfg, _group(params["layers"], g), h,
                                        ctx, c_g)
        aux = aux + aux_g
        new_groups.append(new_c)
    new_cache = None
    if stacked is not None:
        new_cache = {"layers": tree_map(lambda *xs: torch.stack(xs),
                                        *new_groups)}
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps)
    return h, new_cache, aux


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------

def _chunked_xent(params, cfg: ModelConfig, h: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy without materializing full logits."""
    b, s, d = h.shape
    c = min(LOSS_CHUNK, s)
    assert s % c == 0
    w = _head(params, cfg)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(s // c):
        sl = slice(j * c, (j + 1) * c)
        hx, lx, mx = h[:, sl], labels[:, sl], mask[:, sl].float()
        logits = torch.matmul(hx, w.to(hx.dtype)).float()
        logits = _mask_padded_vocab(cfg, L.softcap(logits, cfg.final_softcap))
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, lx.long()[..., None], dim=-1)[..., 0]
        total = total + torch.sum((lse - gold) * mx)
    return total / torch.clamp(mask.sum(), min=1.0)


def train_loss(params, cfg: ModelConfig, batch: dict):
    """batch: tokens (B,S) int, labels (B,S) int, loss_mask (B,S) bool.
    Returns (total, {"loss", "aux_loss", "tokens"})."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed(params, cfg, tokens)
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    ctx = {"mode": "train", "positions": pos}
    h, _, aux = _run_stack(params, cfg, h, ctx)
    loss = _chunked_xent(params, cfg, h, batch["labels"], batch["loss_mask"])
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "tokens": batch["loss_mask"].sum()}


# ---------------------------------------------------------------------------
# Serve: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Zeroed decode cache (group-stacked) on ``device`` (``None``: the card)."""
    device = resolve_device(device)
    shapes = B.group_cache_shapes(cfg, batch, cache_len)
    return {"layers": {
        key: {name: torch.zeros((cfg.n_groups,) + shape, dtype=dtype, device=device)
              for name, (shape, dtype) in sub.items()}
        for key, sub in shapes.items()}}


def prefill(params, cfg: ModelConfig, batch: dict, cache_len: int | None = None):
    """Run the full prompt; returns (last-position logits, cache). The
    cache is allocated at ``cache_len`` (>= prompt length) so decode can
    append; the recurrent blocks keep only their final states."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed(params, cfg, tokens)
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    ctx = {"mode": "prefill", "positions": pos}
    cache0 = init_cache(cfg, b, cache_len or s, device=tokens.device)
    h, new_cache, _ = _run_stack(params, cfg, h, ctx, cache0)
    return _logits(params, cfg, h[:, -1:, :]), new_cache


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache,
                cache_pos):
    """One decode step. token (B, 1) int; cache from init_cache/prefill;
    cache_pos: absolute position (an int or a 0-d tensor). Returns
    (logits, new_cache)."""
    b = token.shape[0]
    h = _embed(params, cfg, token)
    pos = torch.as_tensor(cache_pos, device=token.device).to(torch.int32)
    ctx = {"mode": "decode", "positions": pos.reshape(1, 1).expand(b, 1),
           "cache_pos": pos}
    h, new_cache, _ = _run_stack(params, cfg, h, ctx, cache)
    return _logits(params, cfg, h), new_cache
