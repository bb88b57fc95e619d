"""The decoder LM (all ten architectures), its optional bidirectional
encoder (enc-dec) and modality frontend, and the train / prefill / decode
entry points; port of ``repro/models/lm.py``.

Parameters for the repeated block group are stacked on a leading
``n_groups`` axis, as in the reference; the reference's ``lax.scan``
over groups is a loop over that axis here. In training each group is
recomputed in the backward (``layers.remat``, as the reference's
``nothing_saveable`` remat), so only the groups' inputs are kept. The loss is chunked over the sequence (``LOSS_CHUNK``) and each
chunk is recomputed in the backward too (the reference's
``jax.checkpoint(chunk)``), so the (B, S, vocab) logits never
materialize, in training either. The cross-attention memory is the
encoder's output over the frames (seamless) or the projected patch
embeddings (llama-3.2-vision); train and prefill compute it, and decode
reads its K and V from the cache.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.spec import TensorSpec, stack_specs
from repro_torch.tree import tree_map

LOSS_CHUNK = 512


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------

def _dense_cfg(cfg: ModelConfig) -> ModelConfig:
    """deepseek's dense layer 0: one ``attn`` group with its own d_ff."""
    return cfg.scaled(block_pattern=("attn",), d_ff=cfg.first_layer_dense_ff,
                      n_experts=0)


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    """The encoder's layers: ``attn`` groups without experts."""
    return cfg.scaled(block_pattern=("attn",), n_experts=0)


def model_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    spec: dict = {
        # std 1/sqrt(d): tied logits land at O(1); gemma-style scale_embed
        # multiplies activations back up by sqrt(d).
        "embed": TensorSpec((cfg.padded_vocab, d), ("vocab", "embed"),
                            init="embed", scale=d ** -0.5),
        "layers": stack_specs(B.group_spec(cfg), cfg.n_groups),
        "final_norm": L.rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = TensorSpec((d, cfg.padded_vocab), ("embed", "vocab"))
    if cfg.first_layer_dense_ff:  # deepseek: dense layer 0
        spec["layer0"] = B.group_spec(_dense_cfg(cfg))
    if cfg.frontend_dim:
        spec["frontend_proj"] = TensorSpec((cfg.frontend_dim, d), (None, "embed"))
    if cfg.encoder_layers:
        spec["encoder"] = {
            "layers": stack_specs(B.group_spec(_encoder_cfg(cfg)), cfg.encoder_layers),
            "final_norm": L.rmsnorm_spec(d),
        }
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
    return torch.where(live, logits, A.NEG_INF)


def _head(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(h, _head(params, cfg).to(h.dtype)).float()
    return _mask_padded_vocab(cfg, L.softcap(logits, cfg.final_softcap))


def _group(tree, g: int):
    """Group ``g``'s slice of a tree stacked on the leading groups axis."""
    return tree_map(lambda x: x[g], tree)


def _frontend(params, cfg: ModelConfig, emb: torch.Tensor) -> torch.Tensor:
    """Frontend embeddings (B, T, frontend_dim) projected to d_model."""
    dt = _dtype(cfg)
    return torch.einsum("btf,fd->btd", emb.to(dt), params["frontend_proj"].to(dt))


def _run_encoder(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """Bidirectional encoder over frontend embeddings (B, T, frontend_dim):
    positions 0..T-1, no causal mask, each layer recomputed in the
    backward as the decoder's groups are."""
    enc_cfg = _encoder_cfg(cfg)
    h = _frontend(params, cfg, frames)
    b, t = h.shape[:2]
    pos = torch.arange(t, device=h.device)[None].expand(b, t)
    ctx = {"mode": "train", "positions": pos, "causal": False}
    enc = params["encoder"]
    for g in range(cfg.encoder_layers):
        h, _, _ = L.remat(B.group_apply, enc_cfg, _group(enc["layers"], g), h, ctx, None)
    return L.rmsnorm(enc["final_norm"], h, cfg.norm_eps)


def _memory(params, cfg: ModelConfig, batch: dict) -> torch.Tensor | None:
    """Cross-attention memory: the encoder's output (audio) or the
    projected patch embeddings (vlm); None without a frontend. The
    modality frontend itself is a stub: the batch carries its
    embeddings."""
    if cfg.encoder_layers:
        return _run_encoder(params, cfg, batch["frames"])
    if cfg.frontend_dim:
        return _frontend(params, cfg, batch["vision"])
    return None


def _context(params, cfg: ModelConfig, batch: dict, mode: str) -> dict:
    """The stack's context of a full sequence (train or prefill)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    ctx = {"mode": mode,
           "positions": torch.arange(s, device=tokens.device)[None].expand(b, s)}
    mem = _memory(params, cfg, batch)
    if mem is not None:
        ctx["memory"] = mem
    return ctx


def _run_stack(params, cfg: ModelConfig, h: torch.Tensor, ctx: dict, cache=None):
    """Layer 0 (deepseek's, not stacked), then the group stack; with
    ``cache`` (from ``init_cache`` or a previous step) it returns the new
    cache, laid out the same way. Under autograd each group is recomputed
    in the backward, as the reference's scan body is."""
    if "layer0" in params:
        c0 = cache["layer0"] if cache is not None else None
        h, c0_new, _ = B.group_apply(_dense_cfg(cfg), params["layer0"], h, ctx, c0)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    stacked = cache["layers"] if cache is not None else None
    new_groups = []
    for g in range(cfg.n_groups):
        c_g = _group(stacked, g) if stacked is not None else None
        h, new_c, aux_g = L.remat(B.group_apply, cfg, _group(params["layers"], g),
                                  h, ctx, c_g)
        aux = aux + aux_g
        new_groups.append(new_c)
    new_cache = None
    if stacked is not None:
        new_cache = {"layers": tree_map(lambda *xs: torch.stack(xs),
                                        *new_groups)}
        if "layer0" in params:
            new_cache["layer0"] = c0_new
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

    def chunk(hx, lx, mx):
        logits = torch.matmul(hx, w.to(hx.dtype)).float()
        logits = _mask_padded_vocab(cfg, L.softcap(logits, cfg.final_softcap))
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, lx.long()[..., None], dim=-1)[..., 0]
        return torch.sum((lse - gold) * mx)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(s // c):
        sl = slice(j * c, (j + 1) * c)
        total = total + L.remat(chunk, h[:, sl], labels[:, sl], mask[:, sl].float())
    return total / torch.clamp(mask.sum(), min=1.0)


def train_loss(params, cfg: ModelConfig, batch: dict):
    """batch: tokens (B,S) int, labels (B,S) int, loss_mask (B,S) bool,
    plus frames (B,T,F) for an encoder or vision (B,T,F) for a frontend.
    Returns (total, {"loss", "aux_loss", "tokens"})."""
    h = _embed(params, cfg, batch["tokens"])
    h, _, aux = _run_stack(params, cfg, h, _context(params, cfg, batch, "train"))
    loss = _chunked_xent(params, cfg, h, batch["labels"], batch["loss_mask"])
    total = loss + 0.01 * aux
    return total, {"loss": loss, "aux_loss": aux,
                   "tokens": batch["loss_mask"].sum()}


# ---------------------------------------------------------------------------
# Serve: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Zeroed decode cache on ``device`` (``None``: the card): the group
    stack's with a leading groups axis, and deepseek's layer 0's under
    ``"layer0"`` without one."""
    device = resolve_device(device)

    def zeros(shapes, lead=()):
        return {key: {name: torch.zeros(lead + shape, dtype=dtype, device=device)
                      for name, (shape, dtype) in sub.items()}
                for key, sub in shapes.items()}

    cache = {"layers": zeros(B.group_cache_shapes(cfg, batch, cache_len),
                             (cfg.n_groups,))}
    if cfg.first_layer_dense_ff:
        cache["layer0"] = zeros(B.group_cache_shapes(_dense_cfg(cfg), batch,
                                                     cache_len))
    return cache


def prefill(params, cfg: ModelConfig, batch: dict, cache_len: int | None = None):
    """Run the full prompt; returns (last-position logits, cache). The
    cache is allocated at ``cache_len`` (>= prompt length) so decode can
    append: attention writes the prompt's K/V into slots [0, s), the
    recurrent blocks keep only their final states, cross-attention the
    memory's K/V."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    h = _embed(params, cfg, tokens)
    cache0 = init_cache(cfg, b, cache_len or s, device=tokens.device)
    h, new_cache, _ = _run_stack(params, cfg, h, _context(params, cfg, batch, "prefill"),
                                 cache0)
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
