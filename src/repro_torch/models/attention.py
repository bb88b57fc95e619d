"""GQA/MQA/MHA self-attention with RoPE, sliding windows, softcapping,
QK-norm, cross-attention and the KV caches of prefill and decode; port of
``repro/models/attention.py``.

KV cache contract (decode): the cache holds ``S`` slots; the new token is
written at slot ``cache_pos % S`` and attends to every slot ``<=
cache_pos`` (and, in a window, ``> cache_pos - window``), the tests made on
slot indices as the reference makes them. Layout (B, S, n_kv, hd).

The matrix products are ``torch.einsum`` in the activations' dtype, as
the reference's einsums are; the scores are f32 from there on and the
probabilities are cast back before the value product. Sequences of
``CHUNKED_THRESHOLD`` tokens or more take the blockwise path
(``_sdpa_chunked``, an online softmax over (``Q_CHUNK``, ``KV_CHUNK``)
tiles), so the (S, S) scores never materialize; it visits its tiles by
position, where the reference's misses keys (ROADMAP C14).
Cross-attention reads K and V that ``encode_memory`` projects once from
the encoder's output or the frontend's embeddings, unmasked and without
RoPE, as the reference's does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.spec import TensorSpec

NEG_INF = -2.0 ** 30  # large-but-finite; keeps softmax NaN-free on full masks

CHUNKED_THRESHOLD = 8192
Q_CHUNK = 1024
KV_CHUNK = 4096


class KvCache(NamedTuple):
    k: torch.Tensor  # (B, S, n_kv, hd)
    v: torch.Tensor  # (B, S, n_kv, hd)


def attn_spec(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    spec = {
        "wq": TensorSpec((d, h, hd), ("embed", "heads", "qkv")),
        "wk": TensorSpec((d, kv, hd), ("embed", "kv", "qkv")),
        "wv": TensorSpec((d, kv, hd), ("embed", "kv", "qkv")),
        "wo": TensorSpec((h, hd, d), ("heads", "qkv", "embed")),
    }
    if cfg.attn_bias:
        spec["bq"] = TensorSpec((h, hd), ("heads", "qkv"), init="zeros")
        spec["bk"] = TensorSpec((kv, hd), ("kv", "qkv"), init="zeros")
        spec["bv"] = TensorSpec((kv, hd), ("kv", "qkv"), init="zeros")
    if cfg.qk_norm:
        spec["q_norm"] = L.rmsnorm_spec(hd)
        spec["k_norm"] = L.rmsnorm_spec(hd)
    return spec


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, kv_input: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", kv_input, p["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", kv_input, p["wv"].to(dt))
    if cfg.attn_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _full_heads(k: torch.Tensor, h: int) -> torch.Tensor:
    """GQA: KV heads broadcast to the ``h`` query heads, query head ``j``
    reading KV head ``j // rep`` (the reference's ``broadcast_to`` of a
    trailing rep axis, as ``repeat_interleave(rep, dim=2)`` gives)."""
    b, t, n_kv, hd = k.shape
    rep = h // n_kv
    if rep == 1:
        return k
    return k[:, :, :, None, :].expand(b, t, n_kv, rep, hd).reshape(b, t, h, hd)


def _sdpa(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KV, hd); mask: (B|1, S, T) bool or None."""
    h, hd = q.shape[2], q.shape[3]
    k, v = _full_heads(k, h), _full_heads(v, h)
    scores = torch.einsum("bshk,bthk->bhst", q, k).float()
    scores = scores * (hd ** -0.5)
    scores = L.softcap(scores, cfg.attn_softcap)
    if mask is not None:
        scores = torch.where(mask[:, None, :, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def _kv_chunks(qi: int, qc: int, kc: int, n_k: int, window: int | None,
               causal: bool) -> range:
    """The KV chunks that hold a live key for query chunk ``qi``: up to
    the chunk of its last query (causal) or the last one, from the chunk
    of its first query's earliest key in the window (or the first one)."""
    q_lo = qi * qc
    last = min((q_lo + qc - 1) // kc, n_k - 1) if causal else n_k - 1
    first = max(0, (q_lo - window + 1) // kc) if window is not None else 0
    return range(first, last + 1)


def _sdpa_chunked(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, *, window: int | None, causal: bool) -> torch.Tensor:
    """Blockwise attention with an online softmax (the reference's
    XLA-level flash attention): a loop over query chunks, each over the
    KV chunks that hold one of its live keys, masked with ``-inf``
    behind the reference's ``isfinite`` guards.

    The reference scans a span of ``window // KV_CHUNK + 2`` chunks (all
    of them for global attention) ending at chunk ``qi``, the query
    chunk's index, which is the chunk of its queries only when
    ``Q_CHUNK == KV_CHUNK``; at its own 1024 and 4096 it visits chunk
    ``qi`` clipped to the last one, so past the first 2 * 1024 queries it
    reads the last KV chunk several times and never the first (ROADMAP
    C14). The port visits the chunks by position, so it equals full
    attention at any chunk sizes; where the sizes are equal it visits the
    reference's live tiles in its order (a tile the reference visits
    with no live key adds exactly nothing to the carry: its ``p`` is 0
    and ``corr`` 1 on a finite running max, 0 on an empty carry). Each
    query chunk is recomputed in the backward, as the reference's
    ``jax.checkpoint(q_step)`` is."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    k, v = _full_heads(k, h), _full_heads(v, h)
    qc, kc = min(Q_CHUNK, s), min(KV_CHUNK, t)
    n_q, n_k = s // qc, t // kc
    assert s % qc == 0 and t % kc == 0, (s, t)
    scale = hd ** -0.5
    dev = q.device

    def q_step(q_chunk: torch.Tensor, qi: int) -> torch.Tensor:
        q_lo = qi * qc
        m_run = torch.full((b, h, qc), -torch.inf, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, h, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, qc, hd), dtype=torch.float32, device=dev)
        qpos = q_lo + torch.arange(qc, device=dev)[:, None]
        for kj in _kv_chunks(qi, qc, kc, n_k, window, causal):
            k_lo = kj * kc
            k_chunk, v_chunk = k[:, k_lo:k_lo + kc], v[:, k_lo:k_lo + kc]
            scores = torch.einsum("bshk,bthk->bhst", q_chunk, k_chunk).float() * scale
            scores = L.softcap(scores, cfg.attn_softcap)
            kpos = k_lo + torch.arange(kc, device=dev)[None, :]
            live = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                live &= kpos <= qpos
            if window is not None:
                live &= kpos > qpos - window
            scores = torch.where(live[None, None], scores, -torch.inf)
            m_new = torch.maximum(m_run, scores.amax(-1))
            # -inf guards: rows with no live key yet must contribute 0.
            safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(scores - safe_m[..., None])      # exp(-inf) = 0
            corr = torch.where(torch.isfinite(m_run), torch.exp(m_run - safe_m), 0.0)
            l_run = l_run * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhst,bthk->bhsk", p.to(q.dtype), v_chunk).float()
            m_run = m_new
        out = (acc / torch.clamp(l_run, min=1e-30)[..., None]).to(q.dtype)
        return out.transpose(1, 2)                          # (B, qc, H, hd)

    return torch.cat([L.remat(q_step, q[:, qi * qc:(qi + 1) * qc], qi)
                      for qi in range(n_q)], dim=1)


def _causal_mask(s: int, window: int | None, device=None) -> torch.Tensor:
    qpos = torch.arange(s, device=device)[:, None]
    kpos = torch.arange(s, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None]  # (1, S, S)


def self_attention(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                   positions: torch.Tensor, window: int | None,
                   cache: KvCache | None = None, cache_pos=None,
                   causal: bool = True):
    """Returns (out, new_cache). Modes:
      train/prefill: the full sequence, causal (or bidirectional); the
                     new cache is the sequence's (B, S, kv, hd) K and V.
      decode:        x is (B, 1, D); ``cache`` holds S slots and
                     ``cache_pos`` (a 0-d integer tensor or an int) is
                     the new token's absolute position.
    """
    q, k_new, v_new = _project_qkv(p, cfg, x, x)
    q = L.rope(q, positions, cfg.rope_theta)
    k_new = L.rope(k_new, positions, cfg.rope_theta)

    if cache is None:  # train / prefill
        s = x.shape[1]
        if s >= CHUNKED_THRESHOLD:
            out = _sdpa_chunked(cfg, q, k_new, v_new, window=window, causal=causal)
        else:
            mask = _causal_mask(s, window, device=x.device) if causal else None
            out = _sdpa(cfg, q, k_new, v_new, mask)
        new_cache = KvCache(k=k_new, v=v_new)
    else:  # decode: one new token at absolute position cache_pos
        s_cache = cache.k.shape[1]
        pos = torch.as_tensor(cache_pos, device=x.device).reshape(())
        slot = (pos % s_cache).reshape(1).long()
        k = cache.k.index_copy(1, slot, k_new)
        v = cache.v.index_copy(1, slot, v_new)
        kpos = torch.arange(s_cache, device=x.device)[None, :]
        live = kpos <= pos
        if window is not None:
            live &= kpos > pos - window
        out = _sdpa(cfg, q, k, v, live[:, None, :])
        new_cache = KvCache(k=k, v=v)

    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return out, new_cache


def cross_attention(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    memory_kv: KvCache) -> torch.Tensor:
    """Cross-attention to precomputed encoder/frontend K,V (no mask): the
    query gets no bias and no RoPE, only the QK-norm, as in the
    reference."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
    out = _sdpa(cfg, q, memory_kv.k, memory_kv.v, None)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def encode_memory(p: dict, cfg: ModelConfig, memory: torch.Tensor) -> KvCache:
    """Project encoder output / modality-frontend embeddings (B, T, D) to
    the cross-attention K,V (B, T, kv, hd), in the memory's dtype."""
    dt = memory.dtype
    k = torch.einsum("btd,dhk->bthk", memory, p["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", memory, p["wv"].to(dt))
    if cfg.attn_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return KvCache(k=k, v=v)
