"""The port's self-attention (``repro_torch.models.attention``) against the
JAX reference's (``repro/models/attention.py``) on the same weights and
inputs: train, prefill and decode over GQA rep 1, 2 and 4 and MQA, with
QKV bias, QK-norm, a softcap and a sliding window; the blockwise path
with its chunks shrunk so that several chunks and a window's span run;
cross-attention to a memory's K and V.

Tolerances (float32): the packages sum in different orders (XLA's dots
against torch's), so outputs agree within rtol 1e-5 and atol 2e-6 of
values of order 1; gradients within rtol 1e-4 and atol 1e-6."""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models.spec import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

B, S, HEADS, HD = 2, 12, 8, 8
# the reference's attention, compiled once per shape (op by op it is slow)
JIT = SimpleNamespace(KvCache=JA.KvCache, self_attention=jax.jit(
    JA.self_attention, static_argnums=(1,), static_argnames=("window", "causal")))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(got, want, rtol=1e-5, atol=2e-6, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


def _layer(n_kv, features=True, seed=0):
    """(cfg, jax cfg, jax params, port params): 8 query heads of 8 over
    ``n_kv`` KV heads; with ``features``, QKV bias, QK-norm and a softcap
    (gemma2's 50), with bias and norm weights drawn away from 0 and 1."""
    kw = dict(d_model=32, n_heads=HEADS, n_kv_heads=n_kv, head_dim=HD,
              attn_bias=features, qk_norm=features,
              attn_softcap=50.0 if features else None, rope_theta=10000.0)
    cfg = get_config("gemma2-9b").smoke().scaled(**kw)
    jcfg = jax_get_config("gemma2-9b").smoke().scaled(**kw)
    jp = jax_init_params(JA.attn_spec(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed + 10)
    jp = {k: (jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * 0.5
                          + (1.0 if k.endswith("norm") else 0.0))
              if k.startswith("b") or k.endswith("norm") else v)
          for k, v in jp.items()}
    return cfg, jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(s=S, d=32, seed=1):
    return np.random.default_rng(seed).standard_normal((B, s, d)).astype(np.float32)


def _pos(s, offset=0):
    return np.broadcast_to(np.arange(offset, offset + s, dtype=np.int32)[None], (B, s))


REPS = [8, 4, 2, 1]            # rep 1, 2 and 4 of 8 query heads, and MQA
WINDOWS = [None, 5]


@pytest.mark.parametrize("n_kv", REPS)
@pytest.mark.parametrize("window", WINDOWS)
def test_self_attention_train_forward_and_gradients(n_kv, window):
    cfg, jcfg, jp, p = _layer(n_kv)
    x, pos = _x(), _pos(S)
    cot = np.random.default_rng(2).standard_normal((B, S, 32)).astype(np.float32)

    def jloss(q, xx):
        out, kv = JA.self_attention(q, jcfg, xx, positions=jnp.asarray(pos), window=window)
        return (out * cot).sum() + 0.1 * (kv.k.sum() + kv.v.sum()), (out, kv)

    (_, (jout, jkv)), (jg, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    names = sorted(p)
    ins = [p[k].clone().requires_grad_(True) for k in names]
    tx = torch.tensor(x, requires_grad=True)
    out, kv = A.self_attention(dict(zip(names, ins)), cfg, tx,
                               positions=torch.tensor(pos), window=window)
    close(out, jout, what="out")
    close(kv.k, jkv.k, what="k")
    close(kv.v, jkv.v, what="v")
    loss = (out * torch.tensor(cot)).sum() + 0.1 * (kv.k.sum() + kv.v.sum())
    grads = torch.autograd.grad(loss, ins + [tx])
    for name, g, w in zip(names + ["x"], grads, [jg[k] for k in names] + [jgx]):
        scale = max(float(np.abs(_np(w)).max()), 1.0)
        close(g, w, 1e-4, 1e-6 * scale, f"d{name}")


def _decode_run(mod, cfg, p, x, pos, window, s_cache, n_prompt, n_steps, to):
    """Prefill ``n_prompt`` tokens into slots [0, n_prompt) of an
    ``s_cache``-slot cache (as ``blocks.py`` writes it), then decode
    ``n_steps`` tokens one at a time from there; returns each step's
    output and cache."""
    out, kv = mod.self_attention(p, cfg, to(x[:, :n_prompt]),
                                 positions=to(pos[:, :n_prompt]), window=window)
    pad = np.zeros((B, s_cache - n_prompt) + tuple(kv.k.shape[2:]), np.float32)
    cache = mod.KvCache(to(np.concatenate([_np(kv.k), pad], 1)),
                        to(np.concatenate([_np(kv.v), pad], 1)))
    steps = [(out, cache)]
    for i in range(n_steps):
        t = n_prompt + i
        out, cache = mod.self_attention(
            p, cfg, to(x[:, t:t + 1]), positions=to(pos[:, t:t + 1]), window=window,
            cache=cache, cache_pos=to(np.int32(t)))
        steps.append((out, cache))
    return steps


@pytest.mark.parametrize("n_kv", REPS)
@pytest.mark.parametrize("window", WINDOWS)
def test_self_attention_prefill_then_decode_past_the_window_and_the_ring(n_kv, window):
    """A 6-token prompt into an 8-slot cache, then 7 decode steps: the
    positions run past the window of 5 and past the ring's 8 slots, where
    the slot wraps to ``cache_pos % 8`` and the reference tests ``live``
    on slot indices; each step's output and cache as the reference's."""
    cfg, jcfg, jp, p = _layer(n_kv, seed=n_kv)
    x, pos = _x(13), _pos(13)
    got = _decode_run(A, cfg, p, x, pos, window, 8, 6, 7, torch.tensor)
    want = _decode_run(JIT, jcfg, jp, x, pos, window, 8, 6, 7, jnp.asarray)
    for i, ((o, c), (jo, jc)) in enumerate(zip(got, want)):
        close(o, jo, what=f"step {i} out")
        close(c.k, jc.k, what=f"step {i} k")
        close(c.v, jc.v, what=f"step {i} v")


def test_decode_cache_pos_may_be_an_int_or_a_tensor():
    cfg, _, _, p = _layer(4, features=False)
    x, pos = _x(9), _pos(9)
    a = _decode_run(A, cfg, p, x, pos, None, 9, 8, 1, torch.tensor)[-1]
    cache = a[1]
    b = A.self_attention(p, cfg, torch.tensor(x[:, 8:9]), positions=torch.tensor(pos[:, 8:9]),
                         window=None, cache=cache, cache_pos=8)
    c = A.self_attention(p, cfg, torch.tensor(x[:, 8:9]), positions=torch.tensor(pos[:, 8:9]),
                         window=None, cache=cache, cache_pos=torch.tensor(8))
    assert torch.equal(b[0], c[0]) and torch.equal(b[1].k, c[1].k)


def test_gqa_pairs_query_head_j_with_kv_head_j_over_rep():
    k = torch.arange(2 * 3, dtype=torch.float32).reshape(1, 1, 3, 2)
    full = A._full_heads(k, 6)
    assert torch.equal(full, torch.repeat_interleave(k, 2, dim=2))
    assert not torch.equal(full, k.repeat(1, 1, 2, 1))
    assert A._full_heads(k, 3) is k


def _shrink_chunks(monkeypatch, q_chunk, kv_chunk, threshold=None):
    for mod in (A, JA):
        monkeypatch.setattr(mod, "Q_CHUNK", q_chunk)
        monkeypatch.setattr(mod, "KV_CHUNK", kv_chunk)
        if threshold is not None:
            monkeypatch.setattr(mod, "CHUNKED_THRESHOLD", threshold)


def _qkv(s, n_kv, seed=5, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, HEADS, HD)).astype(np.float32) * scale
    k = rng.standard_normal((B, s, n_kv, HD)).astype(np.float32) * scale
    v = rng.standard_normal((B, s, n_kv, HD)).astype(np.float32)
    return q, k, v


CHUNKED_CASES = [(None, True), (10, True), (17, True), (None, False)]


@pytest.mark.parametrize("window,causal", CHUNKED_CASES)
@pytest.mark.parametrize("n_kv", [8, 2])
def test_sdpa_chunked_matches_reference(monkeypatch, window, causal, n_kv):
    """Chunks of 8 queries and 8 keys over 32 tokens (the sizes equal, as
    the reference's scan needs, ROADMAP C14): 4 chunks each; a window of
    10 spans 3 KV chunks (10 // 8 + 2), one of 17 all 4. Scores scaled by
    3 and capped at 50, so the running max moves and the cap bites.
    Within rtol 1e-5, atol 1e-5 of the reference's blockwise path (the
    largest difference 3.5e-6)."""
    _shrink_chunks(monkeypatch, 8, 8)
    cfg, jcfg, _, _ = _layer(n_kv)
    q, k, v = _qkv(32, n_kv, scale=3.0)
    got = A._sdpa_chunked(cfg, *map(torch.tensor, (q, k, v)), window=window, causal=causal)
    want = JA._sdpa_chunked(jcfg, *map(jnp.asarray, (q, k, v)), window=window, causal=causal)
    close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("q_chunk,kv_chunk", [(4, 8), (8, 4), (4, 16)])
@pytest.mark.parametrize("window,causal", CHUNKED_CASES)
def test_sdpa_chunked_equals_full_attention_at_any_chunk_sizes(monkeypatch, q_chunk,
                                                              kv_chunk, window, causal):
    """Unequal chunks (the reference's own are 1024 and 4096): the port's
    blockwise path against the reference's full ``_sdpa`` with the same
    mask, within 1e-5 (another summation order)."""
    _shrink_chunks(monkeypatch, q_chunk, kv_chunk)
    cfg, jcfg, _, _ = _layer(2)
    q, k, v = _qkv(32, 2, scale=3.0)
    got = A._sdpa_chunked(cfg, *map(torch.tensor, (q, k, v)), window=window, causal=causal)
    mask = JA._causal_mask(32, window) if causal else None
    want = JA._sdpa(jcfg, *map(jnp.asarray, (q, k, v)), mask)
    close(got, want, 1e-5, 1e-5)


def test_reference_blockwise_path_misses_keys_at_unequal_chunks(monkeypatch):
    """ROADMAP C14, pinned: at 4 queries and 8 keys a chunk, the
    reference's blockwise path gives the full path's rows for the first
    16 queries only (query chunk ``qi`` reads KV chunk ``qi`` clipped to
    the last), while the port's agrees on every row."""
    _shrink_chunks(monkeypatch, 4, 8)
    cfg, jcfg, _, _ = _layer(8, features=False)
    q, k, v = _qkv(32, 8)
    full = np.asarray(JA._sdpa(jcfg, *map(jnp.asarray, (q, k, v)), JA._causal_mask(32, None)))
    ref = np.asarray(JA._sdpa_chunked(jcfg, *map(jnp.asarray, (q, k, v)), window=None,
                                      causal=True))
    port = _np(A._sdpa_chunked(cfg, *map(torch.tensor, (q, k, v)), window=None, causal=True))
    ref_rows = np.abs(ref - full).max(axis=(0, 2, 3)) < 1e-5
    assert ref_rows[:16].all() and not ref_rows[16:].any()
    assert (np.abs(port - full).max(axis=(0, 2, 3)) < 1e-5).all()


def test_chunked_self_attention_and_gradients_match_reference(monkeypatch):
    """``self_attention`` at the (lowered) chunked threshold, so both
    packages take the blockwise path with its recompute, at 8 queries and
    8 keys a chunk (sizes where the reference's path is right, C14): the
    output and the gradients of every weight and of the input as the
    reference's."""
    _shrink_chunks(monkeypatch, 8, 8, threshold=16)
    cfg, jcfg, jp, p = _layer(2)
    x, pos = _x(32), _pos(32)
    cot = np.random.default_rng(7).standard_normal((B, 32, 32)).astype(np.float32)

    def jloss(q, xx):
        out, _ = JA.self_attention(q, jcfg, xx, positions=jnp.asarray(pos), window=10)
        return (out * cot).sum(), out

    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    names = sorted(p)
    ins = [p[k].clone().requires_grad_(True) for k in names]
    tx = torch.tensor(x, requires_grad=True)
    out, _ = A.self_attention(dict(zip(names, ins)), cfg, tx,
                              positions=torch.tensor(pos), window=10)
    close(out, jout, what="out")
    grads = torch.autograd.grad((out * torch.tensor(cot)).sum(), ins + [tx])
    for name, g, w in zip(names + ["x"], grads, [jg[k] for k in names] + [jgx]):
        scale = max(float(np.abs(_np(w)).max()), 1.0)
        close(g, w, 1e-4, 1e-6 * scale, f"d{name}")


@pytest.mark.parametrize("n_kv", [8, 2])
@pytest.mark.parametrize("features", [False, True])
def test_cross_attention_and_encode_memory_match_reference(n_kv, features):
    """``encode_memory`` projects a memory of 7 positions (another length
    than the 12 queries) to K and V, with the KV bias and the K-norm when
    ``features`` is on; ``cross_attention`` attends to them unmasked with
    the Q-norm (no query bias, no RoPE), at GQA rep 1 and 4. Outputs
    within the module's tolerance, gradients of every weight, the queries
    and the memory within rtol 1e-4, atol 1e-6 of their largest entry."""
    cfg, jcfg, jp, p = _layer(n_kv, features, seed=3 + n_kv)
    x, mem = _x(), _x(7, seed=4)
    cot = np.random.default_rng(5).standard_normal((B, S, 32)).astype(np.float32)

    def jloss(q, xx, mm):
        kv = JA.encode_memory(q, jcfg, mm)
        out = JA.cross_attention(q, jcfg, xx, kv)
        return (out * cot).sum() + 0.1 * (kv.k.sum() + kv.v.sum()), (out, kv)

    (_, (jout, jkv)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(jp, jnp.asarray(x), jnp.asarray(mem))
    names = sorted(p)
    ins = [p[k].clone().requires_grad_(True) for k in names] + \
        [torch.tensor(x, requires_grad=True), torch.tensor(mem, requires_grad=True)]
    q = dict(zip(names, ins[:-2]))
    kv = A.encode_memory(q, cfg, ins[-1])
    out = A.cross_attention(q, cfg, ins[-2], kv)
    assert tuple(kv.k.shape) == (B, 7, n_kv, HD)
    close(out, jout, what="out")
    close(kv.k, jkv.k, what="k")
    close(kv.v, jkv.v, what="v")
    loss = (out * torch.tensor(cot)).sum() + 0.1 * (kv.k.sum() + kv.v.sum())
    want = [jg[0][k] for k in names] + [jg[1], jg[2]]
    grads = torch.autograd.grad(loss, ins, allow_unused=True)
    for name, g, w in zip(names + ["x", "memory"], grads, want):
        if name == "bq":      # cross-attention applies no query bias
            assert g is None and float(jnp.abs(w).max()) == 0
            continue
        scale = max(float(np.abs(_np(w)).max()), 1.0)
        close(g, w, 1e-4, 1e-6 * scale, f"d{name}")
