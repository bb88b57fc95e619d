"""The port's Mamba block, its associative scan, the encoder and the
frontend memory, and the three architectures built on them (jamba-1.5-large,
llama-3.2-vision-11b, seamless-m4t-v2) against the JAX reference on the
same weights (carried across with ``params_from_numpy``) and the same numpy
inputs, at smoke size.

Tolerances (float32 unless stated): the packages sum in different orders
(XLA's dots against torch's), so block outputs agree within rtol 1e-5 and
atol 2e-6 of values of order 1; each test states its bound."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.spec import count_params as jax_count_params  # noqa: E402
from repro.models.spec import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.spec import count_params  # noqa: E402
from repro_torch.tree import keystr, leaves, leaves_with_path, unflatten_like  # noqa: E402
from test_torch_models import (BF16, _exact_jit, _f32, _jax_spec_table,  # noqa: E402
                               _port_spec_table, _rel, close)

JAMBA = "jamba-1.5-large-398b"
VISION = "llama-3.2-vision-11b"
SEAMLESS = "seamless-m4t-large-v2"
HYBRID_ARCHS = [JAMBA, VISION, SEAMLESS]
# the reference test's sizes (``tests/test_models.py:92-106``): llama and
# seamless without their stubbed vision tower and speech frontend
NOMINAL = {JAMBA: 398e9, VISION: 9.8e9, SEAMLESS: 1.7e9}


def _pair(cfg_fn, arch):
    return cfg_fn(get_config(arch)), cfg_fn(jax_get_config(arch))


# --- the associative scan -------------------------------------------------------

def _jax_combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, b1 * a2 + b2


@pytest.mark.parametrize("n", [1, 2, 7, 256])
def test_associative_scan_combines_in_the_reference_order(n):
    """A float sum is not associative, so equal bits say that the torch
    scan adds in ``jax.lax.associative_scan``'s order; the linear
    recurrence's combine (Mamba's) is bit-equal to the reference run op
    by op (decays in [0.9, 1), whose products stay normal: XLA flushes
    subnormals) and within 2 ulp-scale of it compiled (XLA may contract
    ``b1 * a2 + b2`` into an FMA) and of the sequential recurrence. The
    scan calls its combine 2 floor(log2 n) times, twice a level of its
    recursion (as the reference does, an empty call included), not once
    a token."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((5, n)).astype(np.float32)
    got, = S.associative_scan(lambda u, v: [u[0] + v[0]], [torch.tensor(x)], axis=1)
    want = jax.lax.associative_scan(jnp.add, jnp.asarray(x), axis=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    a = rng.uniform(0.9, 1.0, (2, n, 3, 4)).astype(np.float32)
    b = rng.standard_normal((2, n, 3, 4)).astype(np.float32)
    calls = []

    def counted(e1, e2):
        calls.append(e1[0].shape[1])
        return S._combine(e1, e2)

    ta, tb = S.associative_scan(counted, [torch.tensor(a), torch.tensor(b)], axis=1)
    ja, jb = jax.lax.associative_scan(_jax_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    _, jjb = jax.jit(lambda u, v: jax.lax.associative_scan(_jax_combine, (u, v), axis=1))(
        jnp.asarray(a), jnp.asarray(b))
    close(tb, jjb, 1e-6, 1e-6, "compiled reference")
    h, seq = np.zeros_like(b[:, 0]), []
    for t in range(n):
        h = a[:, t] * h + b[:, t]
        seq.append(h)
    close(tb, np.stack(seq, 1), 1e-5, 2e-6, "sequential recurrence")
    assert len(calls) == 2 * (n.bit_length() - 1), calls


# --- the Mamba block ----------------------------------------------------------------

def _mamba_params(seed=1):
    """(cfg, jax cfg, jax params, port params) of one Mamba block at
    jamba's smoke size (d_model 64, d_inner 128, state 8, conv 4, chunks
    of 8), with the zero-initialized biases, ``a_log`` and ``d_skip``
    drawn away from their inits."""
    cfg, jcfg = _pair(lambda c: c.smoke(), JAMBA)
    jp = jax_init_params(JS.mamba_spec(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed + 10)
    drawn = {"conv_b": 0.3, "dt_bias": 0.3, "a_log": 0.5, "d_skip": 0.5}
    jp = {k: (v + jnp.asarray(rng.standard_normal(v.shape).astype(np.float32) * drawn[k])
              if k in drawn else v) for k, v in jp.items()}
    return cfg, jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("s", [16, 20, 7, 2])
def test_mamba_full_sequence_matches_reference(s):
    """s = 16 runs two chunks of 8, s = 20 four of 5 and s = 7 one of 7
    (the largest divisor of s at most ssm_chunk = 8); s = 2 is shorter
    than the conv's window, so its conv state keeps a zero of the pad.
    Output, state and conv state within 1e-5, 2e-6; every weight's and
    the input's gradient within rtol 1e-4, atol 1e-6 of its largest entry
    (the port: at most 4.3e-7 of it)."""
    cfg, jcfg, jp, p = _mamba_params()
    h = np.random.default_rng(s).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    assert S._chunk_len(s, cfg.ssm_chunk) == JS._chunk_len(s, jcfg.ssm_chunk)
    cot = np.random.default_rng(9).standard_normal((2, s, cfg.d_model)).astype(np.float32)

    def jloss(q, x):
        out, (st, cv) = JS.mamba(q, jcfg, x)
        return (out * cot).sum() + 0.1 * st.sum() + 0.1 * cv.sum(), (out, st, cv)

    (_, (jout, jst, jcv)), jg = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(h))
    names = sorted(p)
    ins = [p[k].clone().requires_grad_(True) for k in names] + \
        [torch.tensor(h, requires_grad=True)]
    out, (st, cv) = S.mamba(dict(zip(names, ins[:-1])), cfg, ins[-1])
    close(out.detach(), jout, 1e-5, 2e-6, "out")
    close(st.detach(), jst, 1e-5, 2e-6, "state")
    close(cv.detach(), jcv, 1e-5, 2e-6, "conv state")
    assert st.dtype == torch.float32 and tuple(cv.shape) == (2, cfg.ssm_conv - 1, 2 * cfg.d_model)
    if s < cfg.ssm_conv - 1:
        assert bool((cv[:, 0] == 0).all())
    loss = (out * torch.tensor(cot)).sum() + 0.1 * st.sum() + 0.1 * cv.sum()
    for name, g, w in zip(names + ["h_in"], torch.autograd.grad(loss, ins),
                          [jg[0][k] for k in names] + [jg[1]]):
        scale = max(float(np.abs(np.asarray(w)).max()), 1e-3)
        close(g, w, 1e-4, 1e-6 * scale, f"d{name}")


def test_mamba_decode_matches_reference():
    """One decode step from a random state and conv window: output, state
    and conv window within 1e-5, 2e-6; and on the port, a prompt of 12
    then one decoded token gives the full forward's last output over the
    13 tokens, with its state and conv window (within 1e-5, 2e-6)."""
    cfg, jcfg, jp, p = _mamba_params(2)
    rng = np.random.default_rng(3)
    di = 2 * cfg.d_model
    h = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    st0 = rng.standard_normal((2, di, cfg.ssm_state)).astype(np.float32)
    cv0 = rng.standard_normal((2, cfg.ssm_conv - 1, di)).astype(np.float32)
    out, (st, cv) = S.mamba(p, cfg, torch.tensor(h), state=torch.tensor(st0),
                            conv_state=torch.tensor(cv0))
    jout, (jst, jcv) = JS.mamba(jp, jcfg, jnp.asarray(h), state=jnp.asarray(st0),
                                conv_state=jnp.asarray(cv0))
    for what, a, b in (("out", out, jout), ("state", st, jst), ("conv", cv, jcv)):
        close(a, b, 1e-5, 2e-6, what)

    seq = torch.tensor(rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32))
    full, (fst, fcv) = S.mamba(p, cfg, seq)
    _, (pst, pcv) = S.mamba(p, cfg, seq[:, :12])
    last, (dst, dcv) = S.mamba(p, cfg, seq[:, 12:], state=pst, conv_state=pcv)
    close(last, full[:, 12:], 1e-5, 2e-6, "decode != full forward")
    close(dst, fst, 1e-5, 2e-6, "state")
    close(dcv, fcv, 1e-5, 2e-6, "conv window")


def test_softplus_is_the_references():
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) and its gradient (the
    custom JVP's exp(x - out)) within 1 ulp-scale, past torch's softplus
    threshold of 20 too, where ``F.softplus`` returns x."""
    x = np.concatenate([np.linspace(-30, 30, 1201), [0.0, 1e-8, -1e-8]]).astype(np.float32)
    tx = torch.tensor(x, requires_grad=True)
    y = S._softplus(tx)
    g, = torch.autograd.grad(y.sum(), tx)
    jy, jg = jax.value_and_grad(lambda v: jax.nn.softplus(v).sum())(jnp.asarray(x))
    close(y.detach(), jax.nn.softplus(jnp.asarray(x)), 2e-7, 1e-7, "softplus")
    close(g, jg, 2e-7, 1e-7, "gradient")


def test_bf16_mamba_decode_rounds_where_the_reference_does(monkeypatch):
    """A bf16 decode step, the reference compiled without excess
    precision and with ``jax.nn.silu`` computing in f32 and rounding once
    as torch's kernel does (XLA's CPU backend otherwise rounds a bf16
    SiLU op by op, which moves about 8e-3 of the output's norm): output
    and conv window equal, the f32 state within 1e-6 norm-relative."""
    cfg = get_config("xlstm-350m").smoke().scaled(**BF16)
    jcfg = jax_get_config("xlstm-350m").smoke().scaled(**BF16)
    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16),
                      jax_init_params(JS.mamba_spec(jcfg), jax.random.PRNGKey(1), jnp.float32))
    p = params_from_numpy(jax.tree.map(_f32, jp), torch.bfloat16)
    rng = np.random.default_rng(4)
    di = 2 * cfg.d_model
    jh = jnp.asarray(rng.standard_normal((2, 1, cfg.d_model)), jnp.bfloat16)
    st0 = rng.standard_normal((2, di, cfg.ssm_state)).astype(np.float32)
    jcv = jnp.asarray(rng.standard_normal((2, cfg.ssm_conv - 1, di)), jnp.bfloat16)
    silu = jax.nn.silu
    monkeypatch.setattr(jax.nn, "silu", lambda x: silu(x.astype(jnp.float32)).astype(x.dtype))
    jout, (jst, jcv2) = _exact_jit(lambda q, x, s_, c_: JS.mamba(
        q, jcfg, x, state=s_, conv_state=c_), jp, jh, jnp.asarray(st0), jcv)
    out, (st, cv) = S.mamba(p, cfg, torch.tensor(_f32(jh)).to(torch.bfloat16),
                            state=torch.tensor(st0),
                            conv_state=torch.tensor(_f32(jcv)).to(torch.bfloat16))
    assert out.dtype == cv.dtype == torch.bfloat16 and st.dtype == torch.float32
    assert _rel(out, jout) == 0 and _rel(cv, jcv2) == 0
    assert _rel(st, jst) <= 1e-6, _rel(st, jst)


# --- the encoder and the frontend ---------------------------------------------------

@pytest.fixture(scope="module")
def arch_model():
    """(cfg, jax cfg, jax params, port params) of an arch at smoke size."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg = jax_get_config(arch).smoke()
            jp = jax_init_params(jlm.model_spec(jcfg), jax.random.PRNGKey(0), jnp.float32)
            made[arch] = (get_config(arch).smoke(), jcfg, jp,
                          params_from_numpy(jax.tree.map(np.asarray, jp)))
        return made[arch]

    return get


def _frames(cfg, b, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def test_run_encoder_matches_reference(arch_model):
    """seamless's bidirectional encoder (2 layers at smoke size) over 8
    frames: within 1e-5, 2e-6; and bidirectional: changing the last frame
    changes the first position's output."""
    cfg, jcfg, jp, p = arch_model(SEAMLESS)
    fr = _frames(cfg, 2)
    got = lm._run_encoder(p, cfg, torch.tensor(fr))
    close(got, jlm._run_encoder(jp, jcfg, jnp.asarray(fr)), 1e-5, 2e-6, "encoder")
    fr[:, -1] += 1.0
    moved = lm._run_encoder(p, cfg, torch.tensor(fr))
    assert float((moved[:, 0] - got[:, 0]).abs().max()) > 1e-3


def test_frontend_memory_matches_reference(arch_model):
    """llama-3.2-vision's memory, the projected patch embeddings, within
    1e-5, 2e-6; a model without a frontend has none."""
    cfg, jcfg, jp, p = arch_model(VISION)
    fr = _frames(cfg, 2)
    got = lm._memory(p, cfg, {"vision": torch.tensor(fr)})
    close(got, jlm._memory(jp, jcfg, {"vision": jnp.asarray(fr)}), 1e-5, 2e-6, "memory")
    assert lm._memory({}, get_config("gemma2-9b").smoke(), {}) is None


# --- the three architectures ------------------------------------------------------

def _batch(rng, cfg, b, s):
    """(jax batch, port batch): tokens, labels and a loss mask, and the
    frontend's embeddings under both ``frames`` and ``vision``, as
    ``SyntheticTokens`` gives them."""
    tok = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.9
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
          "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": torch.tensor(tok), "labels": torch.tensor(lab),
          "loss_mask": torch.tensor(mask)}
    if cfg.frontend_dim:
        fr = rng.standard_normal((b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        jb["frames"] = jb["vision"] = jnp.asarray(fr)
        tb["frames"] = tb["vision"] = torch.tensor(fr)
    return jb, tb


def _with_tokens(jb, tb, toks):
    """The batches' frontend embeddings with the tokens ``toks``."""
    keep = ("frames", "vision")
    return ({"tokens": jnp.asarray(toks), **{k: v for k, v in jb.items() if k in keep}},
            {"tokens": torch.tensor(toks), **{k: v for k, v in tb.items() if k in keep}})


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_hybrid_arch_spec_tree_and_size_match_reference(arch):
    """The spec tree (shapes, axes, inits, scales) at full size and at
    smoke size, and the full size within 5% of the published one (the
    reference test's bound and sizes)."""
    for smoke in (False, True):
        cfg, jcfg = _pair(lambda c: c.smoke() if smoke else c, arch)
        spec, jspec = lm.model_spec(cfg), jlm.model_spec(jcfg)
        assert _port_spec_table(spec) == _jax_spec_table(jspec)
        assert count_params(spec) == jax_count_params(jspec)
    n = count_params(lm.model_spec(get_config(arch)))
    assert abs(n - NOMINAL[arch]) / NOMINAL[arch] < 0.05
    assert ("encoder" in spec) == (arch == SEAMLESS)
    assert ("frontend_proj" in spec) == (arch != JAMBA)


# Gradient leaves within rtol 1e-4 and an atol of this fraction of the
# leaf's largest entry. Deep Mamba stacks amplify roundings: at jamba's
# smoke size the port is within 2.2e-5 of the reference, and on 8 Mamba
# layers each package's f32 gradients lie 1.2e-5 (JAX) and 1.3e-5 (the
# port) from the same model in float64. The others: the port within
# 3.0e-6 (llama) and 1.8e-6 (seamless).
GRAD_ATOL = {JAMBA: 4e-5, VISION: 1e-5, SEAMLESS: 1e-5}


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_hybrid_arch_train_loss_and_gradients_match_jax_grad(arch, arch_model):
    """f32, the frontend's embeddings from the same numpy draw: the loss
    and the aux loss (jamba's MoE) within rtol 1e-5, every gradient leaf
    within rtol 1e-4 and ``GRAD_ATOL`` of its largest entry."""
    cfg, jcfg, jp, p = arch_model(arch)
    jb, tb = _batch(np.random.default_rng(4), cfg, 2, 16)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda q, b: jlm.train_loss(q, jcfg, b), has_aux=True))(jp, jb)
    ins = [x.clone().requires_grad_(True) for x in leaves(p)]
    total, m = lm.train_loss(unflatten_like(p, ins), cfg, tb)
    grads = torch.autograd.grad(total, ins)
    close(total.detach(), jl, 1e-5, 0, "loss")
    close(m["aux_loss"].detach(), jm["aux_loss"], 1e-5, 1e-7, "aux loss")
    assert (float(m["aux_loss"].detach()) > 0) == cfg.is_moe
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert [jax.tree_util.keystr(q) for q, _ in jflat] == \
        [keystr(q) for q, _ in leaves_with_path(p)]
    for (q, w), g in zip(jflat, grads):
        scale = max(float(np.abs(np.asarray(w)).max()), 1e-3)
        close(g, w, 1e-4, GRAD_ATOL[arch] * scale, jax.tree_util.keystr(q))


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_hybrid_arch_prefill_and_decode_match_reference(arch, arch_model):
    """Prefill of 12 tokens (with the frontend's embeddings) into a
    14-slot cache, then two decode steps: logits within rtol 1e-5, atol
    2e-5, every cache leaf (KV slots, Mamba's state and conv window, the
    cross layers' memory K/V) within 1e-5, 1e-5. jamba's prompt runs two
    chunks of 6. The caches' atol is 5 times the other archs' (2e-6):
    each of jamba's layers, from the same input, is within 3.3e-6 of the
    reference's output (of up to 5 in size), so its fourth layer's conv
    window (the in_proj of the residual stream) differs by up to 4.3e-6."""
    cfg, jcfg, jp, p = arch_model(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 14)).astype(np.int32)
    jb, tb = _with_tokens(*_batch(rng, cfg, 2, 14), toks[:, :12])
    jprefill = jax.jit(lambda q, b: jlm.prefill(q, jcfg, b, cache_len=14))
    jdecode = jax.jit(lambda q, t, c, i: jlm.decode_step(q, jcfg, t, c, i))
    jlog, jcache = jprefill(jp, jb)
    log, cache = lm.prefill(p, cfg, tb, cache_len=14)
    close(log, jlog, 1e-5, 2e-5, "prefill logits")
    for i in range(2):
        jlog, jcache = jdecode(jp, jnp.asarray(toks[:, 12 + i:13 + i]), jcache,
                               jnp.int32(12 + i))
        log, cache = lm.decode_step(p, cfg, torch.tensor(toks[:, 12 + i:13 + i]), cache,
                                    12 + i)
        close(log, jlog, 1e-5, 2e-5, f"decode logits {i}")
    jc = jax.tree_util.tree_flatten_with_path(jcache)[0]
    assert [jax.tree_util.keystr(q) for q, _ in jc] == \
        [keystr(q) for q, _ in leaves_with_path(cache)]
    for (q, w), g in zip(jc, leaves(cache)):
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(q)
        close(g, w, 1e-5, 1e-5, jax.tree_util.keystr(q))
    kinds = {k.split("_", 1)[1] for k in cache["layers"]}
    assert kinds == set(cfg.block_pattern)


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_hybrid_arch_decode_matches_full_forward(arch, arch_model):
    """The reference test's check (``tests/test_models.py:73-89``) on the
    port, with its tolerance: 18 prompt tokens (jamba: chunks of 6) and
    two decoded against the full forward over 20 (chunks of 5)."""
    cfg, _, _, p = arch_model(arch)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    _, full_batch = _with_tokens(*_batch(rng, cfg, 2, 20), toks)
    logits_full, _ = lm.prefill(p, cfg, full_batch)
    prompt = dict(full_batch, tokens=full_batch["tokens"][:, :18])
    _, cache = lm.prefill(p, cfg, prompt, cache_len=20)
    t = full_batch["tokens"]
    lg, cache = lm.decode_step(p, cfg, t[:, 18:19], cache, 18)
    lg, cache = lm.decode_step(p, cfg, t[:, 19:20], cache, torch.tensor(19))
    close(lg, logits_full, 1e-3, 2e-3, "decode != full forward")
