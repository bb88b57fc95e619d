"""The port's dense FFN and MoE FFN (``repro_torch.models.mlp``) against the
JAX reference's (``repro/models/mlp.py``) on the same weights and inputs.

Tolerances (float32): the two packages sum in different orders, so
values agree to a few float32 ulps of their magnitude; each test states
its bound. Where the MoE picks other experts (a tie broken the other
way) or drops other tokens, outputs differ by O(1), far past these."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import mlp as JM  # noqa: E402
from repro.models.spec import init_params as jax_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import mlp as M  # noqa: E402


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _cfgs(arch, **kw):
    return (get_config(arch).smoke().scaled(**kw),
            jax_get_config(arch).smoke().scaled(**kw))


def _params(spec_fn, jcfg, seed=0):
    jp = jax_init_params(spec_fn(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("arch,activation", [
    ("phi3-medium-14b", "silu"),        # SwiGLU
    ("gemma2-9b", "geglu"),             # GeGLU
    ("granite-20b", "gelu"),            # non-gated tanh-GELU
])
def test_ffn_matches_reference(arch, activation):
    """Output within rtol 1e-5, atol 1e-6; the gate exists exactly for
    the gated activations."""
    cfg, jcfg = _cfgs(arch)
    assert cfg.activation == activation
    jp, p = _params(JM.ffn_spec, jcfg)
    assert ("wg" in p) == (activation != "gelu")
    x = _x((2, 7, cfg.d_model))
    np.testing.assert_allclose(_np(M.ffn(p, cfg, torch.tensor(x))),
                               _np(JM.ffn(jp, jcfg, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-6)


def test_ffn_spec_takes_its_own_width():
    cfg, jcfg = _cfgs("deepseek-moe-16b")
    spec, jspec = M.ffn_spec(cfg, d_ff=96), JM.ffn_spec(jcfg, d_ff=96)
    assert {k: (v.shape, v.axes) for k, v in spec.items()} == \
        {k: (v.shape, v.axes) for k, v in jspec.items()}


def _moe_case(arch, seed=0, tokens=(2, 16), **kw):
    cfg, jcfg = _cfgs(arch, **kw)
    jp, p = _params(JM.moe_spec, jcfg, seed)
    x = _x(tokens + (cfg.d_model,), seed + 1)
    return cfg, jcfg, jp, p, x


def _moe_close(cfg, jcfg, jp, p, x):
    out, aux = M.moe_ffn(p, cfg, torch.tensor(x))
    jout, jaux = JM.moe_ffn(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(out), _np(jout), rtol=1e-5, atol=2e-6)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    return out, aux


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-moe-235b-a22b"])
def test_moe_matches_reference(arch):
    """deepseek: 8 experts top-2 with 2 shared; qwen3: none shared. No-drop
    capacity (the smoke configs'). Output within rtol 1e-5, atol 2e-6;
    the aux loss within 1e-6."""
    cfg, jcfg, jp, p, x = _moe_case(arch)
    assert ("shared" in p) == (cfg.n_shared_experts > 0)
    out, aux = _moe_close(cfg, jcfg, jp, p, x)
    assert out.shape == x.shape and aux.dtype == torch.float32


@pytest.mark.parametrize("group", [8, 32])
def test_moe_capacity_overflow_drops_the_reference_tokens(group):
    """capacity_factor 0.5: capacity int(0.5 * Tg * 2 / 8) slots per
    expert, so most tokens overflow some choice and get the all-zero
    capacity row; in groups of 8 (4 groups) and 32 (one)."""
    cfg, jcfg, jp, p, x = _moe_case("deepseek-moe-16b", seed=2,
                                    capacity_factor=0.5, moe_group_size=group,
                                    n_shared_experts=0)
    _moe_close(cfg, jcfg, jp, p, x)
    # the drop is real: with room for every token the output differs
    full, _ = M.moe_ffn(p, cfg.scaled(capacity_factor=8.0), torch.tensor(x))
    dropped, _ = M.moe_ffn(p, cfg, torch.tensor(x))
    rows_zero = (dropped.abs().sum(-1) == 0).sum()
    assert float((full - dropped).abs().max()) > 1e-2 and int(rows_zero) > 0


def test_top_k_takes_the_lower_index_on_ties():
    """On probabilities tied four ways, ``lax.top_k`` returns experts
    [1, 3, 5]; ``torch.topk`` need not (on the CPU it returns [3, 5,
    6]), the port's helper does."""
    probs = np.array([0, .25, 0, .25, 0, .25, .25, 0], np.float32)
    _, jidx = jax.lax.top_k(jnp.asarray(probs), 3)
    vals, idx = M.top_k_lower_first(torch.tensor(probs), 3)
    assert np.asarray(jidx).tolist() == idx.tolist() == [1, 3, 5]
    assert vals.tolist() == [0.25] * 3
    rng = np.random.default_rng(3)
    many = rng.integers(0, 4, (64, 16)).astype(np.float32)   # ties everywhere
    jv, ji = jax.lax.top_k(jnp.asarray(many), 6)
    tv, ti = M.top_k_lower_first(torch.tensor(many), 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
def test_moe_tied_router_probabilities_pick_the_reference_experts(capacity_factor):
    """Router columns 1, 3 and 5 equal and large, so every token's three
    largest probabilities tie and top-2 must take experts 1 and 3; at
    capacity_factor 1.0 the ties also decide which tokens overflow."""
    cfg, jcfg, jp, p, x = _moe_case("deepseek-moe-16b", seed=4,
                                    capacity_factor=capacity_factor)
    router = np.asarray(jp["router"]).copy()
    big = router[:, 1] * 8.0
    router[:, 1] = router[:, 3] = router[:, 5] = big
    x = np.abs(x) * np.sign(big)[None, None, :]     # every token's logit high
    jp = dict(jp, router=jnp.asarray(router))
    p = dict(p, router=torch.tensor(router))
    logits = torch.einsum("btd,de->bte", torch.tensor(x), p["router"])
    probs = torch.softmax(logits, -1)
    assert bool((probs[..., 1] == probs[..., 3]).all())
    assert bool((probs[..., 1] == probs.amax(-1)).all())
    _moe_close(cfg, jcfg, jp, p, x)
    _, idx = M.top_k_lower_first(probs, cfg.top_k)
    assert idx.reshape(-1, 2).tolist() == [[1, 3]] * idx.shape[0] * idx.shape[1]
    # which of the tied experts is taken matters: with experts 1 and 5
    # swapped (their router columns are equal) the output changes
    swap = dict(p, router=p["router"][:, [0, 5, 2, 3, 4, 1, 6, 7]])
    perm = dict(swap, wi=p["wi"][[0, 5, 2, 3, 4, 1, 6, 7]],
                wg=p["wg"][[0, 5, 2, 3, 4, 1, 6, 7]],
                wo=p["wo"][[0, 5, 2, 3, 4, 1, 6, 7]])
    a, _ = M.moe_ffn(p, cfg, torch.tensor(x))
    b, _ = M.moe_ffn(perm, cfg, torch.tensor(x))
    assert float((a - b).abs().max()) > 1e-3
