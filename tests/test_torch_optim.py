"""The port's AdamW (``repro_torch.optim.adamw``) against the JAX
reference's on the same numpy trees: schedule, global norm, clipping, int8
compression with error feedback, and whole update steps with float32 and
bfloat16 moments. Float32 values agree within 2 ulps of their magnitude
(rtol 2.4e-7 at most 2e-6 here); bf16 moments within one bf16 rounding."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as J  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


def _tree(rng, scale=1.0):
    return {"embed": (rng.standard_normal((16, 8)) * scale).astype(np.float32),
            "layers": {"a": (rng.standard_normal((2, 8, 4)) * scale).astype(np.float32),
                       "b": (rng.standard_normal(8) * scale).astype(np.float32)}}


def _close(got, want, rtol=2e-6, atol=1e-8):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000])
def test_schedule_matches_reference(step):
    cfg = A.OptConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    jcfg = J.OptConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    got = float(A.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
    want = float(J.schedule(jcfg, jnp.int32(step)))
    assert got == pytest.approx(want, rel=2e-6, abs=1e-12)


def test_config_fields_match_reference():
    assert dataclasses.asdict(A.OptConfig()) == dataclasses.asdict(J.OptConfig())
    assert A.OptState._fields == J.OptState._fields


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_global_norm_and_clipping_match_reference(clip):
    g = _tree(np.random.default_rng(0), 2.0)
    tg = params_from_numpy(g)
    assert float(A.global_norm(tg)) == pytest.approx(float(J.global_norm(g)), rel=2e-7)
    got, n = A.clip_by_global_norm(tg, clip)
    want, jn = J.clip_by_global_norm(jax.tree.map(jnp.asarray, g), clip)
    assert float(n) == pytest.approx(float(jn), rel=2e-7)
    _close(got, want)


def test_int8_compression_with_feedback_matches_reference():
    rng = np.random.default_rng(1)
    g, e = _tree(rng), _tree(rng, 0.01)
    q, s = A.compress_int8(torch.tensor(g["embed"]))
    jq, js = J.compress_int8(jnp.asarray(g["embed"]))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.dtype == torch.int8 and float(s) == float(js)
    np.testing.assert_array_equal(A.decompress_int8(q, s).numpy(),
                                  np.asarray(J.decompress_int8(jq, js)))
    deq, err = A.compress_with_feedback(params_from_numpy(g), params_from_numpy(e))
    jdeq, jerr = J.compress_with_feedback(jax.tree.map(jnp.asarray, g),
                                          jax.tree.map(jnp.asarray, e))
    _close(deq, jdeq, rtol=0, atol=0)
    _close(err, jerr, rtol=0, atol=0)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("compress", [False, True])
def test_apply_updates_matches_reference(moments, compress):
    """Five AdamW steps from the same start on the same gradients."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, moment_dtype=moments,
              compress_grads=compress)
    cfg, jcfg = A.OptConfig(**kw), J.OptConfig(**kw)
    rng = np.random.default_rng(2)
    p0 = _tree(rng)
    params, jparams = params_from_numpy(p0), jax.tree.map(jnp.asarray, p0)
    opt, jopt = A.init_opt_state(cfg, params), J.init_opt_state(jcfg, jparams)
    for _ in range(5):
        g = _tree(rng)
        params, opt, m = A.apply_updates(cfg, params, params_from_numpy(g), opt)
        jparams, jopt, jm = J.apply_updates(jcfg, jparams, jax.tree.map(jnp.asarray, g), jopt)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=2e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=2e-6)
    assert int(opt.step) == int(jopt.step) == 5 and opt.step.dtype == torch.int32
    assert (opt.error is None) == (not compress)
    bf = moments == "bfloat16"
    rtol = 2 ** -7 if bf else 2e-5
    _close(params, jparams, rtol=rtol, atol=1e-6)
    _close(opt.m, jopt.m, rtol=rtol, atol=1e-6)
    _close(opt.v, jopt.v, rtol=rtol, atol=1e-8)
    assert leaves(opt.m)[0].dtype == (torch.bfloat16 if bf else torch.float32)
    if compress:
        _close(opt.error, jopt.error, rtol=2e-5, atol=1e-6)


def test_apply_updates_keeps_bf16_params_and_changes_no_input():
    cfg = A.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    p = params_from_numpy(_tree(np.random.default_rng(3)), torch.bfloat16)
    g = params_from_numpy(_tree(np.random.default_rng(4)), torch.bfloat16)
    before = params_to_numpy(p)
    opt = A.init_opt_state(cfg, p)
    new, new_opt, _ = A.apply_updates(cfg, p, g, opt)
    assert all(x.dtype == torch.bfloat16 for x in leaves(new))
    for a, b in zip(leaves(params_to_numpy(p)), jax.tree.leaves(before)):
        np.testing.assert_array_equal(a, b)
    assert int(opt.step) == 0 and int(new_opt.step) == 1


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("slice_len", [7, 32])
def test_sliced_update_of_large_leaves_is_bit_equal(monkeypatch, moments, slice_len):
    """Leaves past ``UPDATE_SLICE`` entries are updated a slice at a
    time; with slices of 7 (ragged) or 32 entries every output equals the
    update of whole leaves bit for bit, and no input changes."""
    cfg = A.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10, moment_dtype=moments)
    p = params_from_numpy(_tree(np.random.default_rng(5)), torch.bfloat16)
    g = params_from_numpy(_tree(np.random.default_rng(6)), torch.bfloat16)
    opt = A.init_opt_state(cfg, p)
    p1, opt1, _ = A.apply_updates(cfg, p, g, opt)
    p2, opt2, _ = A.apply_updates(cfg, p1, g, opt1)
    monkeypatch.setattr(A, "UPDATE_SLICE", slice_len)
    before = [x.clone() for x in leaves((p1, g, opt1))]
    s2, sopt2, _ = A.apply_updates(cfg, p1, g, opt1)
    for a, b in zip(leaves((p2, opt2)), leaves((s2, sopt2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(before, leaves((p1, g, opt1))):
        assert torch.equal(a, b)
