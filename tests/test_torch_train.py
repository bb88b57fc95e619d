"""The port's training and serving path (data, steps, checkpoints, the
supervisor, the entry points) against the JAX reference, at smoke size on the
CPU: identical batches, loss that drops, exact resume after a crash,
gradient accumulation, checkpoints either package reads, and the
straggler watchdog's verdicts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.store import CheckpointStore as JaxStore  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticTokens as JaxTokens  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.spec import init_params as jax_init_params  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime.supervisor import StragglerWatchdog as JaxWatchdog  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.interop import params_from_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.spec import init_params  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime.supervisor import (StragglerWatchdog, Supervisor,  # noqa: E402
                                            SupervisorConfig)
from repro_torch.tree import keystr, leaves, leaves_with_path  # noqa: E402

ARCH = "xlstm-350m"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module, restored after it: its
    training loops run thousands of small ops, and with several test
    workers sharing the cores an op spread over every core mostly waits
    for the others (6 workers on 8 cores: 60 steps took 567 s, against
    13 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_config(ARCH).smoke()


def _init_state(cfg, opt_cfg, seed):
    params = init_params(lm.model_spec(cfg), seed, torch.float32, "cpu")
    return steps.TrainState(params, adamw.init_opt_state(opt_cfg, params))


@pytest.mark.parametrize("step", [0, 3, 1234])
def test_synthetic_batches_are_the_reference_batches(step):
    kw = dict(vocab=256, seq_len=24, global_batch=6, seed=7)
    got = SyntheticTokens(DataConfig(**kw), device="cpu").batch_at(step)
    want = JaxTokens(JaxDataConfig(**kw)).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["tokens"].dtype == torch.int32 and got["loss_mask"].dtype == torch.bool
    half = SyntheticTokens(DataConfig(**kw), device="cpu").batch_at(step, 1, 2)
    np.testing.assert_array_equal(half["tokens"].numpy(), np.asarray(want["tokens"])[3:])


@pytest.mark.parametrize("step", [0, 5])
def test_synthetic_frames_are_the_reference_frames(step):
    """With a frontend, the batches carry its stub's embeddings under both
    ``frames`` and ``vision``, bit-equal to the reference's, float32 from
    their own generator (seed, step, 77): the same for a host's rows."""
    kw = dict(vocab=256, seq_len=12, global_batch=4, seed=5, frontend_tokens=6,
              frontend_dim=10)
    got = SyntheticTokens(DataConfig(**kw), device="cpu").batch_at(step)
    want = JaxTokens(JaxDataConfig(**kw)).batch_at(step)
    assert got.keys() == want.keys() == {"tokens", "labels", "loss_mask", "frames",
                                         "vision"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["frames"].dtype == torch.float32 and got["vision"] is got["frames"]
    half = SyntheticTokens(DataConfig(**kw), device="cpu").batch_at(step, 1, 2)
    np.testing.assert_array_equal(half["frames"].numpy(),
                                  np.asarray(JaxTokens(JaxDataConfig(**kw)).batch_at(
                                      step, 1, 2)["frames"]))


def test_training_reduces_loss():
    """The reference test's run (``tests/test_e2e.py:22-39``) on the port."""
    cfg = _cfg()
    opt_cfg = adamw.OptConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                              moment_dtype="float32")
    state = _init_state(cfg, opt_cfg, 0)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32,
                                      global_batch=8, seed=1), device="cpu")
    losses = []
    for step in range(60):
        state, metrics = steps.train_step(state, data.batch_at(step), cfg=cfg,
                                          opt_cfg=opt_cfg)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2, \
        (np.mean(losses[:10]), np.mean(losses[-10:]))


def test_train_steps_match_reference():
    """Three steps from the reference's weights: loss, gradient norm and
    learning rate within rtol 1e-5 each step; parameters within 2e-5 of
    each other except where Adam's normalized step turns on a gradient
    within rounding of zero (at most 1e-3 of the entries, each off by at
    most two steps of lr)."""
    cfg, jcfg = _cfg(), jax_get_config(ARCH).smoke()
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=10, moment_dtype="float32")
    opt_cfg, jopt_cfg = adamw.OptConfig(**kw), jadamw.OptConfig(**kw)
    jp = jax_init_params(jlm.model_spec(jcfg), jax.random.PRNGKey(1), jnp.float32)
    jstate = jsteps.TrainState(jp, jadamw.init_opt_state(jopt_cfg, jp))
    params = params_from_numpy(jax.tree.map(np.asarray, jp))
    state = steps.TrainState(params, adamw.init_opt_state(opt_cfg, params))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4,
                                      seed=3), device="cpu")
    jdata = JaxTokens(JaxDataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4, seed=3))
    for step in range(3):
        state, m = steps.train_step(state, data.batch_at(step), cfg=cfg, opt_cfg=opt_cfg)
        jstate, jm = jsteps.train_step(jstate, jdata.batch_at(step), cfg=jcfg,
                                       opt_cfg=jopt_cfg)
        assert set(m) == set(jm)
        for k in ("loss", "total_loss", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), (step, k)
        assert int(m["tokens"]) == int(jm["tokens"])
    for a, b in zip(leaves(state.params), jax.tree.leaves(jstate.params)):
        diff = np.abs(a.numpy() - np.asarray(b))
        assert (diff > 2e-5).mean() <= 1e-3 and diff.max() <= 2 * 3e-3


def test_supervised_training_with_failure_and_restore(tmp_path):
    """Supervisor + checkpoints + a crash at step 17: the final state
    equals an uninterrupted run's exactly."""
    cfg = _cfg()
    opt_cfg = adamw.OptConfig(lr=1e-3, warmup_steps=2, total_steps=30,
                              moment_dtype="float32")
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=16,
                                      global_batch=4, seed=2), device="cpu")

    def step_fn(state, step):
        return steps.train_step(state, data.batch_at(step), cfg=cfg, opt_cfg=opt_cfg)

    ref = _init_state(cfg, opt_cfg, 3)
    for s in range(30):
        ref, _ = step_fn(ref, s)

    crashed = {"done": False}

    def fault(step):
        if step == 17 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("node died")

    sup = Supervisor(SupervisorConfig(total_steps=30, checkpoint_every=10,
                                      max_restarts=2), CheckpointStore(tmp_path))
    state = sup.run(init_state_fn=lambda: _init_state(cfg, opt_cfg, 3),
                    step_fn=step_fn, fault_hook=fault)
    assert sup.restarts == 1
    assert [s.step for s in sup.stats] == list(range(17)) + list(range(10, 30))
    assert CheckpointStore(tmp_path).steps() == [10, 20, 30]
    for a, b in zip(leaves(state), leaves(ref)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_grad_accum_matches_single_step():
    """train_step_accum over 2 micro-batches == train_step on the whole
    batch (the reference test's tolerance)."""
    cfg = _cfg()
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=10, moment_dtype="float32")
    opt1, opt2 = adamw.OptConfig(accum_steps=1, **kw), adamw.OptConfig(accum_steps=2, **kw)
    params = init_params(lm.model_spec(cfg), 1, torch.float32, "cpu")
    big = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4,
                                     seed=5), device="cpu").batch_at(0)
    s1, m1 = steps.train_step(steps.TrainState(params, adamw.init_opt_state(opt1, params)),
                              big, cfg=cfg, opt_cfg=opt1)
    micro = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in big.items()}
    s2, m2 = steps.train_step_accum(
        steps.TrainState(params, adamw.init_opt_state(opt2, params)), micro,
        cfg=cfg, opt_cfg=opt2)
    assert float(m2["total_loss"]) == pytest.approx(float(m1["total_loss"]), rel=1e-5)
    for a, b in zip(leaves(s1.params), leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=5e-3, rtol=1e-2)


def _jax_state(seed=0):
    jcfg = jax_get_config(ARCH).smoke()
    opt_cfg = jadamw.OptConfig(moment_dtype="float32", compress_grads=True)
    jp = jax_init_params(jlm.model_spec(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    jopt = jadamw.init_opt_state(opt_cfg, jp)
    g = jax.tree.map(lambda p: p * 0.01, jp)
    jp, jopt, _ = jadamw.apply_updates(opt_cfg, jp, g, jopt)
    return jsteps.TrainState(jp, jopt)


def _port_state(js):
    host = jax.tree.map(np.asarray, js)
    return train_state_from_numpy(host.params, host.opt.m, host.opt.v,
                                  host.opt.step, host.opt.error)


def _same(port_state, jax_state):
    jflat = jax.tree_util.tree_flatten_with_path(jax_state)[0]
    pflat = leaves_with_path(port_state)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [keystr(p) for p, _ in pflat]
    for (_, w), (_, g) in zip(jflat, pflat):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_checkpoints_cross_between_packages(tmp_path):
    """A checkpoint either store writes restores in the other, equal; the
    leaves carry the same path strings."""
    js = _jax_state()
    JaxStore(tmp_path / "jax").save(10, js)
    template = _port_state(_jax_state(1))
    got, step = CheckpointStore(tmp_path / "jax").restore(template)
    assert step == 10
    _same(got, js)

    CheckpointStore(tmp_path / "port").save(20, got)
    back, step = JaxStore(tmp_path / "port").restore(_jax_state(2))
    assert step == 20
    _same(got, back)


def test_bf16_checkpoints_cross_between_packages(tmp_path):
    """bf16 leaves: the reference's reach the port bit for bit, and the
    port's read back in the port, with a "bfloat16" manifest entry."""
    import json
    tree = {"w": jnp.asarray(np.random.default_rng(0).standard_normal((3, 5)),
                             jnp.bfloat16), "s": jnp.int32(4)}
    JaxStore(tmp_path / "jax").save(1, tree)
    template = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
                "s": torch.zeros((), dtype=torch.int32)}
    got, _ = CheckpointStore(tmp_path / "jax").restore(template)
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].float().numpy(),
                                  np.asarray(tree["w"], np.float32))
    store = CheckpointStore(tmp_path / "port")
    store.save_async(2, got)
    store.wait()
    again, _ = store.restore(template)
    assert torch.equal(again["w"], got["w"]) and int(again["s"]) == 4
    manifest = json.loads((tmp_path / "port" / "step_00000002" / "manifest.json").read_text())
    assert manifest["leaves"]["['w']"]["dtype"] == "bfloat16"


def test_torn_checkpoints_are_ignored(tmp_path):
    store = CheckpointStore(tmp_path)
    store.save(5, {"a": torch.ones(2)})
    (tmp_path / "step_00000009").mkdir()
    assert store.latest_step() == 5
    with pytest.raises(FileNotFoundError, match="torn"):
        store.restore({"a": torch.zeros(2)}, 9)
    for s in (6, 7, 8):
        store.save(s, {"a": torch.ones(2)})
    store.prune(keep=2)
    assert store.steps() == [7, 8]


def test_watchdog_flags_the_reference_steps():
    rng = np.random.default_rng(0)
    durations = rng.uniform(0.9, 1.1, 60)
    durations[[7, 20, 21, 45]] = [3.0, 2.7, 5.0, 2.6]
    ours, ref = StragglerWatchdog(2.5, 0.1), JaxWatchdog(2.5, 0.1)
    got = [ours.observe(i, float(d)) for i, d in enumerate(durations)]
    want = [ref.observe(i, float(d)) for i, d in enumerate(durations)]
    assert got == want and ours.flagged == ref.flagged == [7, 20, 21, 45]
    assert ours.ewma == ref.ewma


def test_serve_cli_generates_in_range_tokens(capsys):
    out = serve_cli.main(["--smoke", "--device", "cpu", "--requests", "3",
                          "--prompt-len", "12", "--gen-tokens", "5"])
    gen = out["tokens"]
    assert gen.shape == (3, 5) and (gen >= 0).all() and (gen < 256).all()
    assert out["prefill_ms"] > 0 and out["decode_ms_per_step"] > 0
    assert "prefill 3x12 tokens" in capsys.readouterr().out


def test_serve_steps_pick_the_first_maximum():
    cfg = _cfg()
    params = init_params(lm.model_spec(cfg), 0, device="cpu")
    tok = torch.tensor([[3], [4]], dtype=torch.int32)
    _, cache = steps.prefill_step(params, {"tokens": tok}, cfg=cfg, cache_len=3)
    nxt, logits, _ = steps.serve_step(params, cache, tok, 1, cfg=cfg)
    assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
    want = np.argmax(logits[:, -1].numpy(), axis=-1)
    np.testing.assert_array_equal(nxt[:, 0].numpy(), want)


def test_train_cli_runs_insitu_at_its_cadence(tmp_path, capsys):
    out = train_cli.main(["--smoke", "--device", "cpu", "--steps", "12",
                             "--batch", "4", "--seq", "16", "--ckpt-dir",
                             str(tmp_path), "--ckpt-every", "5",
                             "--insitu-every", "5", "--log-every", "4"])
    assert [s for s, _ in out["insitu"]] == [0, 5, 10]
    assert out["losses"][-1] < out["losses"][0]
    assert CheckpointStore(tmp_path).steps() == [5, 10, 12]
    assert "insitu/embed_clustered_frac" in capsys.readouterr().out


def test_train_cli_resumes_through_a_fault_bit_for_bit(tmp_path):
    """``main`` with the supervisor's fault hook: a failure at step 7
    resumes from the checkpoint at 5 and ends where the run without one
    does (atol 0), repeating the analysis at 5; the tracer holds the
    reference's training-mode spans."""
    from repro_torch.obs import SpanTracer

    def run(name, hook=None):
        tracer = SpanTracer()
        out = train_cli.main(["--smoke", "--device", "cpu", "--steps", "12",
                              "--batch", "4", "--seq", "16", "--ckpt-dir",
                              str(tmp_path / name), "--ckpt-every", "5",
                              "--insitu-every", "5"], fault_hook=hook,
                             tracer=tracer)
        return out, tracer

    crashed = []

    def fault(i):
        if i == 7 and not crashed:
            crashed.append(i)
            raise RuntimeError("injected fault")

    ref, _ = run("ref")
    got, tracer = run("fault", fault)
    assert crashed == [7] and got["supervisor"].restarts == 1
    assert [s for s, _ in got["insitu"]] == [0, 5, 5, 10]
    assert got["insitu"][1] == got["insitu"][2] == ref["insitu"][1]
    assert got["insitu"][3] == ref["insitu"][2]
    for a, b in zip(leaves(got["state"]), leaves(ref["state"])):
        assert torch.equal(a, b)
    names = {e["name"] for e in tracer.events}
    assert names == {"insitu", "insitu/embed_stats", "insitu/router_stats",
                     "insitu/host_readback"}
    assert [e["args"]["step"] for e in tracer.events if e["name"] == "insitu"] == [0, 5, 5, 10]


HYBRID_ARCHS = ["jamba-1.5-large-398b", "llama-3.2-vision-11b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", HYBRID_ARCHS)
def test_serve_cli_serves_hybrid_archs(arch, monkeypatch):
    """Mamba (jamba, with ``config=`` at 4 experts, which ``--smoke``
    keeps), the vision frontend (llama) and the encoder (seamless) serve
    at smoke size; the prefill gets the prompts and then the frontend's
    embeddings, drawn from one generator in the reference's order
    (``repro/launch/serve.py:45-53``)."""
    seen = []
    prefill = steps.prefill_step
    monkeypatch.setattr(steps, "prefill_step", lambda params, batch, **kw: (
        seen.append(batch), prefill(params, batch, **kw))[1])
    cfg = get_config(arch)
    config = cfg.scaled(n_experts=4) if cfg.n_experts else None
    out = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
                          "--prompt-len", "10", "--gen-tokens", "4", "--seed", "3"],
                         config=config)
    gen = out["tokens"]
    assert gen.shape == (2, 4) and (gen >= 0).all() and (gen < 256).all()
    cfg = (config or cfg).smoke()
    rng = np.random.default_rng(3)
    want = {"tokens": rng.integers(0, cfg.vocab, (2, 10))}
    emb = (2, cfg.frontend_tokens, cfg.frontend_dim)
    if cfg.frontend_dim and not cfg.encoder_layers:
        want["vision"] = rng.standard_normal(emb).astype(np.float32)
    if cfg.encoder_layers:
        want["frames"] = rng.standard_normal(emb).astype(np.float32)
    batch, = seen
    assert batch.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(batch[k].numpy(), v)
    if config is not None:
        assert cfg.n_experts == 4


def test_train_cli_trains_seamless_with_its_encoder(tmp_path):
    """seamless at smoke size (the encoder over ``SyntheticTokens``'
    frames, cross-attention in every other decoder layer): the loss falls
    (``main`` asserts it) and the analysis runs at its cadence."""
    out = train_cli.main(["--arch", "seamless-m4t-large-v2", "--smoke", "--device", "cpu",
                          "--steps", "8", "--batch", "4", "--seq", "16",
                          "--ckpt-dir", str(tmp_path), "--insitu-every", "4",
                          "--log-every", "1"])
    assert len(out["losses"]) == 8 and out["losses"][-1] < out["losses"][0]
    assert [s for s, _ in out["insitu"]] == [0, 4]
    assert "frontend_proj" in out["state"].params
    assert out["state"].params["encoder"]["layers"]["sub0_attn"]["attn"]["wq"].shape[0] == 2


def test_serve_cli_serves_given_weights():
    """``main(params=)`` serves those weights in place of the seeded ones,
    on the prompts and frames drawn from ``--seed``: the tokens of a
    prefill and greedy decode by hand on the same weights and draws."""
    cfg = get_config("seamless-m4t-large-v2").smoke()
    params = init_params(lm.model_spec(cfg), 7, torch.float32, "cpu")
    out = serve_cli.main(["--arch", "seamless-m4t-large-v2", "--smoke", "--device", "cpu",
                          "--requests", "2", "--prompt-len", "10", "--gen-tokens", "4",
                          "--seed", "3"], params=params)
    rng = np.random.default_rng(3)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (2, 10)), dtype=torch.int32)
    frames = torch.tensor(rng.standard_normal((2, cfg.frontend_tokens, cfg.frontend_dim)),
                          dtype=torch.float32)
    logits, cache = steps.prefill_step(params, {"tokens": prompt, "frames": frames},
                                       cfg=cfg, cache_len=14)
    want = [torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]]
    for i in range(3):
        tok, _, cache = steps.serve_step(params, cache, want[-1], 10 + i, cfg=cfg)
        want.append(tok)
    np.testing.assert_array_equal(out["tokens"], torch.cat(want, 1).numpy())


@pytest.mark.parametrize("arch", ["gemma2-9b", "deepseek-moe-16b"])
def test_serve_cli_serves_attention_archs(arch):
    """gemma2's prompt of 20 tokens passes its window (16 at smoke size);
    deepseek serves through its dense layer 0 and MoE groups."""
    out = serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                          "2", "--prompt-len", "20", "--gen-tokens", "4"])
    gen = out["tokens"]
    assert gen.shape == (2, 4) and (gen >= 0).all() and (gen < 256).all()


def test_train_cli_clusters_the_routers_of_a_real_moe(tmp_path, capsys):
    """deepseek at smoke size with 6 routed experts (through ``config=``,
    which ``--smoke`` then reduces): the loss falls and each analysis
    clusters the trained routers' 6 expert columns (the reference's
    router statistics)."""
    cfg = get_config("deepseek-moe-16b").scaled(n_experts=6)
    out = train_cli.main(["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
                          "--steps", "8", "--batch", "4", "--seq", "16",
                          "--ckpt-dir", str(tmp_path), "--insitu-every", "4",
                          "--log-every", "1"], config=cfg)
    assert out["losses"][-1] < out["losses"][0]
    layers = out["state"].params["layers"]
    assert layers["sub0_attn_moe"]["moe"]["router"].shape == (2, 64, 6)
    assert "layer0" in out["state"].params
    assert [s for s, _ in out["insitu"]] == [0, 4]
    for _, stats in out["insitu"]:
        assert {"insitu/router_eps", "insitu/router_collapsed_experts"} <= set(stats)
        assert 0 <= stats["insitu/router_collapsed_experts"] <= 6
    assert "insitu/router_eps" in capsys.readouterr().out


def test_example_trains_with_insitu_analysis():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "train_with_insitu_analysis_torch.py"
    spec = importlib.util.spec_from_file_location("train_insitu_example", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--steps", "26", "--device", "cpu"])
    assert [s for s, _ in out["insitu"]] == [0, 25]
    assert out["losses"][-1] < out["losses"][0]


def test_serve_batched_example_twin():
    """``examples/serve_batched_torch.py``, the twin of the reference's
    ``serve_batched.py``: gemma2-9b at smoke size, on the CPU."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, str(root / "examples" / "serve_batched_torch.py"),
                          "--device", "cpu"], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(root / "src")}, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "prefill 4x32 tokens" in run.stdout and "request 0: generated" in run.stdout


def test_a_train_step_frees_the_state_it_replaced():
    """With the garbage collector off, the state a step replaced is freed
    as soon as the caller drops it (reference counts alone): a leaf walk
    that kept its leaves in a reference cycle held every old state, 28.5
    GB at deepseek-moe-16b's 4 groups, until a collection. The first
    step is skipped: torch imports its compiler on its first recompute,
    and that import keeps the frames of the moment for a while."""
    import gc
    import weakref
    cfg = get_config("granite-20b").smoke()
    opt_cfg = adamw.OptConfig(moment_dtype="float32")
    state = _init_state(cfg, opt_cfg, 0)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=2,
                                      seed=0), device="cpu")
    state, _ = steps.train_step(state, data.batch_at(0), cfg=cfg, opt_cfg=opt_cfg)
    gc.collect()
    gc.disable()
    try:
        for i in (1, 2):
            refs = [weakref.ref(x) for x in leaves(state)]
            state, _ = steps.train_step(state, data.batch_at(i), cfg=cfg, opt_cfg=opt_cfg)
            assert all(r() is None for r in refs), i
    finally:
        gc.enable()
