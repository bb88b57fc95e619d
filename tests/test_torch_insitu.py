"""The in-situ analyzer against the JAX reference's ``InsituAnalyzer``: in
simulation mode particles in and halo statistics out; in training mode
embedding and router clustering from the reference's own draws. And the
port's guards: no JAX or ``repro`` imports, no silent CPU fallback, no
kernel launches on the CPU path."""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.analysis.insitu import InsituAnalyzer as JaxInsituAnalyzer  # noqa: E402
from repro.analysis.insitu import InsituConfig as JaxInsituConfig  # noqa: E402
from repro_torch.analysis.insitu import InsituAnalyzer, InsituConfig  # noqa: E402
from repro_torch.core.dbscan import fdbscan  # noqa: E402
from repro_torch.data.pipeline import make_clustered_points  # noqa: E402
from repro_torch.halos.catalog import halo_catalog  # noqa: E402
from repro_torch.kernels import segment as ks  # noqa: E402
from repro_torch.kernels import wavefront as kw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(mode="simulation", cadence=2, min_pts=3, halo_capacity=128,
           halo_min_count=10)
INT_STATS = ("insitu/halo_num", "insitu/halo_overflow", "insitu/halo_largest",
             "insitu/halo_union_rounds")


def _particles(n=2000, seed=4):
    rng = np.random.default_rng(seed)
    pts = make_clustered_points(rng, n, n_halos=12)
    vel = rng.standard_normal((n, 3)).astype(np.float32)
    return pts, vel


@pytest.mark.parametrize("step", [0, 2])
def test_insitu_simulation_matches_reference(step):
    pts, vel = _particles()
    # The default eps of a unit box at this n is too short to link anything
    # in a cloud this small; pass a linking length that finds halos.
    eps = 0.02
    want = JaxInsituAnalyzer(JaxInsituConfig(**CFG)).maybe_run(
        {"positions": jnp.asarray(pts), "velocities": jnp.asarray(vel),
         "eps": eps}, step)
    analyzer = InsituAnalyzer(InsituConfig(**CFG), device="cpu")
    got = analyzer.maybe_run({"positions": pts, "velocities": vel, "eps": eps},
                             step)
    assert got.keys() == want.keys()
    assert want["insitu/halo_num"] > 3
    for k in want:
        if k in INT_STATS:
            assert got[k] == want[k], k
        else:
            # Means and maxima of float32 sums taken in another order.
            assert got[k] == pytest.approx(want[k], rel=1e-5, abs=1e-7), k
    assert analyzer.history == [(step, got)]
    assert analyzer.maybe_run({"positions": pts, "velocities": vel}, step + 1) == {}


def test_insitu_default_eps_is_the_papers_linking_length():
    pts, vel = _particles(600, 5)
    want = JaxInsituAnalyzer(JaxInsituConfig(**CFG)).maybe_run(
        {"positions": jnp.asarray(pts), "velocities": jnp.asarray(vel)}, 0)
    got = InsituAnalyzer(InsituConfig(**CFG), device="cpu").maybe_run(
        {"positions": pts, "velocities": vel}, 0)
    for k in INT_STATS:
        assert got[k] == want[k], k


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("*.py")),
              *sorted((ROOT / "examples").glob("*_torch.py"))]
    assert len(files) > 10
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


@pytest.mark.parametrize("call", ["fdbscan", "halo_catalog", "analyzer"])
def test_entry_points_raise_without_a_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, vel = _particles(50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if call == "fdbscan":
            fdbscan(pts, 0.05, 2)
        elif call == "halo_catalog":
            halo_catalog(pts, vel, np.zeros(50, np.int32), capacity=4)
        else:
            InsituAnalyzer(InsituConfig(**CFG))


# --- training mode -----------------------------------------------------------

def _lm_params(arch, seed=0):
    """(reference params, port params carried across) at smoke size."""
    import jax
    from repro.configs import get_config
    from repro.models import lm as jlm
    from repro.models.spec import init_params
    from repro_torch.interop import params_from_numpy
    jp = init_params(jlm.model_spec(get_config(arch).smoke()),
                     jax.random.PRNGKey(seed), jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _reference_embedding_draws(table, cfg, step):
    """The reference's draws (``insitu.py:55-66``, ``:89-91``): sampled
    rows and the projection matrix."""
    import jax
    key = jax.random.PRNGKey(step)
    idx = jax.random.choice(key, table.shape[0],
                            (min(cfg.sample_rows, table.shape[0]),), replace=False)
    d = table.shape[1]
    r = jax.random.normal(jax.random.fold_in(key, 1), (d, cfg.project_dim),
                          jnp.float32) / np.sqrt(d)
    return np.asarray(table[idx]), np.asarray(r)


INT_EMBED = ("insitu/embed_num_clusters", "insitu/embed_largest_cluster",
             "insitu/embed_union_rounds", "insitu/embed_clustered_frac")


def _assert_embed_stats_equal(got, want):
    assert got.keys() == want.keys()
    for k in INT_EMBED:
        assert float(got[k]) == float(want[k]), k
    # eps: a linear quantile of float32 squared distances (the two
    # packages interpolate in other orders), within 2^-20 relative; no
    # pair lies within rounding of it here (where one did, its label
    # could differ, ROADMAP C8)
    assert float(got["insitu/embed_eps"]) == pytest.approx(
        float(want["insitu/embed_eps"]), rel=2.0 ** -20)


@pytest.mark.parametrize("step,rows", [(0, 128), (3, 128), (11, 64), (4, 512)])
def test_embedding_stats_from_reference_draws_match(step, rows):
    from repro.analysis.insitu import embedding_cluster_stats as jax_embed
    from repro_torch.analysis.insitu import embedding_stats_from
    jp, _ = _lm_params("xlstm-350m")
    cfg = InsituConfig(sample_rows=rows)
    want = jax_embed(jp, JaxInsituConfig(sample_rows=rows), step)
    sampled, r = _reference_embedding_draws(jp["embed"], cfg, step)
    got = embedding_stats_from(torch.tensor(sampled), torch.tensor(r), cfg)
    assert float(want["insitu/embed_clustered_frac"]) > 0
    _assert_embed_stats_equal(got, want)


def test_embedding_draws_are_seeded_from_the_step():
    from repro_torch.analysis.insitu import (embedding_cluster_stats,
                                             sample_embedding_draws)
    _, p = _lm_params("xlstm-350m")
    cfg = InsituConfig(sample_rows=100)
    rows, r = sample_embedding_draws(p["embed"], cfg, 5)
    rows2, r2 = sample_embedding_draws(p["embed"], cfg, 5)
    assert torch.equal(rows, rows2) and torch.equal(r, r2)
    assert rows.shape == (100, 64) and r.shape == (64, 3)
    # distinct rows (a draw without replacement)
    assert torch.unique(rows, dim=0).shape[0] == 100
    a = embedding_cluster_stats(p, cfg, 5, device="cpu")
    b = embedding_cluster_stats(p, cfg, 6, device="cpu")
    assert set(a) == set(b) and all(np.isfinite(float(v)) for v in a.values())
    assert float(a["insitu/embed_eps"]) != float(b["insitu/embed_eps"])


def test_detects_representation_collapse():
    """The reference test (``tests/test_insitu.py:31-44``): 80% of the rows
    collapsed onto row 0 raise the clustered fraction."""
    from repro_torch.analysis.insitu import embedding_cluster_stats
    _, p = _lm_params("xlstm-350m")
    cfg = InsituConfig(sample_rows=128, eps_quantile=0.005)
    base = embedding_cluster_stats(p, cfg, 1, device="cpu")
    emb = p["embed"]
    idx = torch.arange(emb.shape[0])
    collapsed = dict(p, embed=torch.where((idx % 5 > 0)[:, None], emb[0][None], emb))
    after = embedding_cluster_stats(collapsed, cfg, 1, device="cpu")
    assert float(after["insitu/embed_clustered_frac"]) > \
        float(base["insitu/embed_clustered_frac"])


@pytest.mark.parametrize("step", [0, 2])
def test_router_stats_on_deepseek_match_reference(step):
    import jax
    from repro.analysis.insitu import router_cluster_stats as jax_router
    from repro_torch.analysis.insitu import router_columns, router_stats_from
    jp, p = _lm_params("deepseek-moe-16b")
    want = jax_router(jp, JaxInsituConfig(), step)
    cols = router_columns(p)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    jcols = np.concatenate([np.asarray(w.mean(axis=0) if w.ndim == 3 else w).T
                            for path, w in flat
                            if "router" in jax.tree_util.keystr(path)])
    np.testing.assert_allclose(cols.numpy(), jcols, rtol=1e-6, atol=1e-7)
    r = jax.random.normal(jax.random.PRNGKey(step + 7), (cols.shape[1], 3),
                          jnp.float32) / np.sqrt(cols.shape[1])
    got = router_stats_from(cols, torch.tensor(np.asarray(r)))
    assert got.keys() == want.keys()
    assert float(got["insitu/router_collapsed_experts"]) == \
        float(want["insitu/router_collapsed_experts"])
    assert float(got["insitu/router_eps"]) == pytest.approx(
        float(want["insitu/router_eps"]), rel=2.0 ** -20)


def test_router_stats_empty_for_dense_arch():
    """granite-20b has no router (its smoke parameters from the
    reference, carried across)."""
    from repro.analysis.insitu import router_cluster_stats as jax_router
    from repro_torch.analysis.insitu import router_cluster_stats
    jp, p = _lm_params("granite-20b")
    assert jax_router(jp, JaxInsituConfig(), 0) == {}
    assert router_cluster_stats(p, InsituConfig(), 0, device="cpu") == {}


def test_training_analyzer_cadence():
    _, p = _lm_params("xlstm-350m")
    an = InsituAnalyzer(InsituConfig(cadence=5, sample_rows=64), device="cpu")
    ran = [step for step in range(11) if an.maybe_run(p, step)]
    assert ran == [0, 5, 10]
    assert [s for s, _ in an.history] == [0, 5, 10]
    assert set(an.history[0][1]) == {
        "insitu/embed_eps", "insitu/embed_clustered_frac",
        "insitu/embed_num_clusters", "insitu/embed_largest_cluster",
        "insitu/embed_union_rounds"}


def test_training_analyzer_spans_match_reference(tmp_path):
    from repro.obs.trace import SpanTracer as JaxTracer
    from repro.obs.trace import load_chrome_trace as jax_load
    from repro.obs.trace import span_tree as jax_span_tree
    from repro_torch.obs import SpanTracer, load_chrome_trace, span_tree

    jp, p = _lm_params("deepseek-moe-16b")
    jtracer, ttracer = JaxTracer(), SpanTracer()
    want = JaxInsituAnalyzer(JaxInsituConfig(sample_rows=64),
                             tracer=jtracer).maybe_run(jp, 0)
    got = InsituAnalyzer(InsituConfig(sample_rows=64), tracer=ttracer,
                         device="cpu").maybe_run(p, 0)
    assert got.keys() == want.keys()
    jev = jax_load(jtracer.export(str(tmp_path / "jax.json")))
    tev = load_chrome_trace(ttracer.export(str(tmp_path / "torch.json")))
    assert [(e["name"], e["args"]) for e in tev] == \
        [(e["name"], e["args"]) for e in jev]
    assert span_tree(tev) == jax_span_tree(jev) == {
        "insitu": ["insitu/embed_stats", "insitu/router_stats",
                   "insitu/host_readback"],
        "insitu/embed_stats": [], "insitu/router_stats": [],
        "insitu/host_readback": []}


def test_insitu_config_fields_match_reference():
    import dataclasses
    assert [f.name for f in dataclasses.fields(InsituConfig)] == \
        [f.name for f in dataclasses.fields(JaxInsituConfig)]
    assert dataclasses.asdict(InsituConfig()) == dataclasses.asdict(JaxInsituConfig())


def test_analyzer_tracer_spans_match_reference(tmp_path):
    """With a tracer, the step runs under the reference's spans (names,
    args, nesting) and gives the untraced step's stats."""
    from repro.obs.trace import SpanTracer as JaxTracer
    from repro.obs.trace import load_chrome_trace as jax_load
    from repro.obs.trace import span_tree as jax_span_tree
    from repro_torch.obs import SpanTracer, load_chrome_trace, span_tree

    pts, vel = _particles(400)
    params = {"positions": pts, "velocities": vel, "eps": 0.03}
    jtracer, ttracer = JaxTracer(), SpanTracer()
    want = JaxInsituAnalyzer(JaxInsituConfig(**CFG), tracer=jtracer).maybe_run(
        {k: jnp.asarray(v) for k, v in params.items()}, 0)
    plain = InsituAnalyzer(InsituConfig(**CFG), device="cpu").maybe_run(params, 0)
    got = InsituAnalyzer(InsituConfig(**CFG), tracer=ttracer,
                         device="cpu").maybe_run(params, 0)
    assert got == plain
    assert got.keys() == want.keys()
    jev = jax_load(jtracer.export(str(tmp_path / "jax.json")))
    tev = load_chrome_trace(ttracer.export(str(tmp_path / "torch.json")))
    assert [(e["name"], e["args"]) for e in tev] == \
        [(e["name"], e["args"]) for e in jev]
    assert span_tree(tev) == jax_span_tree(jev) == {
        "insitu": ["insitu/halo_stats", "insitu/host_readback"],
        "insitu/halo_stats": [], "insitu/host_readback": []}


def test_cpu_path_launches_no_kernel(monkeypatch):
    wrappers = (kw.wavefront_count, kw.wavefront_min_label,
                ks.segment_sum_sorted, ks.segment_max_sorted)
    for fn in wrappers:
        monkeypatch.setattr(fn, "launches", 0)
    pts, vel = _particles(400)
    InsituAnalyzer(InsituConfig(**CFG), device="cpu").maybe_run(
        {"positions": pts, "velocities": vel, "eps": 0.03}, 0)
    assert [fn.launches for fn in wrappers] == [0, 0, 0, 0]


@pytest.mark.parametrize("n,q", [(1, 0.3), (7, 0.0), (7, 1.0), (7, 0.5), (100, 0.01),
                                 (101, 0.05), (1000, 0.37)])
def test_quantile_is_the_references_linear_quantile(n, q):
    """``_quantile`` against ``jnp.quantile``'s default (linear) method
    on float32 values with repeats, within 2^-22 relative (the
    interpolation may round once more or less there); at the ends and
    at whole positions exact."""
    from repro_torch.analysis.insitu import _quantile
    x = np.round(np.random.default_rng(n).standard_normal(n), 2).astype(np.float32)
    want = float(jnp.quantile(jnp.asarray(x), q))
    got = float(_quantile(torch.tensor(x), q))
    assert got == pytest.approx(want, rel=2.0 ** -22, abs=0)
    if q in (0.0, 1.0) or n == 1:
        assert got == want


def test_quantile_of_a_nan_is_nan_as_the_reference():
    from repro_torch.analysis.insitu import _quantile
    x = np.array([0.5, np.nan, 0.25, 1.0], np.float32)
    assert np.isnan(float(jnp.quantile(jnp.asarray(x), 0.1)))
    assert np.isnan(float(_quantile(torch.tensor(x), 0.1)))


def test_eps_quantile_past_2_24_pairs_matches_reference():
    """ROADMAP C12: 5,800 sampled rows have 16,817,100 pairs, past the
    2^24 elements ``torch.quantile`` takes; the port's in-situ eps (the
    embedding analysis's 1% quantile) equals the reference's on the same
    seeded points within 2^-20 relative, as the tests above hold it."""
    from repro.analysis.insitu import _eps_from_quantile as jax_eps
    from repro_torch.analysis.insitu import _eps_from_quantile
    n = 5800
    assert n * (n - 1) // 2 > 2 ** 24
    pts = np.random.default_rng(12).random((n, 3)).astype(np.float32)
    want = float(jax_eps(jnp.asarray(pts), 0.01))
    got = float(_eps_from_quantile(torch.tensor(pts), 0.01))
    assert got == pytest.approx(want, rel=2.0 ** -20)
