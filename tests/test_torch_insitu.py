"""The whole ported slice, particles in and halo statistics out, against the
JAX reference's ``InsituAnalyzer`` in simulation mode; and the port's
guards: no JAX or ``repro`` imports, no silent CPU fallback, no kernel
launches on the CPU path."""
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
    files += [ROOT / "chip_smoke.py", *sorted((ROOT / "tools").glob("*.py"))]
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


def test_unported_analyzer_modes_raise():
    with pytest.raises(NotImplementedError, match="A14"):
        InsituAnalyzer(InsituConfig(mode="training"), device="cpu")


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
