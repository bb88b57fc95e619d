"""The example twins ``examples/galaxy_finding_torch.py`` and
``examples/quickstart_torch.py`` on the CPU, in-process, against the
reference's functions at the same inputs (what ``examples/galaxy_finding.py``
and ``examples/quickstart.py`` compute), and the labels against the
reference's numpy oracle.

The quickstart's grid section is left out here: on the CPU its plain
stencil tests every slot pair of 27 cells at the quickstart's capacity of
256 (minutes), and the reference's runs the Pallas kernels in interpret
mode (minutes too). ``chip_smoke.py`` phase 19 runs the twin's ``main``,
grid included, on the card, and ``tests/test_torch_fdbscan_grid.py`` holds
the grid against JAX.
"""
from __future__ import annotations

import importlib
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import ref_numpy  # noqa: E402
from repro.core.bvh import build_bvh as ref_build_bvh  # noqa: E402
from repro.core.dbscan import fdbscan as ref_fdbscan  # noqa: E402
from repro.core.geometry import scene_bounds as ref_scene_bounds  # noqa: E402
from repro.staticcheck import lint_source as ref_lint_source  # noqa: E402

# ``repro.core`` re-exports the function ``query`` over its module's name.
rq = importlib.import_module("repro.core.query")

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

import galaxy_finding_torch as galaxy  # noqa: E402
import quickstart_torch as quickstart  # noqa: E402


def _np(t):
    return t.cpu().numpy()


@pytest.fixture(scope="module")
def galaxies():
    return galaxy.run("cpu")


def test_galaxy_finding_labels_exact(galaxies):
    got = galaxies
    pts, eps = galaxy.make_points()
    # examples/galaxy_finding.py, step by step
    halos = ref_fdbscan(jnp.asarray(pts), eps * 1.5, 2)
    labels = np.asarray(halos.labels)
    ids, counts = np.unique(labels[labels >= 0], return_counts=True)
    members = np.nonzero(labels == ids[counts.argmax()])[0]
    gal = ref_fdbscan(jnp.asarray(pts[members]), eps, 10)

    np.testing.assert_array_equal(_np(got.halos.labels), labels)
    np.testing.assert_array_equal(_np(got.halos.core_mask),
                                  np.asarray(halos.core_mask))
    np.testing.assert_array_equal(_np(got.members), members)
    np.testing.assert_array_equal(_np(got.galaxies.labels),
                                  np.asarray(gal.labels))
    np.testing.assert_array_equal(_np(got.galaxies.core_mask),
                                  np.asarray(gal.core_mask))
    assert int(got.galaxies.num_rounds) == int(gal.num_rounds)
    # and the numpy oracle
    core = ref_numpy.core_mask_ref(pts[members], eps, 10)
    assert ref_numpy.labels_equivalent(_np(got.galaxies.labels),
                                       ref_numpy.dbscan_ref(pts[members], eps, 10),
                                       core)


def test_galaxy_finding_main_runs(galaxies, capsys):
    """``main`` prints ``report(run(device))``: the report of the run
    above, whose labels are the reference's."""
    galaxy.report(galaxies)
    out = capsys.readouterr().out
    assert "largest halo: 702 particles" in out and "galaxies found" in out


@pytest.fixture(scope="module")
def quick():
    return quickstart.run("cpu", grid_capacity=None)


@pytest.fixture(scope="module")
def ref_quick():
    """The reference quickstart's query sections at the same inputs. One
    reference call serves for both CSRs and the full counts: below its
    capacity the device CSR holds the host CSR's offsets and, in its
    leading ``total`` slots, its indices, and the offsets' differences
    are the counts."""
    pts, eps = quickstart.make_points()
    jp = jnp.asarray(pts)
    bvh = ref_build_bvh(jp, *ref_scene_bounds(jp))
    pred = rq.within(jp, eps)

    def cb(acc, q_idx, obj_idx, d2):
        return acc + obj_idx, jnp.bool_(False)

    counts_s, stats = rq.query_count(bvh, pred, stop_at=quickstart.MIN_PTS,
                                     with_stats=True)
    return {
        "fdbscan": ref_fdbscan(jp, eps, quickstart.MIN_PTS),
        "counts": rq.query_count(bvh, pred, stop_at=quickstart.MIN_PTS),
        "csr_device": rq.query_csr_device(bvh, pred, capacity=64 * quickstart.N),
        "index_sums": rq.query(bvh, pred, cb, jnp.int32(0), sort_queries=True),
        "knn": rq.query(bvh, rq.nearest(jp[:8], k=4)),
        "stats": stats,
    }


def test_quickstart_fdbscan_against_reference_and_oracle(quick, ref_quick):
    got, want = quick["fdbscan"], ref_quick["fdbscan"]
    np.testing.assert_array_equal(_np(got.labels), np.asarray(want.labels))
    np.testing.assert_array_equal(_np(got.core_mask), np.asarray(want.core_mask))
    assert int(got.num_rounds) == int(want.num_rounds)
    pts, eps = quick["points"], quick["eps"]
    core = ref_numpy.core_mask_ref(pts, eps, quickstart.MIN_PTS)
    oracle = ref_numpy.dbscan_ref(pts, eps, quickstart.MIN_PTS)
    assert ref_numpy.labels_equivalent(_np(got.labels), oracle, core)
    # the twin's local copy gives the oracle's verdicts
    assert quickstart.labels_equivalent(_np(got.labels), oracle, core)
    shuffled = np.where(oracle >= 0, (oracle * 7919) % 100003, oracle)
    assert quickstart.labels_equivalent(_np(got.labels), shuffled, core)
    broken = _np(got.labels).copy()
    broken[np.argmax(core)] = 10**6
    assert quickstart.labels_equivalent(broken, oracle, core) is \
        ref_numpy.labels_equivalent(broken, oracle, core) is False


def test_quickstart_query_api_against_reference(quick, ref_quick):
    np.testing.assert_array_equal(_np(quick["counts"]),
                                  np.asarray(ref_quick["counts"]))
    ref_csr = ref_quick["csr_device"]
    offsets = np.asarray(ref_csr.offsets)
    np.testing.assert_array_equal(_np(quick["counts_pallas"]), np.diff(offsets))
    np.testing.assert_array_equal(_np(quick["csr"].offsets), offsets)
    np.testing.assert_array_equal(_np(quick["csr"].indices),
                                  np.asarray(ref_csr.indices)[:offsets[-1]])
    assert int(quick["csr_device"].total) == int(ref_csr.total)
    assert not bool(quick["csr_device"].overflowed)
    np.testing.assert_array_equal(_np(quick["index_sums"]),
                                  np.asarray(ref_quick["index_sums"]))
    np.testing.assert_array_equal(_np(quick["knn"].indices),
                                  np.asarray(ref_quick["knn"].indices))
    np.testing.assert_allclose(_np(quick["knn"].distances),
                               np.asarray(ref_quick["knn"].distances),
                               rtol=1e-6, atol=1e-7)


def test_quickstart_observability_against_reference(quick, ref_quick):
    got, want = quick["stats"].totals(), ref_quick["stats"].totals()
    assert set(got) == set(want)
    for k in got:
        assert int(got[k]) == int(want[k]), k
    m = quick["metrics"]
    assert m["quickstart/csr/total"]["last"] == int(ref_quick["csr_device"].total)
    assert m["quickstart/query/nodes_visited"]["last"] == int(want["nodes_visited"])


@pytest.mark.parametrize("index_dtype", ["int32", "int64"])
def test_quickstart_scale_safety(quick, index_dtype):
    """The quickstart's scale-safety section: the int32 CSR offsets of its
    own call overflow at 64e9 hits (W1 at the scan), the int64 ones hold;
    the reference's section derives the same (run op by op, its int64 call
    under x64)."""
    import jax
    from repro.staticcheck import SymbolicScale, analyze, scale_for
    from repro.staticcheck.lattice import Ival

    got = quick["absint"][index_dtype]
    n = quickstart.N
    pts, eps = quickstart.make_points()
    jp = jnp.asarray(pts)
    bvh = ref_build_bvh(jp, *ref_scene_bounds(jp))
    counts = rq.query_count(bvh, rq.within(jp, eps), stop_at=quickstart.MIN_PTS)
    with jax.disable_jit(), jax.enable_x64(index_dtype == "int64"):
        want = analyze(
            lambda b, c: rq.query_csr_device(
                b, rq.within(jp, eps), capacity=64 * n, counts=c,
                index_dtype=jnp.dtype(index_dtype)),
            (bvh, counts), name=f"quickstart_csr_{index_dtype}",
            scale=SymbolicScale(dims=scale_for(n, 10**9,
                                               {64 * n: 64 * 10**9})),
            input_ivals=[None, Ival(0, 2048)])
    rules = ["W1-index-width"] if index_dtype == "int32" else []
    assert [f.rule for f in got.findings] == rules
    assert sorted({f.rule for f in want.findings}) == rules
    if rules:
        assert got.keys == [("W1-index-width", "cumsum",
                             "[0, 2048000000000]")]


def test_quickstart_static_checks(quick):
    assert quick["audit"] == []
    want = ref_lint_source("import jax.numpy as jnp\n"
                           "def fold(d, L):\n"
                           "    return d - jnp.round(d / L) * L\n", "snippet.py")
    assert [(f.rule, f.line) for f in quick["lint"]] == \
        [(f.rule, f.line) for f in want] == [("R4-unguarded-minimage-fold", 3)]
