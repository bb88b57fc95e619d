"""``examples/distributed_halo_finding_torch.py`` on 8 CPU shards against
the reference's ``examples/distributed_halo_finding.py`` at the same
inputs.

The reference needs 8 devices, so it runs in a subprocess with
``--xla_force_host_platform_device_count=8`` (as
``tests/test_torch_distributed.py`` does) and hands its arrays back as an
``.npz``; the twin runs in this process meanwhile. Of the reference's
stages the subprocess runs the fused ``halo_pipeline_sharded``, whose
DBSCAN and catalog the example's staged ``dbscan_distributed`` and
``halo_catalog_sharded`` must give too (the reference's example asserts
the same); ``tests/test_torch_distributed.py`` and
``tests/test_torch_merge.py`` hold those stages against their own
reference runs. Labels, core mask, rounds, the overflow flag and the
catalog's integers must match exactly, its floats within 1e-5 (the
reference's own catalog tolerance), the SO masses exactly; the labels
also against the reference's numpy oracle.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import ref_numpy  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(TESTS), "examples"))

import distributed_halo_finding_torch as example  # noqa: E402

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core.distributed import slab_partition
    from repro.data.pipeline import hacc_benchmark_epsilon, make_clustered_points
    from repro.halos import halo_pipeline_sharded

    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    n = 1024
    pts = make_clustered_points(np.random.default_rng(1), n)
    eps = hacc_benchmark_epsilon(1.0, n)
    pts_sorted, _ = slab_partition(pts, 8)
    vel = np.random.default_rng(2).standard_normal((n, 3)).astype(np.float32)
    out = {"pts": pts_sorted, "vel": vel}

    def keep(key, res):
        for f in res._fields:
            v = getattr(res, f)
            if hasattr(v, "_fields"):
                keep(key + "/" + f, v)
            elif v is not None:
                out[key + "/" + f] = np.asarray(v)

    keep("pipe", halo_pipeline_sharded(
        jnp.asarray(pts_sorted), jnp.asarray(vel), eps, 2, mesh=mesh,
        capacity=128, halo_cap=1024, min_count=10, so_delta=200.0))
    np.savez(sys.argv[1], **out)
""")

CAT_INTS = ("num_halos", "overflow", "root", "count", "particle_halo")
CAT_FLOATS = ("mass", "center", "vmean", "vdisp", "rmax")


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The reference's arrays and the twin's run, made side by side."""
    path = str(tmp_path_factory.mktemp("dist_example") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(TESTS), "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", SCRIPT, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        got = example.run("cpu")
    finally:
        log = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, log
    return got, dict(np.load(path))


def _np(t):
    return t.cpu().numpy()


def test_inputs_are_the_references(both):
    got, ref = both
    np.testing.assert_array_equal(got.points, ref["pts"])
    np.testing.assert_array_equal(got.velocities, ref["vel"])


def test_distributed_dbscan_matches_reference_and_oracle(both):
    got, ref = both
    res = got.dbscan
    for f in ("labels", "core_mask", "rounds", "halo_overflow"):
        np.testing.assert_array_equal(_np(getattr(res, f)), ref[f"pipe/{f}"], f)
    pts, eps = got.points, example.make_points()[2]
    core = ref_numpy.core_mask_ref(pts, eps, 2)
    assert ref_numpy.labels_equivalent(_np(res.labels),
                                       ref_numpy.dbscan_ref(pts, eps, 2), core)
    # the twin's own check: the single-device fdbscan
    np.testing.assert_array_equal(_np(got.single.labels), ref["pipe/labels"])


@pytest.mark.parametrize("which", ["catalog", "pipeline"])
def test_catalog_matches_reference(both, which):
    got, ref = both
    cat = got.catalog if which == "catalog" else got.pipeline.catalog
    key = "pipe/catalog"
    for f in CAT_INTS:
        np.testing.assert_array_equal(_np(getattr(cat, f)), ref[f"{key}/{f}"], f)
    for f in CAT_FLOATS:
        np.testing.assert_allclose(_np(getattr(cat, f)), ref[f"{key}/{f}"],
                                   rtol=0, atol=1e-5, err_msg=f)
    for f in CAT_INTS:   # and the single-device catalog, as the twin checks
        np.testing.assert_array_equal(_np(getattr(got.single_catalog, f)),
                                      ref[f"{key}/{f}"], f)


def test_pipeline_labels_rounds_and_so_masses_match_reference(both):
    got, ref = both
    pipe = got.pipeline
    for f in ("labels", "core_mask", "rounds", "halo_overflow"):
        np.testing.assert_array_equal(_np(getattr(pipe, f)), ref[f"pipe/{f}"], f)
    for f in ("count", "bracketed", "r_delta", "m_delta"):
        np.testing.assert_array_equal(_np(getattr(pipe.so, f)),
                                      ref[f"pipe/so/{f}"], f)


def test_report_checks_and_prints_the_references_lines(both, capsys):
    example.report(both[0])
    out = capsys.readouterr().out
    assert "distributed FOF over 8 shards: rounds=3 halo_overflow=False" in out
    assert "merged catalog across 8 shards: 22 halos" in out
    assert "SO masses bracketed for 22" in out
