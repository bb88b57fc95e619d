"""The port's most-bound centers (``repro_torch.halos.centers``) on the
CPU against the JAX reference, and the port's halo-products example
against the reference example's pipeline on the same particles.

Potentials: the port computes 1/sqrt as a correctly rounded square root
and reciprocal (the kernel's formula); XLA's ``rsqrt`` on the CPU lies
within 2 ulp of it (2^-22 relative). Both sum the terms in the same rope
order, over the bit-identical tree, so the sums differ by at most that
plus one rounding per hit: m · 2^-24 relative for m hits, below 2e-5 for
the m < 300 of these inputs. Hence ``rtol=2e-5``."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.dbscan import fdbscan as jax_fdbscan  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro.core.ref_numpy import halo_catalog_ref  # noqa: E402
from repro.halos import halo_catalog as jax_halo_catalog  # noqa: E402
from repro.halos import most_bound_centers as jax_most_bound_centers  # noqa: E402
from repro.halos import so_masses as jax_so_masses  # noqa: E402
from repro.halos.centers import halo_potentials as jax_halo_potentials  # noqa: E402
from repro_torch.core.bvh import build_bvh  # noqa: E402
from repro_torch.core.geometry import scene_bounds  # noqa: E402
from repro_torch.halos import MostBoundResult, most_bound_centers  # noqa: E402
from repro_torch.halos.centers import halo_potentials  # noqa: E402

RTOL = 2e-5
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def labelled():
    rng = np.random.default_rng(31)
    pts = make_clustered_points(rng, 1200, n_halos=5)
    vel = rng.standard_normal((len(pts), 3)).astype(np.float32)
    eps = 0.02
    labels = jax_fdbscan(jnp.asarray(pts), eps, 5).labels
    cat = jax_halo_catalog(jnp.asarray(pts), jnp.asarray(vel), labels,
                           capacity=16, min_count=5)
    return pts, np.array(cat.particle_halo), int(cat.num_halos), eps


@pytest.mark.parametrize("eps,softening", [(0.04, None), (0.08, None),
                                           (0.04, 0.01)])
@pytest.mark.parametrize("masked", [False, True])
def test_halo_potentials_match_reference(eps, softening, masked):
    rng = np.random.default_rng(int(eps * 100) + masked)
    pts = make_clustered_points(rng, 900)
    active = rng.random(len(pts)) < 0.6 if masked else None
    want = np.asarray(jax_halo_potentials(
        jnp.asarray(pts), eps, softening=softening,
        active=None if active is None else jnp.asarray(active)))
    got = halo_potentials(pts, eps, softening=softening, active=active,
                          device="cpu")
    assert got.dtype == torch.float32 and got.shape == (len(pts),)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    if masked:
        assert not bool(got[~torch.from_numpy(active)].any())
        assert bool((got[torch.from_numpy(active)] < 0).all())


def test_halo_potentials_reuse_a_tree():
    pts = make_clustered_points(np.random.default_rng(2), 700)
    t = torch.from_numpy(pts)
    bvh = build_bvh(t, *scene_bounds(t))
    torch.testing.assert_close(
        halo_potentials(pts, 0.05, bvh=bvh, device="cpu"),
        halo_potentials(pts, 0.05, device="cpu"), rtol=0, atol=0)


def _assert_most_bound_match(got, want, pts, ph, nh, phi):
    """Index equal where a halo's best potential beats its second best by
    more than the tolerance; elsewhere the port's choice attains the
    minimum within it. Centers are the chosen particles' positions."""
    assert isinstance(got, MostBoundResult)
    idx, w_idx = got.index.numpy(), np.asarray(want.index)
    np.testing.assert_allclose(got.potential.numpy(), np.asarray(want.potential),
                               rtol=RTOL, atol=0)
    for h in range(len(idx)):
        members = np.nonzero(ph == h)[0]
        if h >= nh:
            assert idx[h] == w_idx[h] == -1
            assert not got.center[h].any() and float(got.potential[h]) == 0
            continue
        assert ph[idx[h]] == h
        best = np.sort(phi[members])
        tol = RTOL * abs(best[0])
        if len(best) == 1 or best[1] - best[0] > 2 * tol:
            assert idx[h] == w_idx[h], h
        else:
            assert phi[idx[h]] <= best[0] + 2 * tol, h
        np.testing.assert_array_equal(got.center[h].numpy(), pts[idx[h]])


@pytest.mark.parametrize("factor", [1.0, 2.0])
def test_most_bound_centers_match_reference(labelled, factor):
    pts, ph, nh, eps = labelled
    want = jax_most_bound_centers(jnp.asarray(pts), jnp.asarray(ph),
                                  eps * factor, capacity=16)
    got = most_bound_centers(pts, ph, eps * factor, capacity=16, device="cpu")
    phi = np.asarray(jax_halo_potentials(jnp.asarray(pts), eps * factor,
                                         active=jnp.asarray(ph >= 0)))
    _assert_most_bound_match(got, want, pts, ph, nh, phi)


def test_most_bound_centers_32bit_build(labelled):
    """``use_64bit=False`` builds the tree over 30-bit codes, as the
    reference's does."""
    pts, ph, nh, eps = labelled
    want = jax_most_bound_centers(jnp.asarray(pts), jnp.asarray(ph), eps,
                                  capacity=16, use_64bit=False)
    got = most_bound_centers(pts, ph, eps, capacity=16, use_64bit=False,
                             device="cpu")
    phi = np.asarray(jax_halo_potentials(jnp.asarray(pts), eps,
                                         active=jnp.asarray(ph >= 0),
                                         use_64bit=False))
    _assert_most_bound_match(got, want, pts, ph, nh, phi)


def test_most_bound_ties_go_to_the_least_index():
    """Coincident particles share a potential exactly: the least original
    index of a halo's minimum wins, as in the reference."""
    rng = np.random.default_rng(5)
    base = rng.uniform(0.3, 0.7, (40, 3)).astype(np.float32)
    pts = np.repeat(base, 3, axis=0)[rng.permutation(120)]
    ph = np.where(np.arange(120) % 4 == 0, -1, np.arange(120) % 3).astype(np.int32)
    got = most_bound_centers(pts, ph, 0.2, capacity=4, device="cpu")
    want = jax_most_bound_centers(jnp.asarray(pts), jnp.asarray(ph), 0.2,
                                  capacity=4)
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    phi = halo_potentials(pts, 0.2, active=ph >= 0, device="cpu").numpy()
    for h in range(3):
        members = np.nonzero(ph == h)[0]
        best = members[phi[members] == phi[members].min()]
        assert int(got.index[h]) == best.min()
    assert int(got.index[3]) == -1


def _example():
    spec = importlib.util.spec_from_file_location(
        "halo_catalog_torch", ROOT / "examples" / "halo_catalog_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_halo_catalog_example_matches_reference_pipeline(capsys):
    """The port's example on the CPU: its catalog equals the numpy oracle
    and the reference's catalog, and its most-bound centers and SO masses
    equal the reference example's pipeline (``examples/halo_catalog.py``)
    on the same particles."""
    ex = _example()
    ex.main(["--device", "cpu"])
    assert "OK:" in capsys.readouterr().out
    pts, vel, _, _ = ex.make_particles()
    res, cat, mb, so = ex.run(pts, vel, "cpu")

    jres = jax_fdbscan(jnp.asarray(pts), ex.EPS, ex.MIN_PTS)
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(jres.labels))
    jcat = jax_halo_catalog(jnp.asarray(pts), jnp.asarray(vel), jres.labels,
                            capacity=ex.CAPACITY, min_count=ex.MIN_PTS,
                            backend="jax")
    ref = halo_catalog_ref(pts, vel, np.asarray(jres.labels), ex.CAPACITY,
                           ex.MIN_PTS)
    assert int(cat.num_halos) == ref["num_halos"] == int(jcat.num_halos)
    for f in ("root", "count", "particle_halo"):
        np.testing.assert_array_equal(getattr(cat, f).numpy(),
                                      np.asarray(getattr(jcat, f)), err_msg=f)
    np.testing.assert_array_equal(cat.count.numpy(), ref["count"])
    for f in ("center", "vmean", "vdisp", "rmax"):
        np.testing.assert_allclose(getattr(cat, f).numpy(), ref[f], atol=1e-5,
                                   err_msg=f)

    jp = jnp.asarray(pts)
    jb = jax_build_bvh(jp, *jax_scene_bounds(jp))
    jmb = jax_most_bound_centers(jp, jcat.particle_halo, ex.EPS * 2,
                                 capacity=ex.CAPACITY, bvh=jb)
    ph = cat.particle_halo.numpy()
    phi = np.asarray(jax_halo_potentials(jp, ex.EPS * 2,
                                         active=jnp.asarray(ph >= 0)))
    _assert_most_bound_match(mb, jmb, pts, ph, int(cat.num_halos), phi)
    jso = jax_so_masses(jp, jmb.center, jcat.count > 0, delta=200.0,
                        r_max=0.1, bvh=jb)
    for f in so._fields:
        np.testing.assert_array_equal(getattr(so, f).numpy(),
                                      np.asarray(getattr(jso, f)), err_msg=f)
