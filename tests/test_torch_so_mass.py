"""The port's spherical-overdensity masses (``repro_torch.halos.so_mass``)
on the CPU against the JAX reference: range counts with a radius per
query, and the bisection on a halo catalog of clustered points, with
every output exact (the float32 bisection runs the reference's
operations in its order, so even R_Δ and M_Δ agree bit for bit)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.dbscan import fdbscan as jax_fdbscan  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro.core.query import query_count as jax_query_count  # noqa: E402
from repro.core.query import within as jax_within  # noqa: E402
from repro.halos.catalog import halo_catalog as jax_halo_catalog  # noqa: E402
from repro.halos.so_mass import so_masses as jax_so_masses  # noqa: E402
from repro_torch.core.bvh import build_bvh  # noqa: E402
from repro_torch.core.geometry import scene_bounds  # noqa: E402
from repro_torch.halos import SoMassResult, so_masses, so_masses_from_counts  # noqa: E402
from repro_torch.halos.so_mass import sphere_counts  # noqa: E402
from repro_torch.kernels import wavefront as kw  # noqa: E402


def _tree(pts):
    t = torch.from_numpy(pts)
    return build_bvh(t, *scene_bounds(t))


@pytest.fixture(scope="module")
def halos():
    """Clustered points, their catalog's centers of mass and valid slots
    (the reference's fdbscan and catalog, so both sides see one input)."""
    rng = np.random.default_rng(21)
    pts = make_clustered_points(rng, 1600, n_halos=5)
    vel = rng.standard_normal((len(pts), 3)).astype(np.float32)
    labels = jax_fdbscan(jnp.asarray(pts), 0.02, 5).labels
    cat = jax_halo_catalog(jnp.asarray(pts), jnp.asarray(vel), labels,
                           capacity=16, min_count=5)
    centers = np.array(cat.center)
    valid = np.array(cat.count) > 0
    assert 2 <= valid.sum() < 16
    return pts, centers, valid


def _assert_so_equal(got, want):
    assert isinstance(got, SoMassResult)
    for f in SoMassResult._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sphere_counts_match_reference(seed):
    rng = np.random.default_rng(seed)
    pts = make_clustered_points(rng, 500)
    centers = rng.uniform(-0.1, 1.1, (70, 3)).astype(np.float32)
    radii = rng.uniform(0, 0.4, 70).astype(np.float32)
    radii[::9] = 0.0
    jp = jnp.asarray(pts)
    jb = jax_build_bvh(jp, *jax_scene_bounds(jp))
    want = jax_query_count(jb, jax_within(jnp.asarray(centers),
                                          jnp.asarray(radii)))
    got = sphere_counts(_tree(pts), torch.from_numpy(pts),
                        torch.from_numpy(centers), torch.from_numpy(radii))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("delta,r_max", [(200.0, 0.1), (50.0, 0.3),
                                         (5000.0, 0.02)])
def test_so_masses_match_reference(halos, delta, r_max):
    pts, centers, valid = halos
    want = jax_so_masses(jnp.asarray(pts), jnp.asarray(centers),
                         jnp.asarray(valid), delta=delta, r_max=r_max)
    got = so_masses(pts, centers, valid, delta=delta, r_max=r_max,
                    device="cpu")
    _assert_so_equal(got, want)
    assert not bool(got.count[~torch.from_numpy(valid)].any())
    assert not bool(got.r_delta[~torch.from_numpy(valid)].any())


def test_so_masses_with_mass_volume_and_iterations(halos):
    pts, centers, valid = halos
    kw_args = dict(delta=180.0, particle_mass=0.25, box_volume=2.0,
                   r_max=0.15, iters=12)
    want = jax_so_masses(jnp.asarray(pts), jnp.asarray(centers),
                         jnp.asarray(valid), **kw_args)
    _assert_so_equal(so_masses(pts, centers, valid, device="cpu", **kw_args),
                     want)


def test_so_masses_reuse_a_tree(halos, monkeypatch):
    """With ``bvh=`` no tree is built, and the result is the same."""
    pts, centers, valid = halos
    bvh = _tree(pts)
    want = so_masses(pts, centers, valid, r_max=0.1, device="cpu")
    from repro_torch.halos import so_mass

    def no_build(*_a, **_k):
        raise AssertionError("so_masses built a tree although one was given")

    monkeypatch.setattr(so_mass, "build_bvh", no_build)
    got = so_masses(pts, centers, valid, r_max=0.1, bvh=bvh, device="cpu")
    for f in SoMassResult._fields:
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=0)


def test_so_masses_from_counts_with_callers_counts(halos):
    """The bisection takes any count function and calls it iters + 2 times;
    a brute-force count gives the tree's result."""
    pts, centers, valid = halos
    p, c = torch.from_numpy(pts), torch.from_numpy(centers)
    calls = []

    def brute(cen, radii):
        calls.append(radii.clone())
        d = p[None, :, :] - cen[:, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        return (d2 <= (radii * radii)[:, None]).sum(1, dtype=torch.int32)

    kw_args = dict(delta=200.0, particle_mass=1.0, n_particles=len(pts),
                   box_volume=1.0, r_max=0.1, iters=20)
    got = so_masses_from_counts(brute, c, torch.from_numpy(valid), **kw_args)
    assert len(calls) == 22
    assert all(not bool(r[~torch.from_numpy(valid)].any()) for r in calls)
    want = so_masses(pts, centers, valid, r_max=0.1, device="cpu")
    for f in SoMassResult._fields:
        torch.testing.assert_close(getattr(got, f), getattr(want, f),
                                   rtol=0, atol=0)


def test_so_masses_counts_share_one_pack(halos, monkeypatch):
    """The iters + 2 counts of ``so_masses`` run inside one
    ``shared_pack`` of the tree."""
    pts, centers, valid = halos
    opened = []
    real = kw.shared_pack

    def counting(bvh):
        opened.append(bvh)
        return real(bvh)

    from repro_torch.halos import so_mass
    monkeypatch.setattr(so_mass, "shared_pack", counting)
    so_masses(pts, centers, valid, r_max=0.1, iters=3, device="cpu")
    assert len(opened) == 1


def test_so_mass_uniform_ball():
    """The reference's uniform-ball case through the port: inside the
    ball the density is flat above Δ, outside it falls as r^-3, so R_Δ is
    twice the ball's radius and the whole ball is enclosed; with r_max
    below it, R_Δ is flagged unbracketed and clamped near r_max."""
    rng = np.random.default_rng(0)
    n, r_ball = 4000, 0.1
    u = rng.uniform(0, 1, n) ** (1 / 3)
    direction = rng.standard_normal((n, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    pts = (0.5 + r_ball * u[:, None] * direction).astype(np.float32)
    delta = 1.0 / (4.0 / 3.0 * np.pi * r_ball ** 3) / 8.0
    centers = np.array([[0.5, 0.5, 0.5]], np.float32)
    valid = np.array([True])
    bvh = _tree(pts)
    so = so_masses(pts, centers, valid, delta=delta, r_max=0.5, iters=24,
                   bvh=bvh, device="cpu")
    assert float(so.r_delta[0]) == pytest.approx(2 * r_ball, rel=0.05)
    assert int(so.count[0]) == n
    assert bool(so.bracketed[0])
    clamped = so_masses(pts, centers, valid, delta=delta, r_max=0.05,
                        iters=24, bvh=bvh, device="cpu")
    assert not bool(clamped.bracketed[0])
    assert float(clamped.r_delta[0]) == pytest.approx(0.05, rel=1e-3)
    want = jax_so_masses(jnp.asarray(pts), jnp.asarray(centers),
                         jnp.asarray(valid), delta=delta, r_max=0.5, iters=24)
    _assert_so_equal(so, want)


def test_so_masses_32bit_build_not_ported(halos):
    """The 32-bit build (which raised naming A8) against the reference."""
    pts, centers, valid = halos
    got = so_masses(pts, centers, valid, use_64bit=False, device="cpu")
    want = jax_so_masses(jnp.asarray(pts), jnp.asarray(centers),
                         jnp.asarray(valid), use_64bit=False)
    _assert_so_equal(got, want)
