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
from repro_torch.core.geometry import point_aabb_dist2, scene_bounds  # noqa: E402
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


def _jax_counts(pts, centers, radii):
    jp = jnp.asarray(pts)
    jb = jax_build_bvh(jp, *jax_scene_bounds(jp))
    return np.asarray(jax_query_count(jb, jax_within(jnp.asarray(centers),
                                                     jnp.asarray(radii))))


def _sq(radii):
    r = torch.from_numpy(radii)
    return r * r


def _lattice_case(rng):
    """Points on a dyadic lattice (spacing 1/8, every d² exact, so XLA's
    contraction of d² into an FMA, C8, cannot show), centres on it and
    half a step off it, radii of lattice distances (3-4-5 and 2-3-6
    triples among them): many points lie on a sphere, and many node
    boxes' far corners too."""
    g = np.arange(8, dtype=np.float32) / 8
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    centers = (rng.integers(0, 16, (96, 3)) / 16).astype(np.float32)
    radii = (rng.choice([0, 1, 2, 3, 4, 5, 7, 10, 14], 96) / 8
             ).astype(np.float32)
    return pts, centers, radii


def _duplicates_case(rng):
    """Clustered points and 12 points repeated 25 times each: whole
    subtrees whose box is one point, contained even at radius 0."""
    base = make_clustered_points(rng, 300)
    dup = np.repeat(base[:12], 25, axis=0)
    pts = np.concatenate([base, dup]).astype(np.float32)
    centers = np.concatenate([base[:12], base[100:140]]).astype(np.float32)
    radii = rng.choice([0.0, 0.0, 0.01, 0.05, 0.2], len(centers)
                       ).astype(np.float32)
    return pts, centers, radii


def _radius_zero_case(rng):
    pts = make_clustered_points(rng, 400)
    centers = np.concatenate([pts[::7], rng.uniform(0, 1, (20, 3))]
                             ).astype(np.float32)
    return pts, centers, np.zeros(len(centers), np.float32)


def _whole_scene_case(rng):
    pts = make_clustered_points(rng, 400)
    centers = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    return pts, centers, np.full(16, 4.0, np.float32)


def _nan_centre_case(rng):
    pts = make_clustered_points(rng, 400)
    centers = rng.uniform(0, 1, (12, 3)).astype(np.float32)
    centers[::3, 0] = np.nan
    centers[1::3, 2] = np.nan
    return pts, centers, rng.uniform(0, 0.5, 12).astype(np.float32)


SPHERE_CASES = {"lattice": _lattice_case, "duplicates": _duplicates_case,
                "radius_zero": _radius_zero_case,
                "whole_scene": _whole_scene_case,
                "nan_centre": _nan_centre_case}


@pytest.mark.parametrize("case", sorted(SPHERE_CASES))
def test_sphere_count_plain_matches_reference(case):
    """The SO count's walk (contained subtrees counted from their span)
    and ``sphere_counts`` on the CPU equal JAX's ``query_count`` over
    ``within``, and the rope walk's counts, on inputs built to sit on the
    edge of the contained test."""
    rng = np.random.default_rng(sorted(SPHERE_CASES).index(case))
    pts, centers, radii = SPHERE_CASES[case](rng)
    want = _jax_counts(pts, centers, radii)
    bvh = _tree(pts)
    c = torch.from_numpy(centers)
    got = kw.wavefront_sphere_count_plain(bvh, c, _sq(radii))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sphere_counts(bvh, None, c, torch.from_numpy(radii)).numpy(), want)
    np.testing.assert_array_equal(
        kw.wavefront_count_plain(bvh, c, _sq(radii)).numpy(), want)
    if case == "whole_scene":
        # The root is contained: n, after one hop.
        counts, stats = kw.wavefront_sphere_count_plain(bvh, c, _sq(radii),
                                                        with_stats=True)
        assert bool((counts == len(pts)).all())
        assert stats.tolist() == [[1] * len(centers)] * 3
    if case == "nan_centre":
        assert not want[::3].any() and not want[1::3].any()


def test_so_masses_count_through_the_so_kernel_wrapper(halos, monkeypatch):
    """``so_masses``'s ``iters + 2`` counts go through the SO count's
    wrapper (``wavefront_sphere_count``), one call each."""
    pts, centers, valid = halos
    from repro_torch.halos import so_mass
    calls = []
    real = so_mass.wavefront_sphere_count

    def recording(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(so_mass, "wavefront_sphere_count", recording)
    so_masses(pts, centers, valid, r_max=0.1, iters=3, device="cpu")
    assert calls == [len(centers)] * 5


def test_sphere_count_walks_fewer_hops_than_the_rope_walk():
    """On a clustered cloud with SO-like radii the contained test cuts the
    walk: fewer hops per query in all and on the heaviest query, with the
    counts unchanged."""
    rng = np.random.default_rng(5)
    pts = make_clustered_points(rng, 4000, n_halos=3, noise_frac=0.1)
    bvh = _tree(pts)
    c = torch.from_numpy(pts[rng.choice(len(pts), 64, replace=False)])
    r2 = _sq(rng.uniform(0.05, 0.3, 64).astype(np.float32))
    got, stats = kw.wavefront_sphere_count_plain(bvh, c, r2, with_stats=True)
    lanes = torch.arange(64)
    want, rope_hops, rope_stats = kw.lockstep_traverse(
        bvh, c, r2, lanes, torch.zeros(64, dtype=torch.int32),
        kw.count_epilogue(None), depths=torch.zeros(2 * len(pts) - 1,
                                                    dtype=torch.int32))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(stats[0].sum()) < rope_hops
    heavy = int(want.argmax())
    assert int(stats[0, heavy]) * 4 < int(rope_stats[0, heavy])
    assert bool((stats[0] <= rope_stats[0]).all())


def test_sphere_count_raises_on_box_leaves():
    from repro_torch.core.bvh import build_bvh_objects
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(make_clustered_points(rng, 200))
    boxes = build_bvh_objects(pts - 0.01, pts + 0.01, *scene_bounds(pts))
    r2 = torch.full((5,), 0.01)
    with pytest.raises(ValueError, match="leaves are points"):
        kw.wavefront_sphere_count_plain(boxes, pts[:5], r2)
    with pytest.raises(ValueError, match="leaves are points"):
        kw.wavefront_sphere_count(boxes, pts[:5], r2)
    with pytest.raises(ValueError, match="leaves are points"):
        sphere_counts(boxes, None, pts[:5], 0.1)


def test_sphere_count_at_radii_on_a_point():
    """r² set to a leaf's own d² and to the float32 just below it: a box
    whose farthest corner is that leaf is contained at the first and not
    at the second, so a far test one ulp too lax would count a leaf the
    rope walk does not. The counts equal the rope walk's (r² here is no
    float32 square, so JAX's ``within`` cannot take it)."""
    rng = np.random.default_rng(11)
    pts = make_clustered_points(rng, 1500)
    bvh = _tree(pts)
    p = torch.from_numpy(pts)
    c = torch.from_numpy(rng.uniform(0, 1, (200, 3)).astype(np.float32))
    k = torch.from_numpy(rng.integers(0, len(pts), 200))
    d2 = point_aabb_dist2(c, p[k], p[k])
    for r2 in (d2, torch.nextafter(d2, torch.zeros(()))):
        got = kw.wavefront_sphere_count_plain(bvh, c, r2)
        torch.testing.assert_close(got, kw.wavefront_count_plain(bvh, c, r2),
                                   rtol=0, atol=0)
