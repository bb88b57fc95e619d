"""The port's ray casting (``raycast``: the nearest hit; ``raycast_all``:
every hit as CSR) on the CPU against the JAX reference, on box leaves and
on point leaves, with misses, axis-parallel rays and rays whose
direction has a component in (-1e-12, 0) (inverse +inf). The slab test
has no multiply-add to contract, so indices and ``t`` are compared bit
for bit."""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.bvh import build_bvh_objects as jax_build_bvh_objects  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro.core.raycast import raycast as jax_raycast  # noqa: E402
from repro.core.raycast import raycast_all as jax_raycast_all  # noqa: E402
from repro_torch.core.geometry import ray_box, safe_inv  # noqa: E402
from repro_torch.core.raycast import raycast, raycast_all  # noqa: E402
from repro_torch.interop import bvh_from_numpy  # noqa: E402

jq = importlib.import_module("repro.core.query")
tq = importlib.import_module("repro_torch.core.query")


def _scene(boxes: bool, seed=101, n=400):
    rng = np.random.default_rng(seed)
    pts = make_clustered_points(rng, n)
    jp = jnp.asarray(pts)
    lo, hi = jax_scene_bounds(jp)
    if boxes:
        h = rng.uniform(0.002, 0.03, pts.shape).astype(np.float32)
        jb = jax_build_bvh_objects(jp - h, jp + h, lo, hi)
    else:
        jb = jax_build_bvh(jp, lo, hi)
    return pts, jb, bvh_from_numpy(*(np.asarray(f) for f in jb))


AWAY = np.arange(3, 300, 13)
AXIS = np.setdiff1d(np.arange(0, 300, 7), AWAY)


def _rays(pts, seed=102, m=300):
    """Random rays; every 7th along z from under a particle (AXIS); every
    11th with an x component in (-1e-12, 0); every 13th (AWAY) from
    outside the scene heading away from it, a miss."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 1.2, (m, 3)).astype(np.float32)
    d = rng.standard_normal((m, 3)).astype(np.float32)
    d[1::11, 0] = -rng.uniform(0, 1e-12, d[1::11].shape[0]).astype(np.float32)
    o[AWAY] = (2.0, 2.0, 2.0)
    d[AWAY] = (1.0, 0.5, 0.25)
    o[AXIS, :2] = pts[rng.integers(0, len(pts), AXIS.size), :2]
    o[AXIS, 2] = -0.5
    d[AXIS] = (0.0, 0.0, 1.0)
    return o, d


def _assert_hits(got, want):
    np.testing.assert_array_equal(got.index.numpy(), np.asarray(want.index))
    np.testing.assert_array_equal(got.t.numpy().view(np.int32),
                                  np.asarray(want.t).view(np.int32))


@pytest.mark.parametrize("boxes", [True, False])
def test_raycast_matches_reference(boxes):
    pts, jb, tb = _scene(boxes)
    o, d = _rays(pts)
    want = jax_raycast(jb, jnp.asarray(o), jnp.asarray(d))
    got = raycast(tb, o, d)
    _assert_hits(got, want)
    assert (got.index[AWAY] == -1).all()
    if boxes:
        assert (got.index[AXIS] >= 0).all()


@pytest.mark.parametrize("sort_queries", [False, True])
def test_query_ray_nearest_hit_matches_reference(sort_queries):
    pts, jb, tb = _scene(True, seed=103)
    o, d = _rays(pts, seed=104)
    want = jq.query(jb, jq.ray(jnp.asarray(o), jnp.asarray(d)),
                    sort_queries=sort_queries)
    got = tq.query(tb, tq.ray(torch.from_numpy(o), torch.from_numpy(d)),
                   sort_queries=sort_queries)
    assert isinstance(got, tq.RayResult)
    _assert_hits(got, want)


def test_raycast_hits_the_nearest_box():
    """The reference's three boxes along +x: the nearest is hit at t = 1;
    the ray along -x misses."""
    lo = np.array([[1, -.1, -.1], [3, -.1, -.1], [5, -.1, -.1]], np.float32)
    hi = lo + np.float32(0.5)
    jb = jax_build_bvh_objects(jnp.asarray(lo), jnp.asarray(hi),
                               jnp.asarray(lo.min(0) - 1), jnp.asarray(hi.max(0) + 1))
    tb = bvh_from_numpy(*(np.asarray(f) for f in jb))
    o = np.zeros((2, 3), np.float32)
    d = np.array([[1, 0, 0], [-1, 0, 0]], np.float32)
    got = raycast(tb, o, d)
    _assert_hits(got, jax_raycast(jb, jnp.asarray(o), jnp.asarray(d)))
    assert got.index.tolist() == [0, -1] and float(got.t[0]) == 1.0


@pytest.mark.parametrize("capacity", [None, "half"])
def test_raycast_all_matches_reference(capacity):
    pts, jb, tb = _scene(True, seed=105)
    o, d = _rays(pts, seed=106)
    want = jax_raycast_all(jb, jnp.asarray(o), jnp.asarray(d))
    cap = None if capacity is None else int(want.total) // 2
    if cap is not None:
        want = jax_raycast_all(jb, jnp.asarray(o), jnp.asarray(d), capacity=cap)
    got = raycast_all(tb, o, d, capacity=cap)
    for f in ("offsets", "indices", "total", "overflowed"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_nearest_hit_is_the_least_t_of_all_hits():
    """Each ray's nearest hit is in its all-hits row, at the least slab t
    of that row; a miss has an empty row."""
    pts, _, tb = _scene(True, seed=107)
    o, d = _rays(pts, seed=108)
    near = raycast(tb, o, d)
    rows = raycast_all(tb, o, d)
    ro, ri = tb.node_lo[tb.num_leaves - 1:], tb.node_hi[tb.num_leaves - 1:]
    slot = torch.empty(tb.num_leaves, dtype=torch.long)
    slot[tb.leaf_perm.long()] = torch.arange(tb.num_leaves)
    tt = torch.from_numpy(o)
    inv = safe_inv(torch.from_numpy(d))
    for i in range(o.shape[0]):
        hits = rows.indices[rows.offsets[i]:rows.offsets[i + 1]].long()
        if near.index[i] < 0:
            assert hits.numel() == 0
            continue
        t, hit = ray_box(tt[i].expand(hits.numel(), 3),
                         inv[i].expand(hits.numel(), 3), ro[slot[hits]],
                         ri[slot[hits]])
        assert hit.all() and int(near.index[i]) in hits.tolist()
        assert float(near.t[i]) == float(t.min())
