"""The traversal kernel's packed node records (``pack_tree``) and its
MIN_LABEL keys (``min_label_keys``), on the CPU: the records are bit copies
of the port's tree and of the JAX reference's, a walk over the records
takes the plain version's hops, and the keys give the minima of the
three-load form. The kernel itself is held against the plain version on
the card (``tests/test_torch_kernels_gpu.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro_torch.core.bvh import SENTINEL, build_bvh  # noqa: E402
from repro_torch.core.geometry import point_aabb_dist2, scene_bounds  # noqa: E402
from repro_torch.kernels import wavefront as kw  # noqa: E402

I32 = torch.int32
KINDS = ["n2", "odd301", "duplicates200"]


def _points(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "n2":
        return rng.uniform(0, 1, (2, 3)).astype(np.float32)
    if kind == "odd301":
        return make_clustered_points(rng, 301)
    # 25 positions, each taken by 8 points: zero-size boxes that coincide.
    base = rng.uniform(0, 1, (25, 3)).astype(np.float32)
    return np.repeat(base, 8, axis=0)[rng.permutation(200)]


def _tree(kind):
    pts = torch.from_numpy(_points(kind))
    return pts, build_bvh(pts, *scene_bounds(pts))


@pytest.mark.parametrize("kind", KINDS)
def test_pack_tree_round_trips_bit_for_bit(kind):
    _, bvh = _tree(kind)
    n = bvh.num_leaves
    packed = kw.pack_tree(bvh)
    assert packed.inner.shape == (n - 1, 8) and packed.leaves.shape == (n, 4)
    for t in packed:
        assert t.dtype == torch.float32 and t.is_contiguous()
        assert t.data_ptr() % 16 == 0
    inner, leaves = packed.inner.view(I32), packed.leaves.view(I32)
    lo, hi = bvh.node_lo.view(I32), bvh.node_hi.view(I32)
    assert torch.equal(inner[:, 0:3], lo[:n - 1])
    assert torch.equal(inner[:, 3], bvh.left_child)
    assert torch.equal(inner[:, 4:7], hi[:n - 1])
    assert torch.equal(leaves[:, 0:3], lo[n - 1:])
    assert torch.equal(leaves[:, 0:3], hi[n - 1:])
    rope = torch.cat([inner[:, 7], leaves[:, 3]])
    assert torch.equal(rope, bvh.rope)
    # The root's and the last leaf's ropes at least: NaN bit patterns kept.
    assert int((rope == SENTINEL).sum()) >= 2


@pytest.mark.parametrize("kind", KINDS)
def test_packed_records_equal_the_reference_trees(kind):
    pts = _points(kind)
    jp = jnp.asarray(pts)
    jb = jax_build_bvh(jp, *jax_scene_bounds(jp))
    n = pts.shape[0]
    lo = np.asarray(jb.node_lo).view(np.int32)
    hi = np.asarray(jb.node_hi).view(np.int32)
    rope, left = np.asarray(jb.rope), np.asarray(jb.left_child)
    want_inner = np.concatenate([lo[:n - 1], left[:, None], hi[:n - 1],
                                 rope[:n - 1, None]], 1)
    want_leaves = np.concatenate([lo[n - 1:], rope[n - 1:, None]], 1)
    packed = kw.pack_tree(_tree(kind)[1])
    np.testing.assert_array_equal(packed.inner.view(I32).numpy(), want_inner)
    np.testing.assert_array_equal(packed.leaves.view(I32).numpy(), want_leaves)


def _packed_walk(packed, centers, r2):
    """(counts, hops) of a lockstep walk that reads only the records, hop
    by hop as the kernel does: an internal node's two halves, a leaf's
    one record as both corners of its box, the next node from the w lane
    of the first half on a hit and of the second on a miss."""
    inner, leaves = packed.inner.view(I32), packed.leaves.view(I32)
    n, q = leaves.shape[0], centers.shape[0]
    node = torch.zeros(q, dtype=torch.int64)
    counts = torch.zeros(q, dtype=I32)
    live = torch.arange(q)
    hops = 0
    while live.numel():
        hops += live.numel()
        nd = node[live]
        leaf = nd >= n - 1
        leaf_rec = leaves[(nd - (n - 1)).clamp(min=0)]
        first = torch.where(leaf[:, None], leaf_rec, inner[nd.clamp(max=n - 2), :4])
        second = torch.where(leaf[:, None], leaf_rec, inner[nd.clamp(max=n - 2), 4:])
        d2 = point_aabb_dist2(centers[live], first[:, :3].view(torch.float32),
                              second[:, :3].view(torch.float32))
        hit = d2 <= r2[live]
        counts[live] += (leaf & hit).to(I32)
        nxt = torch.where(hit, first[:, 3], second[:, 3]).long()
        node[live] = nxt
        live = live[nxt != SENTINEL]
    return counts, hops


@pytest.mark.parametrize("kind", KINDS)
def test_walk_over_packed_records_takes_the_plain_hops(kind):
    pts, bvh = _tree(kind)
    rng = np.random.default_rng(7)
    queries = torch.cat([pts, torch.from_numpy(
        rng.uniform(-0.5, 1.5, (64, 3)).astype(np.float32))])
    q = queries.shape[0]
    r2 = torch.from_numpy(rng.uniform(0, 0.2, q).astype(np.float32)) ** 2
    # Zero-size boxes at exactly r2: each query's own d2 to one leaf.
    j = torch.from_numpy(rng.integers(0, pts.shape[0], q))
    r2[::2] = point_aabb_dist2(queries, pts[j], pts[j])[::2]
    got, hops = _packed_walk(kw.pack_tree(bvh), queries, r2)
    want, want_hops = kw.lockstep_traverse(
        bvh, queries, r2, torch.arange(q), torch.zeros(q, dtype=I32),
        kw.count_epilogue(None))
    assert torch.equal(got, want) and hops == want_hops


def _key_min(bvh, centers, r2, key, mask, sentinel):
    """MIN_LABEL as the kernel computes it: the carry starts at
    ``sentinel`` and takes the min with the key of every leaf hit."""
    n = bvh.num_leaves

    def epilogue(best, node, leaf_hit, _d2):
        k = key[(node - (n - 1)).clamp(0, n - 1)]
        return torch.where(leaf_hit, torch.minimum(best, k), best), \
            torch.zeros_like(leaf_hit)

    out = torch.full((centers.shape[0],), sentinel, dtype=I32)
    lanes = torch.nonzero(mask).flatten()
    out[lanes] = kw.lockstep_traverse(bvh, centers, r2, lanes, out[lanes],
                                      epilogue)[0]
    return out


@pytest.mark.parametrize("case", ["random", "labels_above_sentinel",
                                  "no_core"])
def test_min_label_keys_give_the_three_load_minima(case):
    pts, bvh = _tree("odd301")
    n = pts.shape[0]
    rng = np.random.default_rng(len(case))
    labels = torch.from_numpy(rng.permutation(n).astype(np.int32))
    core = torch.from_numpy(rng.random(n) < 0.6)
    mask = torch.from_numpy(rng.random(n) < 0.8)
    sentinel = n
    if case == "labels_above_sentinel":
        sentinel = n // 2
    elif case == "no_core":
        core = torch.zeros(n, dtype=torch.bool)
    r2 = torch.full((n,), 0.05 ** 2)
    key = kw.min_label_keys(bvh, labels, core, sentinel)
    assert key.dtype == I32 and key.shape == (n,)
    got = _key_min(bvh, pts, r2, key, mask, sentinel)
    want = kw.wavefront_min_label_plain(bvh, pts, r2, labels, core, mask,
                                        sentinel)
    assert torch.equal(got, want)
    if case == "no_core":
        assert bool((key == sentinel).all()) and bool((got == sentinel).all())
    else:
        assert bool((got[mask] < sentinel).any())


def test_shared_pack_packs_each_tree_once(monkeypatch):
    """Inside ``shared_pack(bvh)`` the wrappers' records of that tree are
    made once; another tree, and the same tree outside, pack anew."""
    made = []

    def counting_pack(bvh):
        made.append(bvh)
        return kw.pack_tree_plain(bvh)

    monkeypatch.setattr(kw, "pack_tree", counting_pack)
    _, bvh = _tree("odd301")
    _, other = _tree("n2")
    with kw.shared_pack(bvh):
        first = kw._packed(bvh)
        assert kw._packed(bvh) is first
        kw._packed(other)
        with kw.shared_pack(other):
            assert kw._packed(other) is kw._packed(other)
        assert kw._packed(bvh) is first
    assert kw._packed(bvh) is not first
    assert [b is bvh for b in made] == [True, False, False, True]
    assert not kw._open.packs
