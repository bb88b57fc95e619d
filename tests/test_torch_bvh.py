"""The port's Morton codes and LBVH against the JAX reference: bit-exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core import morton as jmorton  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.bvh import build_bvh_objects as jax_build_bvh_objects  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro_torch.core import morton  # noqa: E402
from repro_torch.core.bvh import build_bvh, build_bvh_objects  # noqa: E402
from repro_torch.core.geometry import scene_bounds  # noqa: E402
from repro_torch.interop import morton64_to_int64  # noqa: E402


def _cloud(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "n2":
        return rng.uniform(0, 1, (2, 3)).astype(np.float32)
    if kind == "n3":
        return rng.uniform(0, 1, (3, 3)).astype(np.float32)
    if kind == "clustered300":
        return make_clustered_points(rng, 300)
    # 16 coincident points: every code ties, the index-XOR branch decides.
    return np.full((16, 3), 0.25, np.float32)


@pytest.mark.parametrize("kind", ["n2", "n3", "clustered300", "coincident16"])
def test_morton_and_bvh_bit_exact(kind):
    pts = _cloud(kind)
    jp = jnp.asarray(pts)
    jlo, jhi = jax_scene_bounds(jp)
    tp = torch.from_numpy(pts)
    lo, hi = scene_bounds(tp)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))

    jh, jl = jmorton.morton64(jmorton.normalize_points(jp, jlo, jhi))
    codes = morton.morton64(morton.normalize_points(tp, lo, hi))
    assert torch.equal(codes, morton64_to_int64(np.asarray(jh), np.asarray(jl)))

    jb = jax_build_bvh(jp, jlo, jhi)
    tb = build_bvh(tp, lo, hi)
    for field in jb._fields:
        want = np.asarray(getattr(jb, field))
        got = getattr(tb, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got, want, err_msg=field)


def test_common_prefix_length_near_powers_of_two():
    """clz by shifts, not float log2: 2^k - 1 and 2^k differ in bit length
    although they round to the same float."""
    codes = torch.tensor([(1 << 53) - 1, 1 << 53, (1 << 62) - 1, 1 << 62],
                         dtype=torch.int64)
    i = torch.tensor([0, 2], dtype=torch.int64)
    got = morton.common_prefix_length64(codes, i, i + 1)
    # codes[0] ^ codes[1] = 2^54 - 1 (54 bits); codes[2] ^ codes[3] = 2^63 - 1
    assert got.tolist() == [64 - 54, 64 - 63]


def _half_widths(n, seed):
    """Box half-widths up to 0.02, a tenth of them zero (point boxes)."""
    rng = np.random.default_rng(seed)
    h = rng.uniform(0, 0.02, (n, 3)).astype(np.float32)
    h[rng.random(n) < 0.1] = 0.0
    return h


def _assert_tree_equal(tb, jb):
    for field in jb._fields:
        want = np.asarray(getattr(jb, field))
        got = getattr(tb, field).numpy()
        assert got.dtype == want.dtype, field
        np.testing.assert_array_equal(got.view(np.int32) if got.dtype == np.float32
                                      else got,
                                      want.view(np.int32) if want.dtype == np.float32
                                      else want, err_msg=field)


@pytest.mark.parametrize("kind", ["n2", "n3", "clustered300", "coincident16"])
@pytest.mark.parametrize("use_64bit", [True, False])
def test_build_bvh_objects_and_32bit_build_bit_exact(kind, use_64bit):
    """``build_bvh`` over 30-bit codes and ``build_bvh_objects`` over boxes
    (codes from box centres), every field bit for bit."""
    pts = _cloud(kind)
    jp, tp = jnp.asarray(pts), torch.from_numpy(pts)
    jlo, jhi = jax_scene_bounds(jp)
    lo, hi = scene_bounds(tp)
    tb = build_bvh(tp, lo, hi, use_64bit=use_64bit)
    _assert_tree_equal(tb, jax_build_bvh(jp, jlo, jhi, use_64bit=use_64bit))
    assert tb.box_leaves is False
    h = _half_widths(len(pts), len(kind))
    jb = jax_build_bvh_objects(jp - h, jp + h, jlo, jhi, use_64bit=use_64bit)
    tb = build_bvh_objects(tp - torch.from_numpy(h), tp + torch.from_numpy(h),
                           lo, hi, use_64bit=use_64bit)
    _assert_tree_equal(tb, jb)
    assert tb.box_leaves is True


def test_32bit_build_on_shared_codes():
    """Table 1's regime: a clustered cloud where most points share their
    30-bit code with another, so the index tie-break builds much of the
    tree; exact against the reference."""
    rng = np.random.default_rng(61)
    base = rng.uniform(0, 1, (60, 3)).astype(np.float32)
    pts = (base[rng.integers(0, 60, 500)]
           + rng.uniform(0, 1e-4, (500, 3)).astype(np.float32))
    codes = morton.morton32(morton.normalize_points(
        torch.from_numpy(pts), *scene_bounds(torch.from_numpy(pts))))
    assert codes.unique().numel() < 100
    jp = jnp.asarray(pts)
    tb = build_bvh(torch.from_numpy(pts), *scene_bounds(torch.from_numpy(pts)),
                   use_64bit=False)
    _assert_tree_equal(tb, jax_build_bvh(jp, *jax_scene_bounds(jp),
                                         use_64bit=False))


def test_common_prefix_length32_matches_reference():
    rng = np.random.default_rng(62)
    codes = np.sort(rng.integers(0, 1 << 30, 300)).astype(np.uint32)
    codes[100:140] = codes[100]
    i = rng.integers(0, 300, 500).astype(np.int32)
    j = (i + rng.integers(-40, 41, 500)).astype(np.int32)
    want = np.asarray(jmorton.common_prefix_length32(
        jnp.asarray(codes), jnp.asarray(i), jnp.asarray(j)))
    got = morton.common_prefix_length32(torch.from_numpy(codes.astype(np.int64)),
                                        torch.from_numpy(i).long(),
                                        torch.from_numpy(j).long())
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
