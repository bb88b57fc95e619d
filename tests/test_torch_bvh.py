"""The port's Morton codes and LBVH against the JAX reference: bit-exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from conftest import make_clustered_points  # noqa: E402
from repro.core import morton as jmorton  # noqa: E402
from repro.core.bvh import build_bvh as jax_build_bvh  # noqa: E402
from repro.core.geometry import scene_bounds as jax_scene_bounds  # noqa: E402
from repro_torch.core import morton  # noqa: E402
from repro_torch.core.bvh import build_bvh  # noqa: E402
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
