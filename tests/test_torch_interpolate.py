"""The port's MLS interpolation (``mls_interpolate``, ``wendland_c2``) on
the CPU against the JAX reference.

Both solve float32 (d+1)×(d+1) systems with LU; the two libraries'
factorisations and the reference's FMA-contracted sums (ROADMAP C8) part
in the last bits, which the system's condition number magnifies (up to
4e7 for 4 nearly coplanar neighbours). So each target's interpolant is
compared within ``1e-6 + cond · 2^-24``, its Gram matrix's condition
number (float64) times float32's unit roundoff, the scale of a backward
stable solve's forward error."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.interpolate import mls_interpolate as jax_mls  # noqa: E402
from repro.core.interpolate import wendland_c2 as jax_wendland  # noqa: E402
from repro_torch.core.interpolate import mls_interpolate, wendland_c2  # noqa: E402


def _field(p):
    return (np.sin(4 * p[:, 0]) + p[:, 1] ** 2 - 0.5 * p[:, 2]).astype(np.float32)


def _gram_condition(src, tgt, k):
    """The condition number of each target's Gram matrix, float64."""
    d2 = ((tgt[:, None].astype(np.float64) - src[None]) ** 2).sum(-1)
    idx = np.argsort(d2, 1)[:, :k]
    dist = np.sqrt(np.take_along_axis(d2, idx, 1))
    t = np.clip(dist / (1.1 * dist.max(1, keepdims=True) + 1e-12), 0, 1)
    w = (1 - t) ** 4 * (4 * t + 1)
    basis = np.concatenate([np.ones(idx.shape + (1,)), src[idx] - tgt[:, None]], 2)
    gram = np.einsum("qki,qkj->qij", basis * w[..., None], basis) + 1e-8 * np.eye(4)
    return np.linalg.cond(gram)


@pytest.mark.parametrize("k", [4, 8, 12])
def test_mls_matches_reference(k):
    rng = np.random.default_rng(91)
    src = rng.uniform(0, 1, (512, 3)).astype(np.float32)
    tgt = rng.uniform(0.1, 0.9, (128, 3)).astype(np.float32)
    want = np.asarray(jax_mls(jnp.asarray(src), jnp.asarray(_field(src)),
                              jnp.asarray(tgt), k=k))
    got = mls_interpolate(src, _field(src), tgt, k, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (128,)
    tol = 1e-6 + _gram_condition(src, tgt, k) * 2.0 ** -24
    assert (np.abs(got.numpy() - want) <= tol).all()


def test_mls_reproduces_linear_fields():
    """Degree-1 MLS reproduces linear functions (the reference's test)."""
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    tgt = rng.uniform(0.1, 0.9, (50, 3)).astype(np.float32)

    def f(p):
        return (2.0 * p[:, 0] - 3.0 * p[:, 1] + 0.5 * p[:, 2] + 1.0).astype(np.float32)

    got = mls_interpolate(src, f(src), tgt, k=10, device="cpu").numpy()
    np.testing.assert_allclose(got, f(tgt), rtol=1e-3, atol=1e-3)


def test_wendland_c2_matches_reference():
    r = np.linspace(0, 2, 41, dtype=np.float32)
    for radius in (np.float32(1.0), np.float32(0.0), np.float32(0.3)):
        want = np.asarray(jax_wendland(jnp.asarray(r), jnp.asarray(radius)))
        got = wendland_c2(torch.from_numpy(r), torch.tensor(radius))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
