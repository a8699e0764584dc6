"""Batched matrix-op tests against scipy/numpy (pivoted, independent) oracles."""

import numpy as np
import pytest
import scipy.linalg

from spartacus_surface_tpu.ops import matrix as M


def _random_dd(rng, batch, n):
    """Random diagonally-dominant batch (the SPARTACUS regime)."""
    a = rng.standard_normal((*batch, n, n))
    d = np.abs(a).sum(-1) + 1.0
    idx = np.arange(n)
    a[..., idx, idx] = np.sign(rng.standard_normal((*batch, n))) * d
    return a


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 16, 24])
def test_solve_matches_numpy(n):
    rng = np.random.default_rng(0)
    a = _random_dd(rng, (7,), n)
    b = rng.standard_normal((7, n, 3))
    x = np.asarray(M.solve(a, b))
    assert np.allclose(x, np.linalg.solve(a, b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n", [2, 4, 9])
def test_solve_vector_rhs(n):
    rng = np.random.default_rng(1)
    a = _random_dd(rng, (3, 5), n)
    b = rng.standard_normal((3, 5, n))
    x = np.asarray(M.solve(a, b))
    assert np.allclose(x, np.linalg.solve(a, b[..., None])[..., 0], rtol=1e-10)


@pytest.mark.parametrize("n", [1, 2, 6, 13])
def test_inv(n):
    rng = np.random.default_rng(2)
    a = _random_dd(rng, (4,), n)
    assert np.allclose(np.asarray(M.inv(a)), np.linalg.inv(a), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("n", [1, 2, 5, 10, 20])
def test_expm_small_norm(n):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((6, n, n))
    a = 0.4 * a / np.abs(a).sum(-1).max(-1)[..., None, None]
    got = np.asarray(M.expm_pade7(a))
    want = np.stack([scipy.linalg.expm(ai) for ai in a.reshape(-1, n, n)])
    assert np.allclose(got.reshape(-1, n, n), want, rtol=1e-12, atol=1e-14)


def test_expm_zero_is_identity():
    z = np.zeros((2, 4, 4))
    assert np.allclose(np.asarray(M.expm_pade7(z)), np.eye(4), atol=1e-15)


# The system sizes the solver reaches: N = 2 nd + nreg for the factory's
# Pade/doubling systems — 18 (nreg=2, 4 streams: the headline), 27
# (nreg=3, 4 streams: RAMI-V) and 51 (nreg=3, 8 streams: the largest).
# solve/inv/expm run the same route on every backend, so these are the
# card's own operations at its own sizes.
@pytest.mark.parametrize("n", [18, 27, 51])
def test_solver_sizes_against_scipy(n):
    rng = np.random.default_rng(n)
    a = _random_dd(rng, (5,), n)
    b = rng.standard_normal((5, n, n))
    x = np.asarray(M.solve(a, b))
    np.testing.assert_allclose(
        x, np.stack([scipy.linalg.solve(ai, bi) for ai, bi in zip(a, b)]),
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(M.inv(a)), np.stack([scipy.linalg.inv(ai) for ai in a]),
        rtol=1e-9, atol=1e-11)
    g = rng.standard_normal((3, n, n))
    g = 0.4 * g / np.abs(g).sum(-1).max(-1)[..., None, None]
    np.testing.assert_allclose(
        np.asarray(M.expm_pade7(g)),
        np.stack([scipy.linalg.expm(gi) for gi in g]),
        rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("n", [18, 27, 51])
def test_solver_sizes_float32(n):
    """The single-precision route at the same sizes: relative residual at
    float32 rounding of the condition-weighted solve."""
    rng = np.random.default_rng(100 + n)
    a = _random_dd(rng, (4,), n)
    b = rng.standard_normal((4, n, 3))
    x = np.asarray(M.solve(a.astype(np.float32), b.astype(np.float32)))
    assert x.dtype == np.float32
    want = np.linalg.solve(a, b)
    assert np.abs(x - want).max() < 1e-5 * np.abs(want).max()
