"""Parity tests for the precision-controlled dense linalg substrate.

Covers the fori_loop blocked algorithms and the recursive (divide-and-
conquer) variants used on the GPU, against numpy/LAPACK ground truth, at odd
(non-tile-multiple) sizes and for both vector and multi-RHS shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nonlinpdes_gpsolver.ops.linalg import (
    blocked_cholesky,
    blocked_trsm,
    recursive_cholesky,
    recursive_tri_inverse,
    recursive_trsm,
    unblocked_cholesky,
)


def _rand_spd(n, seed=0, cond=1e4):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.logspace(0, -np.log10(cond), n)
    return (Q * eigs) @ Q.T


@pytest.mark.parametrize("n", [1, 7, 64, 129, 300])
def test_recursive_cholesky_matches_lapack(n):
    A = _rand_spd(n, seed=n)
    L_ref = np.linalg.cholesky(A)
    L = recursive_cholesky(jnp.asarray(A), leaf=64)
    np.testing.assert_allclose(np.asarray(L), L_ref, rtol=2e-6, atol=2e-9)


@pytest.mark.parametrize("n", [64, 129, 300])
def test_recursive_matches_blocked(n):
    A = _rand_spd(n, seed=n + 1)
    Lb = blocked_cholesky(jnp.asarray(A), 64)
    Lr = recursive_cholesky(jnp.asarray(A), leaf=64)
    np.testing.assert_allclose(np.asarray(Lr), np.asarray(Lb), rtol=5e-6, atol=1e-8)


@pytest.mark.parametrize("n,m", [(7, 3), (129, 5), (300, 300)])
@pytest.mark.parametrize("trans", [False, True])
def test_recursive_trsm(n, m, trans):
    A = _rand_spd(n, seed=n + m)
    L = np.linalg.cholesky(A)
    V = np.random.default_rng(n * m).standard_normal((n, m))
    from scipy.linalg import solve_triangular as st

    ref = st(L, V, lower=True, trans=1 if trans else 0)
    got = recursive_trsm(jnp.asarray(L), jnp.asarray(V), trans, 64)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=3e-5, atol=1e-7)
    # vector RHS keeps its rank
    got1 = recursive_trsm(jnp.asarray(L), jnp.asarray(V[:, 0]), trans, 64)
    assert got1.shape == (n,)
    np.testing.assert_allclose(np.asarray(got1), ref[:, 0], rtol=3e-5, atol=1e-7)


@pytest.mark.parametrize("n", [7, 64, 129, 300])
def test_recursive_tri_inverse(n):
    A = _rand_spd(n, seed=2 * n)
    L = np.linalg.cholesky(A)
    Minv = recursive_tri_inverse(jnp.asarray(L), 64)
    np.testing.assert_allclose(
        np.asarray(Minv) @ L, np.eye(n), rtol=0, atol=5e-5
    )


def test_blocked_trsm_matches_recursive():
    n, m = 200, 16
    A = _rand_spd(n, seed=5)
    L = jnp.asarray(np.linalg.cholesky(A))
    V = jnp.asarray(np.random.default_rng(6).standard_normal((n, m)))
    np.testing.assert_allclose(
        np.asarray(blocked_trsm(L, V, 64)),
        np.asarray(recursive_trsm(L, V, False, 64)),
        rtol=3e-6,
        atol=1e-8,
    )


def test_unblocked_cholesky_f64_exact():
    # conftest enables x64 globally, so this exercises the f64 path
    A = jnp.asarray(_rand_spd(50, seed=9))
    assert A.dtype == jnp.float64
    L = unblocked_cholesky(A)
    np.testing.assert_allclose(
        np.asarray(L), np.linalg.cholesky(np.asarray(A)), rtol=1e-12, atol=1e-14
    )


def test_newton_refine_tri_inverse_improves_residual():
    """On an ill-conditioned f32 factor, one Newton step must shrink
    ||WL - I|| by orders of magnitude."""
    from nonlinpdes_gpsolver.ops.linalg import newton_refine_tri_inverse

    n = 400
    A64 = _rand_spd(n, seed=11, cond=1e8)
    L = jnp.asarray(np.linalg.cholesky(A64), dtype=jnp.float32)
    W0 = recursive_tri_inverse(L, 64)
    eye = np.eye(n)

    def resid(W):
        return np.abs(np.asarray(W, np.float64) @ np.asarray(L, np.float64) - eye).max()

    r0 = resid(W0)
    r1 = resid(newton_refine_tri_inverse(L, W0, 1))
    # quadratic convergence until the f32 representation floor of W itself;
    # on this matrix that floor allows ~4x (on the solver's equilibrated
    # Gram factors the measured gain is ~200x, see ops/linalg.py docstring)
    assert r1 < 0.5 * r0, (r0, r1)


@pytest.mark.parametrize("n", [5, 130])
def test_spd_solve_controlled_matches_lapack(n):
    from nonlinpdes_gpsolver.ops.linalg import spd_solve, spd_solve_controlled

    H = jnp.asarray(_rand_spd(n, seed=3 * n, cond=1e6))
    g = jnp.asarray(np.random.default_rng(n).standard_normal(n))
    ref = np.linalg.solve(np.asarray(H), np.asarray(g))
    got = spd_solve_controlled(H, g)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-6, atol=1e-9)
    # the default path (CPU branch here) agrees too
    np.testing.assert_allclose(np.asarray(spd_solve(H, g)), ref, rtol=1e-6, atol=1e-9)


def test_cholesky_inverse_all_gemm():
    """The simultaneous (L, L^{-1}) factorization (the all-GEMM SPD-solve
    substrate behind spd_solve_controlled, round-5): both outputs accurate
    on an ill-conditioned SPD matrix, at f32 and f64."""
    import jax.numpy as jnp

    from nonlinpdes_gpsolver.ops.linalg import cholesky_inverse

    rng = np.random.default_rng(0)
    n = 500
    A = rng.standard_normal((n, n))
    # spread the spectrum: scale rows/cols to induce ~1e6 conditioning
    s = np.logspace(0, 3, n)
    H = (A @ A.T + n * np.eye(n)) * np.outer(s, s)
    for dtype, tol in ((jnp.float64, 1e-12), (jnp.float32, 1e-5)):
        L, W = cholesky_inverse(jnp.asarray(H, dtype))
        Lr, Wr = np.asarray(L), np.asarray(W)
        assert np.max(np.abs(Lr @ Lr.T - H)) / np.max(np.abs(H)) < tol
        assert np.max(np.abs(Wr @ Lr - np.eye(n))) < 200 * tol
        # strictly lower-triangular outputs
        assert np.allclose(np.triu(Lr, 1), 0) and np.allclose(np.triu(Wr, 1), 0)
