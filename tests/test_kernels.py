"""Closed-form derivative kernels vs. autodiff, to near machine precision.

This is the correctness substrate test (SURVEY.md section 7 phase 1): every
operator pair the four upstream workloads need (and a few extras) must match
the nested-grad evaluation of the same kernel.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from nonlinpdes_gpsolver.ops import (
    SquaredExponential,
    ad_pair_fn,
    d,
    d2,
    identity,
    laplacian,
)

OPS = {
    "id": identity(),
    "d0": d(0),
    "d1": d(1),
    "d00": d2(0, 0),
    "d11": d2(1, 1),
    "d01": d2(0, 1),
    "lap": laplacian(),
}

KERNELS = {
    "gaussian": SquaredExponential.gaussian(0.2),
    "aniso_len": SquaredExponential.anisotropic([0.3, 0.05]),
    "aniso_prec": SquaredExponential.anisotropic([3.0, 20.0], "precision"),
}


def _points(n, m, seed=0):
    rng = np.random.default_rng(seed)
    X = jnp.asarray(rng.uniform(0, 1, (n, 2)))
    Y = jnp.asarray(rng.uniform(0, 1, (m, 2)))
    return X, Y


@pytest.mark.parametrize("kname", list(KERNELS))
@pytest.mark.parametrize(
    "ox,oy", list(itertools.combinations_with_replacement(OPS, 2))
)
def test_closed_form_matches_ad(kname, ox, oy):
    kernel = KERNELS[kname]
    X, Y = _points(7, 5)
    closed = kernel.pair_fn(OPS[ox], OPS[oy])(X, Y)
    ad = ad_pair_fn(kernel.kappa, OPS[ox], OPS[oy])(X, Y)
    scale = max(1.0, float(jnp.max(jnp.abs(ad))))
    np.testing.assert_allclose(
        np.asarray(closed), np.asarray(ad), rtol=0, atol=1e-9 * scale
    )


def test_fourth_order_bilaplacian():
    """Delta_x Delta_y kappa - the hardest block (4th-order, upstream
    src/kernels.py:76-80)."""
    kernel = SquaredExponential.gaussian(0.2)
    X, Y = _points(6, 6, seed=1)
    closed = kernel.pair_fn(laplacian(), laplacian())(X, Y)
    ad = ad_pair_fn(kernel.kappa, laplacian(), laplacian())(X, Y)
    scale = float(jnp.max(jnp.abs(ad)))
    np.testing.assert_allclose(
        np.asarray(closed), np.asarray(ad), rtol=0, atol=1e-9 * scale
    )


def test_known_closed_form_values():
    """Spot-check against hand-derived formulas for the isotropic Gaussian:
    Delta_x kappa = (r^2/s^2 - 2/s) g with s = sigma^2 (d=2)."""
    sigma = 0.3
    s = sigma**2
    kernel = SquaredExponential.gaussian(sigma)
    X, Y = _points(4, 4, seed=2)
    u = np.asarray(X)[:, None, :] - np.asarray(Y)[None, :, :]
    r2 = (u**2).sum(-1)
    g = np.exp(-r2 / (2 * s))
    expected = (r2 / s**2 - 2.0 / s) * g
    got = np.asarray(kernel.pair_fn(laplacian(), identity())(X, Y))
    np.testing.assert_allclose(got, expected, rtol=1e-12)
    # bi-Laplacian: (r^4/s^4 - 8 r^2/s^3 + 8/s^2) g
    expected2 = (r2**2 / s**4 - 8 * r2 / s**3 + 8 / s**2) * g
    got2 = np.asarray(kernel.pair_fn(laplacian(), laplacian())(X, Y))
    np.testing.assert_allclose(got2, expected2, rtol=1e-11)


def test_xy_symmetry():
    """block(op_i, op_j)(X, Y).T == block(op_j, op_i)(Y, X)."""
    kernel = KERNELS["aniso_len"]
    X, Y = _points(5, 8, seed=3)
    a = kernel.pair_fn(laplacian(), d(1))(X, Y)
    b = kernel.pair_fn(d(1), laplacian())(Y, X)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b).T, rtol=1e-12)


def test_operator_algebra():
    lap = laplacian()
    assert lap.order == 2 and not lap.is_identity
    assert identity().is_identity
    combo = 2.0 * d(0) - d(0)
    assert combo.terms == ((1.0, (1, 0)),)
    comp = d(0).compose(d(0))
    assert comp.terms == d2(0, 0).terms
    zero = d(1) - d(1)
    assert zero.terms == ()


def test_exp_neg_accurate_f32():
    """Cody-Waite exp must be ~1-2 ulp in f32 over the kernel's q range
    (a tens-of-ulp hardware exp breaks Gram PSD-ness)."""
    from nonlinpdes_gpsolver.ops.kernels import exp_neg_accurate

    q = jnp.asarray(np.linspace(0.0, 60.0, 20001), dtype=jnp.float32)
    got = np.asarray(exp_neg_accurate(q)).astype(np.float64)
    ref = np.exp(-np.asarray(q).astype(np.float64))
    rel = np.abs(got - ref) / np.maximum(ref, 1e-300)
    assert rel.max() < 5e-7, rel.max()
    # f64 path defers to jnp.exp exactly
    q64 = jnp.asarray([0.3, 2.0, 10.0], dtype=jnp.float64)
    np.testing.assert_array_equal(
        np.asarray(exp_neg_accurate(q64)), np.asarray(jnp.exp(-q64))
    )
