"""End-to-end accuracy acceptance suite.

The reference has no automated tests; its de-facto acceptance is the four
driver configurations plus notebook-recorded accuracies (SURVEY.md sections
4 and 6, BASELINE.md). These tests run the same four workloads through this
framework and assert accuracy at-or-better than the recorded numbers.

Sizes are trimmed vs. the CLI configs where the full run would dominate suite
wall-clock on the 2-core CI host; thresholds are set accordingly (each
verified against a full-size manual run, see commit history).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.interpolate import RegularGridInterpolator

import nonlinpdes_gpsolver as gpt
from nonlinpdes_gpsolver.utils.classical import (
    burgers_cole_hopf_truth,
    darcy_fd_solve,
    eikonal_cole_hopf_solve,
)


def _u_elliptic(x):
    return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1]) + 2 * jnp.sin(
        4 * jnp.pi * x[0]
    ) * jnp.sin(4 * jnp.pi * x[1])


def test_nonlinear_elliptic_beats_baseline():
    """Reference CPU run at this config: test L2 5.4e-7 (N=900); notebook
    baseline 3.4e-3. At N=600 we require <1e-4."""
    alpha, m = 1.0, 3

    def rhs_f(x):
        hess_diag = jnp.diag(jax.hessian(_u_elliptic)(x))
        return -jnp.sum(hess_diag) + alpha * _u_elliptic(x) ** m

    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(42), 600, 100)
    k = gpt.SquaredExponential.gaussian(0.2)
    prob = gpt.models.nonlinear_elliptic(
        k, Xd, Xb, rhs_f, _u_elliptic, alpha=alpha, m=m, seed=1
    )
    res = gpt.GPSolver(prob, nugget=1e-13).solve(max_iter=4)
    Xt = gpt.utils.test_grid(40, 40)
    err = gpt.GPSolver.errors(res.posterior.extend(Xt), jax.vmap(_u_elliptic)(Xt))
    assert err.l2 < 1e-4, err
    # collocation error too (reference prints both)
    errc = gpt.GPSolver.errors(res.z, jax.vmap(_u_elliptic)(Xd))
    assert errc.l2 < 1e-4, errc


def test_nonlinear_elliptic_relaxed_converges():
    """Penalty formulation (reference src/PDEs.py:137-201): same PDE, latent
    (v, w), PDE enforced by penalty. Coarser accuracy expected."""
    alpha, m = 1.0, 3

    def rhs_f(x):
        hess_diag = jnp.diag(jax.hessian(_u_elliptic)(x))
        return -jnp.sum(hess_diag) + alpha * _u_elliptic(x) ** m

    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(3), 400, 80)
    k = gpt.SquaredExponential.gaussian(0.2)
    prob = gpt.models.nonlinear_elliptic_relaxed(
        k, Xd, Xb, rhs_f, _u_elliptic, alpha=alpha, m=m, pen_lambda=1e-10, seed=2
    )
    res = gpt.GPSolver(prob, nugget=1e-12).solve(max_iter=6)
    Xt = gpt.utils.test_grid(30, 30)
    err = gpt.GPSolver.errors(res.posterior.extend(Xt), jax.vmap(_u_elliptic)(Xt))
    assert err.l2 < 5e-3, err


def test_burgers_matches_baseline():
    """Reference notebook: space-time L2 4.0e-3 (1200 pts, 12 iters). At the
    CLI config (1000+200 pts, lengthscales [0.3, 0.05], 8 iters) this
    framework measures 7.08e-3 on this seed (sample spread is ~2x either
    way, see PERF.md "Burgers accuracy parity"); require <8e-3. The
    notebook-config baseline itself is gated at 4.009e-3 by the slow suite
    (test_acceptance_full.test_burgers_notebook_config)."""
    nu = 0.02
    k = gpt.SquaredExponential.anisotropic([0.3, 0.05])
    Xd, Xb = gpt.utils.sample_random(
        jax.random.PRNGKey(0), 1000, 200,
        domain=((0.0, 1.0), (-1.0, 1.0)), time_dependent=True,
    )

    def g(x):
        return jnp.where(x[0] == 0.0, -jnp.sin(jnp.pi * x[1]), 0.0)

    prob = gpt.models.burgers(k, Xd, Xb, g, nu=nu, seed=3)
    res = gpt.GPSolver(prob, nugget=1e-5).solve(max_iter=8)
    u_truth = burgers_cole_hopf_truth(nu)
    Xt = gpt.utils.test_grid(60, 60, domain=((0.0, 1.0), (-1.0, 1.0)))
    truth = u_truth(np.asarray(Xt[:, 0]), np.asarray(Xt[:, 1]))
    err = gpt.GPSolver.errors(res.posterior.extend(Xt), truth)
    assert err.l2 < 8e-3, err
    assert res.losses[-1] < res.losses[0] * 1e-3


def test_eikonal_beats_baseline():
    """Reference notebook: test L2 2.5e-2 (eps=1e-2, 484 pts). We run
    eps=0.1 (the CLI default) against the Cole-Hopf FD truth and require
    <5e-3 at 400 pts."""
    eps = 0.1
    k = gpt.SquaredExponential.gaussian(0.2)
    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(1), 400, 96)
    prob = gpt.models.eikonal(k, Xd, Xb, rhs_f=lambda x: 1.0, eps=eps)
    res = gpt.GPSolver(prob, nugget=1e-5).solve(max_iter=8)
    X1, X2, U = eikonal_cole_hopf_solve(40, eps)
    Xt = jnp.asarray(np.stack([X1.ravel(), X2.ravel()], axis=1))
    err = gpt.GPSolver.errors(res.posterior.extend(Xt), U.ravel())
    assert err.l2 < 5e-3, err


def test_darcy_inverse_recovers_state_and_coefficient():
    """Reference prints no numeric inverse-problem error (contour panels
    only). Running the reference itself at this exact config (CPU, f64,
    seed 9999) measures: u L2 5.0e-4 / a L2 0.59 (relative ~20%; a ranges
    up to ~7.5 so pointwise identifiability away from data is weak). We
    assert: u to <5e-3 L2, a to <45% relative L2 (covers seed variance)."""

    def a_true(x1, x2):
        s = np.sin(2 * np.pi * x1) + np.sin(2 * np.pi * x2)
        return np.exp(s) + np.exp(-s)

    xs, ys, U = darcy_fd_solve(78, a_true, lambda x1, x2: np.ones_like(x1))
    interp = RegularGridInterpolator((ys, xs), U)

    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(5), 400, 100)
    N_data = 60
    Xdata = np.asarray(Xd[:N_data])
    clean = interp(np.stack([Xdata[:, 1], Xdata[:, 0]], axis=1))
    rng = np.random.default_rng(9999)
    noisy = clean + 1e-3 * rng.standard_normal(N_data)

    k = gpt.SquaredExponential.gaussian(0.2)
    prob = gpt.models.darcy_flow(
        k, k, Xd, Xb, jnp.asarray(noisy),
        rhs_f=lambda x: 1.0, noise_level=1e-3, seed=7,
    )
    res = gpt.GPSolver(prob, nugget=1e-8).solve(max_iter=8)
    X1, X2 = np.meshgrid(xs, ys)
    Xt = jnp.asarray(np.stack([X1.ravel(), X2.ravel()], axis=1))
    err_u = gpt.GPSolver.errors(res.posterior.extend(Xt, block="u"), U.ravel())
    assert err_u.l2 < 5e-3, err_u
    a_vals = a_true(X1, X2).ravel()
    pred_a = np.exp(np.asarray(res.posterior.extend(Xt, block="a")))
    rel_l2 = np.sqrt(np.mean((pred_a - a_vals) ** 2)) / np.sqrt(np.mean(a_vals**2))
    assert rel_l2 < 0.45, rel_l2


def test_eikonal_eps1e2_notebook_baseline():
    """The notebook-recorded baseline config (eps=1e-2, sigma=0.2,
    nugget=1e-6, 484 pts, 10 GN iters, zero init): recorded L2 2.506e-2 /
    max 6.38e-2 against a Cole-Hopf FD truth on a 100-per-dim grid. This
    framework measures 2.27e-2 / 5.4e-2 - require at least baseline."""
    eps = 1e-2
    k = gpt.SquaredExponential.gaussian(0.2)
    Xd, Xb = gpt.utils.sample_random(jax.random.PRNGKey(2), 400, 84)
    prob = gpt.models.eikonal(k, Xd, Xb, rhs_f=lambda x: 1.0, eps=eps)
    res = gpt.GPSolver(prob, nugget=1e-6).solve(max_iter=10)
    X1, X2, U = eikonal_cole_hopf_solve(100, eps)
    Xt = jnp.asarray(np.stack([X1.ravel(), X2.ravel()], axis=1))
    err = gpt.GPSolver.errors(res.posterior.extend(Xt), U.ravel())
    assert err.l2 < 2.506e-2, err
    assert err.max < 6.38e-2, err
