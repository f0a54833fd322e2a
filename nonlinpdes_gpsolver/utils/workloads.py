"""The four upstream CLI workloads as data, shared by the drivers.

Configurations follow the reference's README commands (``README.md:15-21``
upstream): elliptic 900/124 GN4, Burgers 1000/200 GN8 (anisotropic
[0.3, 0.05]), Eikonal 1000/200 GN8 (eps=0.1), Darcy inverse 400/100
N_data=60 GN8. Ground truths follow the reference drivers: manufactured
elliptic solution, Cole-Hopf quadrature for Burgers, Cole-Hopf FD for
Eikonal, FD Darcy solve + noisy interpolated observations for the inverse
problem. Sizes are arguments, so the same builders drive the single-card
sizes past the reference's ~10k-point dense wall.

``make()`` builds the problem afresh (a timed end-to-end run includes
problem construction); ``truth`` is ``u`` at ``X_test``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import models
from ..models.spec import CollocationProblem
from ..ops.kernels import SquaredExponential
from .classical import burgers_cole_hopf_truth, darcy_fd_solve, eikonal_cole_hopf_solve
from .sampling import sample_random, test_grid


@dataclasses.dataclass
class Workload:
    name: str
    make: Callable[[], CollocationProblem]
    nugget: float
    max_iter: int
    X_test: jnp.ndarray
    truth: np.ndarray
    block: Optional[str] = None  # posterior block to extend (Darcy: 'u')
    a_truth: Optional[np.ndarray] = None  # Darcy coefficient at X_test


def u_elliptic(x):
    return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1]) + 2 * jnp.sin(
        4 * jnp.pi * x[0]
    ) * jnp.sin(4 * jnp.pi * x[1])


def _rhs_elliptic(x):
    return -jnp.trace(jax.hessian(u_elliptic)(x)) + u_elliptic(x) ** 3


def elliptic(N: int = 900, Nb: int = 124, key: int = 0, nugget: float = 1e-5,
             max_iter: int = 4, dtype=None) -> Workload:
    """``dtype`` casts the points (the problem then runs in that dtype)."""
    Xd, Xb = sample_random(jax.random.PRNGKey(key), N, Nb)
    Xd, Xb = jnp.asarray(Xd, dtype), jnp.asarray(Xb, dtype)
    Xt = jnp.asarray(test_grid(60, 60), dtype)
    k = SquaredExponential.gaussian(0.2)
    return Workload(
        f"elliptic {N}/{Nb} GN{max_iter}",
        lambda: models.nonlinear_elliptic(k, Xd, Xb, _rhs_elliptic, u_elliptic, seed=1),
        nugget, max_iter, Xt, np.asarray(jax.vmap(u_elliptic)(Xt)),
    )


def burgers() -> Workload:
    domain = ((0.0, 1.0), (-1.0, 1.0))
    k = SquaredExponential.anisotropic([0.3, 0.05])
    Xd, Xb = sample_random(
        jax.random.PRNGKey(0), 1000, 200, domain=domain, time_dependent=True
    )

    def g(x):
        return jnp.where(x[0] == 0.0, -jnp.sin(jnp.pi * x[1]), 0.0)

    Xt = test_grid(60, 60, domain=domain)
    truth = burgers_cole_hopf_truth(0.02)(np.asarray(Xt[:, 0]), np.asarray(Xt[:, 1]))
    return Workload(
        "burgers 1000/200 GN8",
        lambda: models.burgers(k, Xd, Xb, g, nu=0.02, seed=3),
        1e-5, 8, Xt, np.asarray(truth),
    )


def eikonal() -> Workload:
    k = SquaredExponential.gaussian(0.2)
    Xd, Xb = sample_random(jax.random.PRNGKey(1), 1000, 200)
    X1, X2, U = eikonal_cole_hopf_solve(58, 0.1)
    Xt = jnp.asarray(np.stack([X1.ravel(), X2.ravel()], axis=1))
    return Workload(
        "eikonal 1000/200 GN8",
        lambda: models.eikonal(k, Xd, Xb, rhs_f=lambda x: 1.0, eps=0.1),
        1e-5, 8, Xt, U.ravel(),
    )


def darcy(N: int = 400, Nb: int = 100, N_data: int = 60,
          noise: float = 1e-3) -> Workload:
    from scipy.interpolate import RegularGridInterpolator

    def a_true(x1, x2):
        s = np.sin(2 * np.pi * x1) + np.sin(2 * np.pi * x2)
        return np.exp(s) + np.exp(-s)

    xs, ys, Ud = darcy_fd_solve(78, a_true, lambda x1, x2: np.ones_like(x1))
    interp = RegularGridInterpolator((ys, xs), Ud)
    Xd, Xb = sample_random(jax.random.PRNGKey(5), N, Nb)
    Xdata = np.asarray(Xd[:N_data])
    clean = interp(np.stack([Xdata[:, 1], Xdata[:, 0]], axis=1))
    noisy = jnp.asarray(
        clean + noise * np.random.default_rng(9999).standard_normal(N_data)
    )
    X1, X2 = np.meshgrid(xs, ys)
    Xt = jnp.asarray(np.stack([X1.ravel(), X2.ravel()], axis=1))
    k = SquaredExponential.gaussian(0.2)
    return Workload(
        f"darcy-IP {N}/{Nb}/{N_data} GN8",
        lambda: models.darcy_flow(
            k, k, Xd, Xb, noisy, rhs_f=lambda x: 1.0, noise_level=noise, seed=7,
        ),
        1e-8, 8, Xt, Ud.ravel(), block="u", a_truth=a_true(X1, X2).ravel(),
    )
