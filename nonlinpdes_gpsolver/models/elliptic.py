"""Nonlinear elliptic equation ``-Delta u + alpha * u^m = f`` (Dirichlet BC).

Capability match for upstream ``Nonlinear_elliptic2d`` (``src/PDEs.py:18-208``):

* observed functionals: ``[Delta u @ interior, u @ interior, u @ boundary]``;
* latent ``z`` = interior nodal values of ``u`` (``N_domain``); the Laplacian
  block is eliminated through the PDE, ``Delta u = alpha u^m - f``;
* "relaxed" (penalty) variant keeps both ``(v, w) ~ (Delta u, u)`` latent and
  penalizes the PDE residual with weight ``1/pen_lambda`` instead of
  eliminating it (upstream ``src/PDEs.py:137-201``).

Unlike the reference, both variants are pure data (:class:`CollocationProblem`)
consumed by the generic whitened-GN engine - no hand-written linearization.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..ops.assembly import Observable
from ..ops.kernels import SquaredExponential
from ..ops.operators import identity, laplacian
from .spec import CollocationProblem, GPBlock, Misfit


_VMAP_CACHE: dict = {}


def _eval_key(fn: Callable):
    """Semantic cache key for a user data callable: code object + defaults +
    closure cell VALUES + referenced global VALUES. Two lambdas created by
    re-executing the same source line (e.g. ``rhs_f=lambda x: 1.0`` inside a
    per-solve function) are distinct objects but share code and environment -
    an identity-keyed cache would re-trace AND re-compile per solve (trivial
    compiles fall below the persistent-cache threshold, so each miss costs
    a fresh compile; measured as a per-solve regression on the eikonal
    benchmark).

    The key must cover every value the function can read: a closure-free
    callable reading a module-level variable that is later REBOUND (re-run
    notebook cell, mutated config global) would otherwise hit the cache and
    silently evaluate with the stale traced value. ``co_names`` is walked
    through nested code objects too (a lambda returned by a factory reads
    its globals through an inner code object absent from the outer
    ``co_names``). Unhashable VALUES (arrays, lists) are keyed by a stable
    identity token ``(id, type)`` plus shape/dtype for arrays - rebinding
    the global to a new object changes ``id`` and misses the cache, while a
    repeatedly-built same-config function still hits it (round-4 ADVICE
    item 4: falling back to identity-keying the whole function
    reintroduced the per-solve retrace the cache exists to avoid). An
    in-place MUTATION of the same array object is the one case the token
    cannot see - the same caveat jit's own weak-reference caching has."""

    def _code_names(code, seen=None):
        if seen is None:
            seen = set()
        names = set(code.co_names)
        for const in code.co_consts:
            if hasattr(const, "co_names") and id(const) not in seen:
                seen.add(id(const))
                names |= _code_names(const, seen)
        return names

    def _token(v):
        try:
            hash(v)
            return v
        except TypeError:
            shape = getattr(v, "shape", None)
            dtype = getattr(v, "dtype", None)
            return ("#unhashable", id(v), type(v).__name__, str(shape),
                    str(dtype))

    try:
        cells = tuple(
            _token(c.cell_contents) for c in (fn.__closure__ or ())
        )
        gl = fn.__globals__
        gvals = tuple(
            (name, _token(gl[name]))
            for name in sorted(_code_names(fn.__code__))
            if name in gl
        )
        defaults = tuple(_token(d) for d in (fn.__defaults__ or ()))
        key = (fn.__code__, defaults, cells, gvals)
        hash(key)
        return key
    except Exception:
        return fn


def _vmapped_jit(fn: Callable):
    """One jitted vmap per (semantically distinct) user function: an eager
    ``jax.vmap`` executes op-by-op (hundreds of tiny dispatches for an
    autodiff-derived rhs, which can dwarf the solve itself); under ``jit``
    it is one launch, cached across problem rebuilds."""
    key = _eval_key(fn)
    g = _VMAP_CACHE.get(key)
    if g is None:
        g = jax.jit(jax.vmap(fn))
        _VMAP_CACHE[key] = g
    return g


def _eval_on(fn: Optional[Callable], X: jnp.ndarray) -> jnp.ndarray:
    if fn is None:
        return jnp.zeros(X.shape[0], dtype=X.dtype)
    return _vmapped_jit(fn)(X)


@lru_cache(maxsize=None)
def _elliptic_residual(alpha: float, m: int):
    """Cached so equal configs share one function object - keeps the
    compiled Gauss-Newton scan's jit cache hot across problem rebuilds."""

    def residual(z, data):
        # [Delta u; u_int; u_bd] with Delta u eliminated via the PDE
        return jnp.concatenate([alpha * z**m - data["f"], z, data["g"]])

    return residual


@lru_cache(maxsize=None)
def _elliptic_relaxed_residuals(alpha: float, m: int, N_d: int):
    def residual(z, data):
        return jnp.concatenate([z, data["g"]])  # [v; w; g] - linear in z

    def pde_penalty(z, data):
        v, w = z[:N_d], z[N_d:]
        return -v + alpha * w**m - data["f"]

    return residual, pde_penalty


def nonlinear_elliptic(
    kernel: SquaredExponential,
    X_domain: jnp.ndarray,
    X_boundary: jnp.ndarray,
    rhs_f: Callable | jnp.ndarray | None,
    bdy_g: Callable | jnp.ndarray | None,
    alpha: float = 1.0,
    m: int = 3,
    init: str = "random",
    seed: int = 0,
) -> CollocationProblem:
    """Elimination form: latent z = u at interior points."""
    X_domain = jnp.asarray(X_domain)
    X_boundary = jnp.asarray(X_boundary)
    N_d = X_domain.shape[0]
    f_vals = rhs_f if isinstance(rhs_f, jnp.ndarray) else _eval_on(rhs_f, X_domain)
    g_vals = bdy_g if isinstance(bdy_g, jnp.ndarray) else _eval_on(bdy_g, X_boundary)
    data = {"f": f_vals, "g": g_vals}

    residual = _elliptic_residual(float(alpha), int(m))

    observables = (
        Observable("domain", laplacian()),
        Observable("domain", identity()),
        Observable("boundary", identity()),
    )

    def latent_init():
        if init == "zero":
            return jnp.zeros(N_d)
        return jax.random.normal(jax.random.PRNGKey(seed), (N_d,))

    return CollocationProblem(
        name="nonlinear_elliptic",
        blocks=(GPBlock("u", kernel, observables, residual),),
        points={"domain": X_domain, "boundary": X_boundary},
        data=data,
        latent_dim=N_d,
        latent_init=latent_init,
    )


def nonlinear_elliptic_relaxed(
    kernel: SquaredExponential,
    X_domain: jnp.ndarray,
    X_boundary: jnp.ndarray,
    rhs_f: Callable | jnp.ndarray | None,
    bdy_g: Callable | jnp.ndarray | None,
    alpha: float = 1.0,
    m: int = 3,
    pen_lambda: float = 1e-10,
    init: str = "random",
    seed: int = 0,
) -> CollocationProblem:
    """Penalty form: latent z = (v, w) ~ (Delta u, u) at interior points.

    Loss: ``||L^{-1}[v; w; g]||^2 + (1/pen_lambda)||-v + alpha w^m - f||^2``
    (upstream ``loss_relaxed``, ``src/PDEs.py:138-147``).
    """
    X_domain = jnp.asarray(X_domain)
    X_boundary = jnp.asarray(X_boundary)
    N_d = X_domain.shape[0]
    f_vals = rhs_f if isinstance(rhs_f, jnp.ndarray) else _eval_on(rhs_f, X_domain)
    g_vals = bdy_g if isinstance(bdy_g, jnp.ndarray) else _eval_on(bdy_g, X_boundary)
    data = {"f": f_vals, "g": g_vals}

    residual, pde_penalty = _elliptic_relaxed_residuals(
        float(alpha), int(m), N_d
    )

    observables = (
        Observable("domain", laplacian()),
        Observable("domain", identity()),
        Observable("boundary", identity()),
    )

    def latent_init():
        if init == "zero":
            return jnp.zeros(2 * N_d)
        return jax.random.normal(jax.random.PRNGKey(seed), (2 * N_d,))

    return CollocationProblem(
        name="nonlinear_elliptic_relaxed",
        blocks=(GPBlock("u", kernel, observables, residual),),
        points={"domain": X_domain, "boundary": X_boundary},
        data=data,
        latent_dim=2 * N_d,
        misfits=(Misfit("pde", pde_penalty, 1.0 / pen_lambda),),
        latent_init=latent_init,
    )
