"""Kernel families and the derivative-kernel compiler.

The reference implementation enumerates ~19 derivative combinations of the
Gaussian kernel by nesting ``jax.grad`` (upstream ``src/kernels.py:8-179``)
and evaluates them with a scalar ``vmap`` over N^2 flattened coordinate
pairs.  That wastes both compute (re-deriving the same exponential
per block, scalar-style code) and memory (N^2 coordinate materialization in
the caller).

Here every derivative block of a *separable squared-exponential* kernel

    kappa(x, y) = prod_k exp(-a_k (x_k - y_k)^2)

is compiled to a closed form ``P(u) * kappa(u)`` with ``u = x - y`` and ``P``
a polynomial obtained from the Hermite-style recurrence

    p_0 = 1,      p_{n+1}(u) = p_n'(u) - 2 a u p_n(u),

since ``d_u^n exp(-a u^2) = p_n(u) exp(-a u^2)``.  Derivatives w.r.t. ``x``
are ``+d_u`` and w.r.t. ``y`` are ``-d_u``, so a Gram block for the operator
pair ``(L_x, L_y)`` reduces to a single fused polynomial-times-exponential
evaluated on coordinate difference panels - one elementwise pass per block
that XLA fuses into a single loop over the output, no autodiff at trace
time.

An autodiff fallback (:func:`ad_pair_fn`) covers arbitrary kernels and is
used by the test-suite to validate the closed forms to machine precision.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Callable, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .operators import LinearOp


# --------------------------------------------------------------------------
# Hermite-style derivative polynomials for exp(-a u^2)
# --------------------------------------------------------------------------
def _derivative_poly_coeffs(n: int, a: float) -> np.ndarray:
    """Coefficients (ascending powers) of p_n with d^n/du^n e^{-a u^2} = p_n e^{-a u^2}."""
    c = np.zeros(n + 1, dtype=np.float64)
    c[0] = 1.0
    cur = c[: 1]
    for _ in range(n):
        nxt = np.zeros(cur.size + 1, dtype=np.float64)
        # derivative of the polynomial part
        for i in range(1, cur.size):
            nxt[i - 1] += i * cur[i]
        # -2 a u * p
        nxt[1:] += -2.0 * a * cur
        cur = nxt
    out = np.zeros(n + 1, dtype=np.float64)
    out[: cur.size] = cur
    return out


def _polyval(coeffs: np.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Horner evaluation with static float64 coefficients."""
    acc = jnp.full(u.shape, float(coeffs[-1]), dtype=u.dtype)
    for c in coeffs[-2::-1]:
        acc = acc * u + float(c)
    return acc


# Cody-Waite split of ln2: LN2_HI has ~12 trailing zero bits, so k * LN2_HI
# is exact in f32 for the k range the SE kernel produces (q <~ 90 before
# underflow), making the argument reduction error-free to f32 working
# precision.
_LN2_HI = np.float32(0.693359375)
_LN2_LO = np.float32(-2.12194440e-4)
_INV_LN2 = np.float32(1.4426950408889634)


def exp_neg_accurate(q: jnp.ndarray) -> jnp.ndarray:
    """Accurately-rounded ``exp(-q)`` for ``q >= 0`` in f32.

    A hardware ``exp`` that is a fast approximation (tens of ulps, as on the
    platform this solver was first built for) perturbs assembled Gram
    matrices enough to push their smallest eigenvalues negative past the
    nugget. This routine guarantees ~1-2 ulp accuracy with elementwise ops
    on any backend: Cody-Waite reduction
    ``q = k ln2 + t``, degree-7 Taylor on ``e^{-t}`` (|t| <= ln2/2, series
    error 5e-9), and ``2^{-k}`` assembled directly in the exponent bits.

    In f64 (CPU reference runs) it simply defers to ``jnp.exp``.
    """
    if q.dtype != jnp.float32:
        return jnp.exp(-q)
    k = jnp.round(q * _INV_LN2)
    t = (q - k * _LN2_HI) - k * _LN2_LO  # |t| <= ln2/2, computed exactly
    # e^{-t} by Horner on the alternating Taylor series through t^7/7!
    p = jnp.float32(-1.0 / 5040.0)
    for c in (1.0 / 720.0, -1.0 / 120.0, 1.0 / 24.0, -1.0 / 6.0, 0.5, -1.0, 1.0):
        p = p * t + jnp.float32(c)
    # 2^{-k}: clamp to the normal range and build the float from its bits
    k = jnp.clip(k, -126.0, 126.0)
    pow2 = jax.lax.bitcast_convert_type(
        ((127 - k.astype(jnp.int32)) << 23).astype(jnp.int32), jnp.float32
    )
    return p * pow2


# --------------------------------------------------------------------------
# Kernel family
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SquaredExponential:
    """Separable SE kernel ``prod_k exp(-a_k (x_k - y_k)^2)``.

    ``inv_sq`` holds the per-dimension coefficients ``a_k`` (static Python
    floats: they come from solver config, so baking them into compiled
    closed forms is both legal and fastest).

    Parameterizations (matching upstream conventions):
      * :meth:`gaussian` - isotropic RBF with lengthscale ``sigma``
        (``a_k = 1/(2 sigma^2)``, upstream ``src/kernels.py:12-13``).
      * :meth:`anisotropic` with ``convention='lengthscale'`` -
        ``a_k = 1/s_k^2`` (upstream ``src/kernels.py:94-99``), or
        ``convention='precision'`` - ``a_k = s_k^2`` (the multiplicative
        convention used in the upstream Burgers notebook).
    """

    inv_sq: Tuple[float, ...]

    @property
    def dim(self) -> int:
        return len(self.inv_sq)

    @classmethod
    def gaussian(cls, sigma: float, dim: int = 2) -> "SquaredExponential":
        a = 1.0 / (2.0 * float(sigma) ** 2)
        return cls(tuple([a] * dim))

    @classmethod
    def anisotropic(
        cls, scales: Sequence[float], convention: str = "lengthscale"
    ) -> "SquaredExponential":
        if convention == "lengthscale":
            return cls(tuple(1.0 / float(s) ** 2 for s in scales))
        if convention == "precision":
            return cls(tuple(float(s) ** 2 for s in scales))
        raise ValueError(f"unknown convention {convention!r}")

    # ---- scalar form (for the AD fallback / tests) ----------------------
    def kappa(self, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        u = x - y
        a = jnp.asarray(self.inv_sq, dtype=u.dtype)
        return jnp.exp(-jnp.sum(a * u * u, axis=-1))

    # ---- compiled pair blocks -------------------------------------------
    def pair_fn(
        self, op_x: LinearOp, op_y: LinearOp
    ) -> Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]:
        """Return ``block(X, Y) -> (N, M)`` evaluating ``(op_x (x) op_y) kappa``.

        ``X: (N, dim)`` carries the x-side (row) points, ``Y: (M, dim)`` the
        y-side (column) points.  Closed form: for each pair of terms
        ``(c_x, alpha_x)``, ``(c_y, alpha_y)`` the contribution is
        ``c_x c_y (-1)^{|alpha_y|} prod_k p_{alpha_xk + alpha_yk}(u_k) * g``.
        """
        return _compiled_pair_fn(self.inv_sq, op_x.terms, op_y.terms)


@lru_cache(maxsize=None)
def _compiled_pair_fn(inv_sq, terms_x, terms_y):
    dim = len(inv_sq)
    # Combine term pairs, dedup by total per-dim derivative order.
    combined: dict[Tuple[int, ...], float] = {}
    for cx, ax in terms_x:
        for cy, ay in terms_y:
            sign = -1.0 if (sum(ay) % 2) else 1.0
            beta = tuple(i + j for i, j in zip(ax, ay))
            combined[beta] = combined.get(beta, 0.0) + cx * cy * sign
    # Pre-build polynomial coefficient tables (static numpy float64).
    polys = {
        beta: tuple(
            _derivative_poly_coeffs(b, inv_sq[k]) if b > 0 else None
            for k, b in enumerate(beta)
        )
        for beta in combined
    }

    def block(X: jnp.ndarray, Y: jnp.ndarray) -> jnp.ndarray:
        u = X[:, None, :] - Y[None, :, :]
        q = sum(inv_sq[k] * u[..., k] * u[..., k] for k in range(dim))
        g = exp_neg_accurate(q)
        total = jnp.zeros(u.shape[:2], dtype=u.dtype)
        for beta, coef in combined.items():
            if coef == 0.0:
                continue
            term = jnp.full(u.shape[:2], coef, dtype=u.dtype)
            for k, coeffs in enumerate(polys[beta]):
                if coeffs is not None:
                    term = term * _polyval(coeffs, u[..., k])
            total = total + term
        return total * g

    return block


# --------------------------------------------------------------------------
# Autodiff fallback: works for any scalar kernel kappa(x, y)
# --------------------------------------------------------------------------
def ad_pair_fn(
    kappa: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray],
    op_x: LinearOp,
    op_y: LinearOp,
) -> Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray]:
    """Derivative block via nested ``jax.grad`` (reference semantics).

    Mirrors the mathematical content of upstream ``src/kernels.py`` (grad
    compositions of a scalar kernel) but for arbitrary operator pairs and
    dimensions.  Used to validate the compiled closed forms and as a
    fallback for kernel families without a derivative compiler.
    """

    def one_pair(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
        total = 0.0
        for cx, ax in op_x.terms:
            for cy, ay in op_y.terms:
                f = lambda xx, yy: kappa(xx, yy)
                # apply d^ax to x-side, d^ay to y-side, one axis at a time
                for k, n in enumerate(ax):
                    for _ in range(n):
                        f = _grad_component(f, 0, k)
                for k, n in enumerate(ay):
                    for _ in range(n):
                        f = _grad_component(f, 1, k)
                total = total + cx * cy * f(x, y)
        return total

    def block(X: jnp.ndarray, Y: jnp.ndarray) -> jnp.ndarray:
        inner = jax.vmap(one_pair, in_axes=(None, 0))
        return jax.vmap(inner, in_axes=(0, None))(X, Y)

    return block


def _grad_component(f, argnum: int, axis: int):
    def g(x, y):
        if argnum == 0:
            return jax.grad(lambda xx: f(xx, y))(x)[axis]
        return jax.grad(lambda yy: f(x, yy))(y)[axis]

    return g
