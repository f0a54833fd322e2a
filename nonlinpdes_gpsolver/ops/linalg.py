"""Dense linear-algebra substrate: guarded Cholesky and triangular solves.

The reference wraps ``jnp.linalg.cholesky`` in a dead ``try/except``
(``src/PDEs.py:75-80`` upstream — XLA never raises, it yields NaNs) and uses
general LU ``jnp.linalg.solve`` on triangular factors (``src/PDEs.py:86,118,205``).
Here:

* :func:`cholesky_with_retry` detects NaN factorizations on the host and
  escalates the nugget geometrically (setup-time only; the factor itself is
  one XLA call);
* triangular systems use ``jax.scipy.linalg.solve_triangular`` (TRSM), which
  XLA maps to the blocked triangular-solve path instead of a general LU;
* :func:`whiten` is the ``L^{-1} v`` operation used throughout the
  Gauss-Newton loop and the posterior.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular


def cholesky(theta: jnp.ndarray) -> jnp.ndarray:
    """Lower-triangular Cholesky factor (XLA native)."""
    return jnp.linalg.cholesky(theta)


def cholesky_with_retry(
    theta: jnp.ndarray,
    nugget_diag: jnp.ndarray,
    max_retries: int = 6,
    escalation: float = 10.0,
) -> Tuple[jnp.ndarray, float]:
    """Factor ``theta + s * diag(nugget_diag)``, escalating ``s`` until finite.

    Returns ``(L, s)`` where ``s`` is the nugget scale that succeeded
    (1.0 when the requested nugget was already enough). Host-side retry
    loop: runs at setup time, so eager dispatch is fine and lets us report
    the escalation to the user instead of silently propagating NaNs.
    """
    s = 1.0
    for _ in range(max_retries):
        L = jnp.linalg.cholesky(theta + s * jnp.diag(nugget_diag))
        if bool(jnp.all(jnp.isfinite(L))):
            return L, s
        s *= escalation
    raise FloatingPointError(
        f"Cholesky failed after {max_retries} nugget escalations "
        f"(final scale {s / escalation:g}); Gram matrix is numerically "
        "indefinite - increase the nugget or the kernel lengthscale."
    )


def whiten(L: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """``L^{-1} v`` via forward substitution (v may be a matrix of columns)."""
    return solve_triangular(L, v, lower=True)


def tri_inverse(L: jnp.ndarray) -> jnp.ndarray:
    """Explicit ``L^{-1}`` (lower triangular).

    Repeated triangular solves against many right-hand sides are
    sequential substitution, while a one-time inverse turns every
    subsequent whitening into a plain matmul. Used by the
    ``solve_mode='inverse'`` path of :func:`..solvers.gn.factorize`.
    """
    eye = jnp.eye(L.shape[0], dtype=L.dtype)
    return solve_triangular(L, eye, lower=True)


def kernel_solve(L: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """``Theta^{-1} v = L^{-T} L^{-1} v`` via two triangular solves."""
    return solve_triangular(L, solve_triangular(L, v, lower=True), lower=True, trans=1)


def _pad_spd(M: jnp.ndarray, block: int):
    n = M.shape[0]
    n_pad = ((n + block - 1) // block) * block
    if n_pad == n:
        return M, n
    pad = n_pad - n
    M = jnp.pad(M, ((0, pad), (0, pad)))
    idx = jnp.arange(n, n_pad)
    return M.at[idx, idx].set(1.0), n


def unblocked_cholesky(A: jnp.ndarray) -> jnp.ndarray:
    """Column-by-column Cholesky using only elementwise ops + rank-1
    updates - full working-precision accuracy with no opaque internals
    (the leaf factorization of every recursive/blocked routine here).
    """
    B = A.shape[0]
    rows = jnp.arange(B)

    def body(j, A):
        pivot = jnp.sqrt(A[j, j])
        col = jnp.where(rows > j, A[:, j] / pivot, 0.0)
        A = A - col[:, None] * col[None, :]
        A = A.at[:, j].set(jnp.where(rows > j, col, A[:, j]))
        A = A.at[j, j].set(pivot)
        return A

    return jnp.tril(lax.fori_loop(0, B, body, A))


def unblocked_trsm_lower(L: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
    """Row-by-row forward substitution ``L^{-1} V`` with precision-controlled
    matvecs (the B x B panel-solve primitive of the blocked algorithms)."""

    def body(i, Y):
        prod = jnp.matmul(L[i], Y, precision=jax.lax.Precision.HIGHEST)
        return Y.at[i].set((V[i] - prod) / L[i, i])

    return lax.fori_loop(0, L.shape[0], body, jnp.zeros_like(V))


def unblocked_trsm_lower_t(L: jnp.ndarray, V: jnp.ndarray) -> jnp.ndarray:
    """Backward substitution ``L^{-T} V`` (row-sequential, precision-safe)."""
    B = L.shape[0]

    def body(t, Y):
        i = B - 1 - t
        # rows > i of Y are solved; row i is still zero, L[i:, i] below picks
        # exactly the solved suffix
        prod = jnp.matmul(L[:, i], Y, precision=jax.lax.Precision.HIGHEST)
        return Y.at[i].set((V[i] - prod) / L[i, i])

    return lax.fori_loop(0, B, body, jnp.zeros_like(V))


@partial(jax.jit, static_argnums=(1,))
def blocked_cholesky(M: jnp.ndarray, block: int = 256) -> jnp.ndarray:
    """Right-looking blocked Cholesky with fully precision-controlled math.

    Every operation is explicit: rank-1 diagonal-block factorization,
    row-sequential panel solves, and ``Precision.HIGHEST`` matmuls for the
    O(n^3) trailing updates - no library factorization whose internal dot
    precision the caller cannot set.
    """
    M, n = _pad_spd(M, block)
    n_pad = M.shape[0]
    nb = n_pad // block
    B = block

    def body(k, M):
        kB = k * B
        Akk = lax.dynamic_slice(M, (kB, kB), (B, B))
        Lkk = unblocked_cholesky(Akk)
        col = lax.dynamic_slice(M, (0, kB), (n_pad, B))
        Lcol = unblocked_trsm_lower(Lkk, col.T).T  # (n_pad, B)
        rows_below = jnp.arange(n_pad) >= kB + B
        Lcol = jnp.where(rows_below[:, None], Lcol, 0.0)
        # write the finished panel column: diagonal block + below-diagonal
        # rows (rows above kB are upper-triangle, never read again)
        newcol = lax.dynamic_update_slice(Lcol, Lkk, (kB, 0))
        M = lax.dynamic_update_slice(M, newcol, (0, kB))
        upd = jnp.matmul(Lcol, Lcol.T, precision=jax.lax.Precision.HIGHEST)
        colmask = jnp.arange(n_pad) >= kB + B
        M = M - jnp.where(rows_below[:, None] & colmask[None, :], upd, 0.0)
        return M

    M = lax.fori_loop(0, nb, body, M)
    return jnp.tril(M)[:n, :n]


@partial(jax.jit, static_argnums=(2,))
def blocked_trsm(L: jnp.ndarray, V: jnp.ndarray, block: int = 256) -> jnp.ndarray:
    """Forward substitution ``L^{-1} V`` with precision-controlled matmuls
    (multi-RHS; the precision-controlled counterpart of
    ``solve_triangular``)."""
    n = L.shape[0]
    n_pad = ((n + block - 1) // block) * block
    B = block
    if n_pad > n:
        pad = n_pad - n
        L = jnp.pad(L, ((0, pad), (0, pad)))
        idx = jnp.arange(n, n_pad)
        L = L.at[idx, idx].set(1.0)
        V = jnp.pad(V, ((0, pad), (0, 0)))
    nb = n_pad // B

    def body(k, Y):
        kB = k * B
        row = lax.dynamic_slice(L, (kB, 0), (B, n_pad))
        prod = jnp.matmul(row, Y, precision=jax.lax.Precision.HIGHEST)
        Lkk = lax.dynamic_slice(L, (kB, kB), (B, B))
        rhs = lax.dynamic_slice(V, (kB, 0), (B, V.shape[1])) - prod
        yk = unblocked_trsm_lower(Lkk, rhs)
        return lax.dynamic_update_slice(Y, yk, (kB, 0))

    Y = lax.fori_loop(0, nb, body, jnp.zeros_like(V))
    return Y[:n]


def blocked_tri_inverse(L: jnp.ndarray, block: int = 256) -> jnp.ndarray:
    """``L^{-1}`` via the precision-controlled blocked forward substitution."""
    eye = jnp.eye(L.shape[0], dtype=L.dtype)
    return blocked_trsm(L, eye, block)


# ---------------------------------------------------------------------------
# Recursive (divide-and-conquer) factorizations.
#
# The fori_loop-based blocked algorithms above update the *full* padded
# matrix every panel step (shapes under jit must be static), costing ~n^3
# multiply-adds where the textbook right-looking algorithm needs n^3/3.
# Recursion over halves gives static shapes at every level with the optimal
# flop count and large square matmuls. Depth is log2(n/leaf) (~7 at
# n=20k), so the unrolled XLA graph stays small. All matmuls run at
# Precision.HIGHEST (plain FP32 on the GPU, never TF32): the equilibrated
# Gram matrices are ill-conditioned enough that reduced-precision dots NaN
# the factorization.
# ---------------------------------------------------------------------------

_HI = jax.lax.Precision.HIGHEST


def _split(n: int, leaf: int) -> int:
    """Split point: half of the leaf-blocks, rounded up (n % leaf == 0)."""
    nb = n // leaf
    return (nb - nb // 2) * leaf


def _trsm_rec(L: jnp.ndarray, V: jnp.ndarray, leaf: int) -> jnp.ndarray:
    """``L^{-1} V`` (lower-tri L, multi-RHS), recursive halving."""
    n = L.shape[0]
    if n <= leaf:
        return unblocked_trsm_lower(L, V)
    h = _split(n, leaf)
    Y1 = _trsm_rec(L[:h, :h], V[:h], leaf)
    rhs2 = V[h:] - jnp.matmul(L[h:, :h], Y1, precision=_HI)
    Y2 = _trsm_rec(L[h:, h:], rhs2, leaf)
    return jnp.concatenate([Y1, Y2], axis=0)


def _trsm_t_rec(L: jnp.ndarray, V: jnp.ndarray, leaf: int) -> jnp.ndarray:
    """``L^{-T} V`` (lower-tri L, multi-RHS), recursive halving."""
    n = L.shape[0]
    if n <= leaf:
        return unblocked_trsm_lower_t(L, V)
    h = _split(n, leaf)
    Y2 = _trsm_t_rec(L[h:, h:], V[h:], leaf)
    rhs1 = V[:h] - jnp.matmul(L[h:, :h].T, Y2, precision=_HI)
    Y1 = _trsm_t_rec(L[:h, :h], rhs1, leaf)
    return jnp.concatenate([Y1, Y2], axis=0)


def _cholesky_rec(A: jnp.ndarray, leaf: int) -> jnp.ndarray:
    n = A.shape[0]
    if n <= leaf:
        return unblocked_cholesky(A)
    h = _split(n, leaf)
    L11 = _cholesky_rec(A[:h, :h], leaf)
    # L21 = A21 L11^{-T}  <=>  L21^T = L11^{-1} A21^T
    L21 = _trsm_rec(L11, A[:h, h:], leaf).T
    S = A[h:, h:] - jnp.matmul(L21, L21.T, precision=_HI)
    L22 = _cholesky_rec(S, leaf)
    top = jnp.concatenate([L11, jnp.zeros((h, n - h), dtype=A.dtype)], axis=1)
    bot = jnp.concatenate([L21, L22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def _chol_inv_rec(A: jnp.ndarray, leaf: int):
    """Simultaneous ``(L, W = L^{-1})`` by one divide-and-conquer pass.

    The separated pipeline (factor, then invert, then Newton-refine) walks
    the matrix three times at ~n^3 total MACs, and its TRSM recursions
    bottom out in row-sequential substitution leaves whose tiny GEMVs
    leave the matmul units idle (it was the bottleneck of the ``'normal'``
    Gauss-Newton step at large latent dimension). Here the
    panel solve IS a GEMM against the already-inverted diagonal block
    (``L21 = A21 W11^T``) and the inverse assembles by the block formula
    ``W21 = -W22 (L21 W11)`` - every O(n^3) operation is a large
    ``Precision.HIGHEST`` matmul; substitution survives only inside the
    ``leaf x leaf`` diagonal leaves, whose inverses are Newton-refined once
    (the block-assembly formula is exact algebra, so leaf accuracy is what
    the composed inverse inherits, amplified only by GEMM rounding). Total
    cost 2 n^3/3 MACs (n^3/3 factor + n^3/3 inverse)."""
    n = A.shape[0]
    if n <= leaf:
        L = unblocked_cholesky(A)
        eye = jnp.eye(n, dtype=A.dtype)
        W = unblocked_trsm_lower(L, eye)
        E = eye - jnp.matmul(W, L, precision=_HI)
        return L, W + jnp.matmul(E, W, precision=_HI)
    h = _split(n, leaf)
    L11, W11 = _chol_inv_rec(A[:h, :h], leaf)
    L21 = jnp.matmul(A[h:, :h], W11.T, precision=_HI)
    S = A[h:, h:] - jnp.matmul(L21, L21.T, precision=_HI)
    L22, W22 = _chol_inv_rec(S, leaf)
    W21 = -jnp.matmul(
        W22, jnp.matmul(L21, W11, precision=_HI), precision=_HI
    )
    zero = jnp.zeros((h, n - h), dtype=A.dtype)
    L = jnp.concatenate(
        [jnp.concatenate([L11, zero], axis=1),
         jnp.concatenate([L21, L22], axis=1)], axis=0
    )
    W = jnp.concatenate(
        [jnp.concatenate([W11, zero], axis=1),
         jnp.concatenate([W21, W22], axis=1)], axis=0
    )
    return L, W


@partial(jax.jit, static_argnums=(1,))
def cholesky_inverse(M: jnp.ndarray, leaf: int = 256):
    """``(L, L^{-1})`` of an SPD matrix, all-GEMM (see :func:`_chol_inv_rec`).
    Same padding contract as :func:`recursive_cholesky`."""
    M, n = _pad_spd(M, leaf)
    L, W = _chol_inv_rec(M, leaf)
    return L[:n, :n], W[:n, :n]


def _tri_inverse_rec(L: jnp.ndarray, leaf: int) -> jnp.ndarray:
    """``L^{-1}`` via  inv([[L11,0],[L21,L22]]) = [[M11,0],[-M22 L21 M11, M22]]."""
    n = L.shape[0]
    if n <= leaf:
        return unblocked_trsm_lower(L, jnp.eye(n, dtype=L.dtype))
    h = _split(n, leaf)
    M11 = _tri_inverse_rec(L[:h, :h], leaf)
    M22 = _tri_inverse_rec(L[h:, h:], leaf)
    M21 = -jnp.matmul(
        M22, jnp.matmul(L[h:, :h], M11, precision=_HI), precision=_HI
    )
    top = jnp.concatenate([M11, jnp.zeros((h, n - h), dtype=L.dtype)], axis=1)
    bot = jnp.concatenate([M21, M22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


@partial(jax.jit, static_argnums=(1,))
def recursive_cholesky(M: jnp.ndarray, leaf: int = 256) -> jnp.ndarray:
    """Precision-controlled Cholesky at the textbook n^3/3 flop count.

    Drop-in replacement for :func:`blocked_cholesky` (same padding contract,
    same leaf factorization), but the trailing updates touch only the
    trailing submatrix: ~3x fewer multiply-adds and square matmul shapes.
    """
    M, n = _pad_spd(M, leaf)
    return _cholesky_rec(M, leaf)[:n, :n]


def _pad_tri(L: jnp.ndarray, block: int):
    n = L.shape[0]
    n_pad = ((n + block - 1) // block) * block
    if n_pad == n:
        return L, n
    pad = n_pad - n
    L = jnp.pad(L, ((0, pad), (0, pad)))
    idx = jnp.arange(n, n_pad)
    return L.at[idx, idx].set(1.0), n


@partial(jax.jit, static_argnums=(2, 3))
def recursive_trsm(
    L: jnp.ndarray, V: jnp.ndarray, trans: bool = False, leaf: int = 256
) -> jnp.ndarray:
    """``L^{-1} V`` (or ``L^{-T} V`` with ``trans``), recursive halving."""
    squeeze = V.ndim == 1
    if squeeze:
        V = V[:, None]
    L, n = _pad_tri(L, leaf)
    if L.shape[0] > n:
        V = jnp.pad(V, ((0, L.shape[0] - n), (0, 0)))
    Y = (_trsm_t_rec if trans else _trsm_rec)(L, V, leaf)[:n]
    return Y[:, 0] if squeeze else Y


@partial(jax.jit, static_argnums=(1,))
def recursive_tri_inverse(L: jnp.ndarray, leaf: int = 256) -> jnp.ndarray:
    """``L^{-1}`` at the optimal flop count with large matmul shapes."""
    L, n = _pad_tri(L, leaf)
    return _tri_inverse_rec(L, leaf)[:n, :n]


def _trmm_left(T: jnp.ndarray, X: jnp.ndarray, leaf: int) -> jnp.ndarray:
    """``T @ X`` for lower-triangular T (n x n) and full X (n x m),
    recursive halving - ~n^2 m / 2 multiply-adds vs n^2 m dense."""
    n = T.shape[0]
    if n <= leaf:
        return jnp.matmul(T, X, precision=_HI)
    h = _split(n, leaf)
    Y1 = _trmm_left(T[:h, :h], X[:h], leaf)
    Y2 = jnp.matmul(T[h:, :h], X[:h], precision=_HI) + _trmm_left(
        T[h:, h:], X[h:], leaf
    )
    return jnp.concatenate([Y1, Y2], axis=0)


def _trmm_right(X: jnp.ndarray, T: jnp.ndarray, leaf: int) -> jnp.ndarray:
    """``X @ T`` for full X (m x n) and lower-triangular T (n x n)."""
    n = T.shape[0]
    if n <= leaf:
        return jnp.matmul(X, T, precision=_HI)
    h = _split(n, leaf)
    Y1 = _trmm_right(X[:, :h], T[:h, :h], leaf) + jnp.matmul(
        X[:, h:], T[h:, :h], precision=_HI
    )
    Y2 = _trmm_right(X[:, h:], T[h:, h:], leaf)
    return jnp.concatenate([Y1, Y2], axis=1)


def _trimul_ll(A: jnp.ndarray, B: jnp.ndarray, leaf: int) -> jnp.ndarray:
    """``A @ B`` for two lower-triangular matrices (result is lower).

    Recursion exploits both operands' structure: ~n^3/6 multiply-adds vs
    n^3 for a dense matmul (the mathematical zero blocks are never
    computed - the upper triangle of the product is exactly zero, as in the
    dense evaluation, because zero operand blocks propagate)."""
    n = A.shape[0]
    if n <= leaf:
        return jnp.matmul(A, B, precision=_HI)
    h = _split(n, leaf)
    C11 = _trimul_ll(A[:h, :h], B[:h, :h], leaf)
    C21 = _trmm_right(A[h:, :h], B[:h, :h], leaf) + _trmm_left(
        A[h:, h:], B[h:, :h], leaf
    )
    C22 = _trimul_ll(A[h:, h:], B[h:, h:], leaf)
    top = jnp.concatenate([C11, jnp.zeros((h, n - h), dtype=A.dtype)], axis=1)
    return jnp.concatenate([top, jnp.concatenate([C21, C22], axis=1)], axis=0)


@partial(jax.jit, static_argnums=(2, 3))
def newton_refine_tri_inverse(
    L: jnp.ndarray, W: jnp.ndarray, steps: int = 1, leaf: int = 256
) -> jnp.ndarray:
    """Newton iteration on the left inverse: ``W <- W + (I - W L) W``.

    Each step squares the residual ``E = I - W L``. On the ill-conditioned
    equilibrated Gram factors this solver produces, a raw f32 triangular
    inverse carries ||WL-I|| ~ 1e-2; one step brings it to ~1e-4 (measured
    on the canonical elliptic N=900 workload, where it moves the end-to-end
    test L2 from 9.5e-3 to 2.3e-3 - past the reference's recorded 3.4e-3).
    Factorization-time cost only: the refined ``W`` is what the whitening
    matmuls reuse every Gauss-Newton step and posterior query.

    Both products are triangular x triangular (W, L, E and the update are
    all lower), so above ``8 * leaf`` each runs as a :func:`_trimul_ll`
    recursion at ~n^3/6 multiply-adds - a Newton step costs ~n^3/3 total
    instead of the 2 n^3 of dense matmuls (the refinement passes dominated
    factorization time at N=10k). Below the threshold the dense two-matmul
    form wins: the recursion's many small operations cost more in launch
    overhead than the flops they save. The threshold was not re-measured
    on the H100 (ROADMAP A8).
    """
    n = L.shape[0]
    if n <= 8 * leaf:
        eye = jnp.eye(n, dtype=L.dtype)
        for _ in range(steps):
            E = eye - jnp.matmul(W, L, precision=_HI)
            W = W + jnp.matmul(E, W, precision=_HI)
        return W
    Lp, _ = _pad_tri(L, leaf)
    n_pad = Lp.shape[0]
    if n_pad > n:
        Wp = jnp.pad(W, ((0, n_pad - n), (0, n_pad - n)))
        idx = jnp.arange(n, n_pad)
        Wp = Wp.at[idx, idx].set(1.0)
    else:
        Wp = W
    eye = jnp.eye(n_pad, dtype=L.dtype)
    for _ in range(steps):
        E = eye - _trimul_ll(Wp, Lp, leaf)
        Wp = Wp + _trimul_ll(E, Wp, leaf)
    return Wp[:n, :n]


def spd_solve(H: jnp.ndarray, g: jnp.ndarray, jitter: float = 0.0) -> jnp.ndarray:
    """Solve the SPD Gauss-Newton system ``H x = g`` by Cholesky.

    The reference uses general LU (``jnp.linalg.solve(Hessian, grad)``,
    ``src/PDEs.py:118``); the GN normal matrix is symmetric PSD so a
    Cholesky solve is both faster and more stable.

    On the GPU (f32) this routine takes the precision-controlled all-GEMM
    factorization with diagonal equilibration (:func:`spd_solve_controlled`)
    - the GN step quality directly inherits this solve's accuracy. Whether
    cuSOLVER's ``cholesky`` would do as well is open (ROADMAP A4).
    """
    if jitter:
        H = H + jitter * jnp.eye(H.shape[0], dtype=H.dtype)
    from .backend import is_accelerator

    if not is_accelerator():
        Lh = jnp.linalg.cholesky(H)
        return solve_triangular(
            Lh, solve_triangular(Lh, g, lower=True), lower=True, trans=1
        )
    return spd_solve_controlled(H, g)


def spd_inverse(H: jnp.ndarray, leaf: int = 256) -> jnp.ndarray:
    """Explicit SPD inverse via the equilibrated all-GEMM factorization
    (``H^{-1} = D^{-1/2} W^T W D^{-1/2}`` with ``W`` the inverse Cholesky
    factor of the equilibrated matrix). Same ``32 eps`` diagonal floor as
    :func:`spd_solve_controlled`. Used for the small (r x r) projected
    operators of the deflation preconditioner, where the inverse is applied
    every CG iteration."""
    n = H.shape[0]
    d = jnp.diagonal(H)
    d_isqrt = jax.lax.rsqrt(jnp.maximum(d, jnp.finfo(H.dtype).tiny))
    Hs = H * (d_isqrt[:, None] * d_isqrt[None, :])
    floor = 1.0 + 32.0 * jnp.finfo(H.dtype).eps
    Hs = Hs.at[jnp.arange(n), jnp.arange(n)].set(floor)
    _, W = cholesky_inverse(Hs, leaf)
    return jnp.matmul(W.T, W, precision=_HI) * (
        d_isqrt[:, None] * d_isqrt[None, :]
    )


def spd_solve_controlled(H: jnp.ndarray, g: jnp.ndarray) -> jnp.ndarray:
    """Equilibrated all-GEMM SPD solve with HIGHEST-precision dots (the
    accelerator branch of :func:`spd_solve`; separable for testing).

    A Tikhonov floor of ``32 eps`` is added to the *unit* diagonal of the
    equilibrated matrix: the Gauss-Newton normal matrix has cond(J)^2, which
    at large N sits past f32's representable conditioning - without the
    floor the factorization NaNs and every GN step gets rejected (measured
    at N=10k). Relative bias on a well-conditioned system is O(32 eps),
    orders below the solve's own rounding.

    The factorization is :func:`cholesky_inverse` (the recursive_cholesky
    + recursive_trsm pipeline bottoms out in row-sequential substitution
    leaves; the all-GEMM form runs the same n^3-class work as large
    matmuls; not re-measured on the H100, ROADMAP A8), after which the
    solve is two matvecs
    ``x = D^{-1/2} W^T (W (D^{-1/2} g))``."""
    n = H.shape[0]
    d = jnp.diagonal(H)
    d_isqrt = jax.lax.rsqrt(jnp.maximum(d, jnp.finfo(H.dtype).tiny))
    Hs = H * (d_isqrt[:, None] * d_isqrt[None, :])
    floor = 1.0 + 32.0 * jnp.finfo(H.dtype).eps
    Hs = Hs.at[jnp.arange(n), jnp.arange(n)].set(floor)
    _, W = cholesky_inverse(Hs)
    y = jnp.matmul(W, d_isqrt * g, precision=_HI)
    return d_isqrt * jnp.matmul(W.T, y, precision=_HI)
