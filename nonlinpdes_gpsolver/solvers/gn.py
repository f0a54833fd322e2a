"""Whitened Gauss-Newton driver, generic over :class:`CollocationProblem`.

Replaces the per-problem hand-written GN machinery of the reference
(``GN_method``/``GN_loss``/``Hessian_GN`` in ``src/PDEs.py:93-135, 295-343,
437-498`` and ``src/InverseProblems.py:126-174`` upstream) with one compiled
algorithm:

* stack all whitened block residuals ``L_b^{-1} F_b(z)`` and weighted misfits
  into one residual vector ``r(z)``;
* Jacobian ``J = dr/dz`` via ``jax.linearize`` + a vmapped basis push-forward.
  This generalizes the reference's *explicit-Jacobian* Burgers path
  (``src/PDEs.py:295-307``) and never does what its other three problems do -
  ``jax.hessian`` through ``jnp.linalg.solve`` (forward-over-reverse AD of an
  LU solve, the reference's dominant cost);
* normal equations ``(J^T J) delta = J^T r`` solved by SPD Cholesky;
* the whole iteration loop is a single ``lax.scan`` inside one ``jit`` - no
  per-iteration Python dispatch (the reference re-crosses the host boundary
  and prints device scalars every step, ``src/PDEs.py:117-127``);
* non-finite guard *inside* the scan: a step that would produce NaN is
  rejected and the iterate frozen (the reference's NaN check only breaks the
  loop after the damage is done).

``solve_mode``: whitening with triangular solves (``'trsm'``) is exact
forward substitution, the choice on CPU/f64; on the GPU ``'inverse'``
precomputes ``L^{-1}`` once and every subsequent whitening - including the
per-GN-step Jacobian panel - becomes a plain HIGHEST-precision matmul.
``'auto'`` picks by backend (whether cuBLAS TRSM would do as well on the GPU
is ROADMAP A4).

Total loss convention matches the reference:
``sum_b ||L_b^{-1} F_b(z)||^2 + sum_m w_m ||r_m(z)||^2``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp

from ..models.spec import CollocationProblem
from ..ops.assembly import (
    adaptive_nugget_diag,
    gram_matrix,
    observable_sizes,
)
from ..ops.linalg import (
    cholesky_with_retry,
    newton_refine_tri_inverse,
    recursive_cholesky,
    recursive_tri_inverse,
    spd_solve,
    tri_inverse,
    whiten,
)


@partial(jax.jit, static_argnums=(0, 1, 3))
def _assemble_block(kernel, observables, points, nugget_type, nugget):
    """Gram matrix + nugget diagonal for one GP block, fused under one jit.

    ``kernel`` and ``observables`` are hashable static values, so XLA sees
    the closed-form derivative blocks as one fusible graph (the reference
    dispatches one vmapped call per block and round-trips each block through
    host numpy - ``src/Gram_matrice.py:42-56`` upstream).
    """
    theta = gram_matrix(kernel, observables, points)
    sizes = observable_sizes(observables, points)
    nug = adaptive_nugget_diag(theta, observables, sizes, nugget, nugget_type)
    return theta, nug


# Factor-quality acceptance threshold shared by every verdict site: the
# eager ladders here and in :func:`..solvers.distributed.
# factorize_distributed` (its ``quality_tol`` default) AND the deferred
# verdict fetched by :class:`..api.GPSolver` - one constant so the eager
# and deferred paths can never silently diverge (round-4 ADVICE item 3).
QUALITY_TOL = 1e-2


@dataclasses.dataclass(frozen=True)
class FactoredProblem:
    """A problem plus factorizations of its regularized Gram matrices.

    ``factors[name]`` is the lower Cholesky factor of the *equilibrated*
    regularized Gram matrix ``D^{-1/2} (Theta + nugget) D^{-1/2}`` where
    ``D`` is its diagonal (``col_scales[name]`` holds ``d^{-1/2}``). Since
    ``v^T Theta^{-1} v == || L~^{-1} D^{-1/2} v ||^2`` exactly, the loss is
    unchanged; the equilibrated matrix has unit diagonal, which is what
    makes fp32 factorization viable (the raw derivative blocks differ
    in scale by ~1e5, see the trace-adaptive nugget ratios).

    ``inv_factors[name]`` additionally holds ``L~^{-1} D^{-1/2}`` (scale
    folded in) when ``solve_mode='inverse'``, making whitening one matmul.
    """

    problem: CollocationProblem
    factors: Dict[str, jnp.ndarray]
    inv_factors: Dict[str, jnp.ndarray]
    nugget_scales: Dict[str, float]  # escalation applied per block (1.0 = none)
    col_scales: Dict[str, jnp.ndarray] = dataclasses.field(default_factory=dict)
    # pending whitening-quality scalars (device arrays, NOT synced) when the
    # factorization ran with ``defer_quality=True``; the caller must fetch
    # them (cheaply, alongside its own results) and re-factorize with
    # escalated ``start_scales`` if any is non-finite or >= 1e-2.
    # ``pending_scales`` holds the matching (scale, ok) device scalars from
    # the in-executable escalation ladder; after fetching, the caller
    # overwrites ``nugget_scales`` entries with the real values.
    quality: Dict[str, jnp.ndarray] = dataclasses.field(default_factory=dict)
    pending_scales: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    def _whiten(self, name: str, v: jnp.ndarray) -> jnp.ndarray:
        if name in self.inv_factors:
            return jnp.matmul(
                self.inv_factors[name], v, precision=jax.lax.Precision.HIGHEST
            )
        if name in self.col_scales:
            s = self.col_scales[name]
            v = v * (s if v.ndim == 1 else s[:, None])
        return whiten(self.factors[name], v)

    def kernel_solve(self, name: str, v: jnp.ndarray) -> jnp.ndarray:
        """``Theta^{-1} v`` through the equilibrated factor.

        With a precomputed whitening operator ``W = L~^{-1} D^{-1/2}`` this is
        ``W^T (W v)`` - two precision-controlled matmuls (the GPU path);
        otherwise two triangular solves plus the scale.
        """
        from jax.scipy.linalg import solve_triangular

        if name in self.inv_factors:
            W = self.inv_factors[name]
            hi = jax.lax.Precision.HIGHEST
            return jnp.matmul(W.T, jnp.matmul(W, v, precision=hi), precision=hi)
        L = self.factors[name]
        s = self.col_scales.get(name)
        if s is not None:
            v = v * (s if v.ndim == 1 else s[:, None])
        y = solve_triangular(L, v, lower=True)
        y = solve_triangular(L, y, lower=True, trans=1)
        if s is not None:
            y = y * (s if y.ndim == 1 else s[:, None])
        return y

    def whitened_residual(self, z: jnp.ndarray) -> jnp.ndarray:
        p = self.problem
        parts = [self._whiten(b.name, b.residual(z, p.data)) for b in p.blocks]
        for m in p.misfits:
            parts.append(jnp.sqrt(m.weight) * m.residual(z, p.data))
        return jnp.concatenate(parts)

    def loss(self, z: jnp.ndarray) -> jnp.ndarray:
        r = self.whitened_residual(z)
        return jnp.dot(r, r, precision=jax.lax.Precision.HIGHEST)


class GNState(NamedTuple):
    z: jnp.ndarray
    losses: jnp.ndarray  # loss history, one entry per iteration (post-step)
    converged_finite: jnp.ndarray  # False if any step was rejected as non-finite
    # per-iteration inner-solve iteration counts (CG/Woodbury step solvers;
    # zeros for direct solvers). Surfaced so a truncated inner solve - the
    # silent-failure mode of a capped ``cg_maxiter`` - is diagnosable from
    # the result instead of invisible (round-4 ADVICE item 2).
    cg_iters: jnp.ndarray | None = None


def _batched_cg(normal_op, B, tol, maxiter, M=None, X0=None):
    """Conjugate gradients on a *matrix* of right-hand sides sharing one SPD
    operator - the inner solve of the ``'cg'`` and ``'woodbury'`` step
    solvers.

    ``normal_op(V)`` must apply the operator columnwise to ``V`` of shape
    ``(m, k)``; per-column step lengths keep each column's Krylov recursion
    exact (this is k independent CG runs sharing their operator
    applications, not block-CG). Columns whose residual has dropped below
    ``tol * ||b||`` are frozen (alpha = beta = 0) while the rest continue;
    the loop exits when all have, or at ``maxiter``. Returns ``(X, iters)``
    with ``iters`` the total iteration count (device scalar).

    Batching matters: one operator application on a (m, k) panel runs the
    distributed triangular solves / whitening matmuls as GEMMs, where k
    separate vector solves would each be memory-bound GEMVs - the Woodbury
    step owes its throughput to this.

    ``X0``: optional warm start (costs one extra operator application for
    the initial residual). The Woodbury step carries the previous GN
    iteration's solves: the misfit right-hand sides are constant and the
    operator changes only through the relinearization, so later GN steps
    start close and converge in a fraction of the cold iteration count.
    """
    dtype = B.dtype
    tol2 = (jnp.asarray(tol, dtype) ** 2) * jnp.sum(B * B, axis=0)

    def prec(R):
        return M(R) if M is not None else R

    if X0 is None:
        X0 = jnp.zeros_like(B)
        R0 = B
    else:
        R0 = B - normal_op(X0)
    Z0 = prec(R0)
    gamma0 = jnp.sum(R0 * Z0, axis=0)

    def cond(c):
        X, R, Pd, gamma, i = c
        return (i < maxiter) & jnp.any(jnp.sum(R * R, axis=0) > tol2)

    def body(c):
        X, R, Pd, gamma, i = c
        active = jnp.sum(R * R, axis=0) > tol2
        Q = normal_op(Pd)
        denom = jnp.sum(Pd * Q, axis=0)
        safe = active & (denom > 0)
        alpha = jnp.where(safe, gamma / jnp.where(safe, denom, 1.0), 0.0)
        X = X + alpha[None, :] * Pd
        R = R - alpha[None, :] * Q
        Z = prec(R)
        gamma_new = jnp.sum(R * Z, axis=0)
        beta = jnp.where(safe, gamma_new / jnp.where(gamma > 0, gamma, 1.0), 0.0)
        Pd = Z + beta[None, :] * Pd
        return X, R, Pd, gamma_new, i + 1

    X, _, _, _, iters = jax.lax.while_loop(
        cond, body, (X0, R0, Z0, gamma0, jnp.asarray(0))
    )
    return X, iters


def _woodbury_pieces(misfit_spec, data, z):
    """Misfit low-rank data for the Woodbury step: ``(U, wvec)`` with ``U``
    the (m, K) stacked misfit Jacobian transposes (K = total misfit rows,
    built by K VJPs - misfit row counts are small by construction) and
    ``wvec`` the per-row weights, so the misfit Hessian term is
    ``U diag(wvec) U^T``."""
    Us, ws = [], []
    for residual, weight in misfit_spec:
        f = lambda zz, _r=residual: _r(zz, data)
        Fm, vjp = jax.vjp(f, z)
        basis = jnp.eye(Fm.shape[0], dtype=z.dtype)
        Jm = jax.vmap(lambda e, _v=vjp: _v(e)[0])(basis)  # (K_m, m)
        Us.append(Jm.T)
        ws.append(jnp.full((Fm.shape[0],), weight, z.dtype))
    return jnp.concatenate(Us, axis=1), jnp.concatenate(ws)


def _woodbury_correct(X, U, wvec, hessian_jitter):
    """Combine the misfit-free solves ``X = H0^{-1} [g, U]`` into the exact
    step for ``H = H0 + U diag(w) U^T``:

    ``H^{-1} g = X_g - X_U (diag(1/w) + U^T X_U)^{-1} (U^T X_g)``

    (Sherman-Morrison-Woodbury on the rank-K misfit). The capacitance
    matrix is (K, K) - for the Darcy inverse K = n_data = 60 rows
    (upstream ``main_DarcyFlow2d.py:63``), so the correction is noise-level
    cheap at ANY latent dimension."""
    hi = jax.lax.Precision.HIGHEST
    Xg, Xu = X[:, 0], X[:, 1:]
    C = jnp.diag(1.0 / wvec) + jnp.matmul(U.T, Xu, precision=hi)
    t = jnp.matmul(U.T, Xg, precision=hi)
    y = spd_solve(C, t, jitter=hessian_jitter)
    return Xg - jnp.matmul(Xu, y, precision=hi)


@partial(jax.jit, static_argnums=(3,))
def _equilibrated_cholesky(theta, nug_diag, s0, use_controlled):
    """Factor ``D^{-1/2} (theta + s*diag(nug)) D^{-1/2}`` (unit diagonal)
    with IN-EXECUTABLE nugget escalation: a device-side while_loop retries
    at ``s * 10`` whenever the factor comes out non-finite (the
    too-small-nugget-for-the-dtype class), up to 8 attempts - no host round
    trip and no wasted downstream work per rung. Returns
    ``(L, d_isqrt, s, ok)`` with ``s`` the scale the accepted factor used
    (device scalars; fetch them with other results).

    ``use_controlled`` selects the precision-controlled recursive
    factorization (:func:`..ops.linalg.recursive_cholesky`, every dot at
    HIGHEST) - the GPU path; CPU takes LAPACK's f64 ``cholesky``.

    NOTE the triangular inverse + Newton refinement are kept OUT of this
    executable: on the platform this solver was first built for, one XLA
    program containing cholesky + tri-inverse + Newton produced a finite but
    *wrong* inverse while the same ops as separate executables were
    correct. Whether the split is still needed on the GPU is ROADMAP C5.
    The factorization path also probes whitening quality
    (:func:`_refine_scale_quality`) so any silent corruption (which
    finiteness checks provably miss) is caught and handled by host-side
    nugget escalation rather than poisoning the solve.
    """
    n = theta.shape[0]
    idx = jnp.arange(n)

    def attempt(s):
        d = jnp.diagonal(theta) + s * nug_diag
        d_isqrt = jax.lax.rsqrt(d)
        M = theta * (d_isqrt[:, None] * d_isqrt[None, :])
        M = M.at[idx, idx].set(1.0)
        L = recursive_cholesky(M) if use_controlled else jnp.linalg.cholesky(M)
        return L, d_isqrt, jnp.all(jnp.isfinite(L))

    def cond(c):
        L, d_isqrt, s, att, ok = c
        return (~ok) & (att < 8)

    def body(c):
        _, _, s, att, _ = c
        L, d_isqrt, ok = attempt(s)
        # on success s stays the used value; on failure it advances
        return L, d_isqrt, jnp.where(ok, s, s * 10.0), att + 1, ok

    init = (
        jnp.zeros_like(theta), jnp.zeros(n, theta.dtype),
        jnp.asarray(s0, theta.dtype), jnp.asarray(0), jnp.asarray(False),
    )
    L, d_isqrt, s, att, ok = jax.lax.while_loop(cond, body, init)
    return L, d_isqrt, s, ok


@jax.jit
def _refined_tri_inverse(L):
    """One dispatch for ``newton_refine(recursive_tri_inverse(L))``.

    Fusing these two (WITHOUT the Cholesky - see the miscompile note in
    :func:`_equilibrated_cholesky`) halves the per-block dispatch count;
    the whitening-quality probe still guards the fused program's output."""
    return newton_refine_tri_inverse(L, recursive_tri_inverse(L))


@jax.jit
def _whiten_quality(inv, L, d_isqrt, v):
    """Relative whitening residual ``max|W(Lv) - v| / max|v|`` for the
    scale-folded operator ``inv = L~^{-1} D^{-1/2}`` (matvecs only)."""
    u = jnp.matmul(L, v, precision=jax.lax.Precision.HIGHEST)
    w = jnp.matmul(inv, u / d_isqrt, precision=jax.lax.Precision.HIGHEST)
    return jnp.max(jnp.abs(w - v)) / jnp.max(jnp.abs(v))


@partial(jax.jit, static_argnums=(3,))
def _refine_scale_quality(L, d_isqrt, v, refined):
    """Tri-inverse (+ Newton refinement) + scale-fold + whitening-quality
    probe as ONE executable instead of three dispatches (inverse, eager
    ``inv * d_isqrt``, probe matmuls), whose launches dominate small-n
    factorization. The
    Cholesky stays in its own executable (miscompile note in
    :func:`_equilibrated_cholesky`); the returned quality scalar still
    guards this fused program's output."""
    inv = (
        newton_refine_tri_inverse(L, recursive_tri_inverse(L))
        if refined
        else tri_inverse(L)
    )
    inv = inv * d_isqrt[None, :]
    u = jnp.matmul(L, v, precision=jax.lax.Precision.HIGHEST)
    w = jnp.matmul(inv, u / d_isqrt, precision=jax.lax.Precision.HIGHEST)
    q = jnp.max(jnp.abs(w - v)) / jnp.max(jnp.abs(v))
    return inv, q


_PROBE_CACHE: dict = {}


def _probe_vec(n: int, dtype) -> jnp.ndarray:
    """Fixed unit-seed Gaussian probe, cached per (n, dtype) so repeated
    factorizations skip the host->device transfer."""
    key = (n, jnp.dtype(dtype).name)
    v = _PROBE_CACHE.get(key)
    if v is None:
        import numpy as onp

        v = jnp.asarray(onp.random.default_rng(0).standard_normal(n), dtype)
        _PROBE_CACHE[key] = v
    return v


def factorize(
    problem: CollocationProblem,
    nugget: float,
    nugget_type: str = "adaptive",
    dtype=None,
    solve_mode: str = "auto",
    equilibrate: bool = True,
    defer_quality: bool = False,
    start_scales: Dict[str, float] | None = None,
) -> FactoredProblem:
    """Assemble + regularize + factor every GP block's Gram matrix.

    ``equilibrate`` (default) factors the diagonally-scaled matrix - exactly
    equivalent whitening, far better fp32 conditioning (the GPU regime).

    ``defer_quality``: run a SINGLE factorization attempt per block with no
    host sync, leaving the whitening-quality verdict as a pending device
    scalar in ``FactoredProblem.quality``. The caller fetches it together
    with its own downstream results (one round trip total) and, on a bad
    verdict, re-calls with ``start_scales`` escalated 10x for the failing
    blocks - the optimistic pipeline :class:`..api.GPSolver` uses on the
    GPU, where the eager ladder's mid-pipeline sync drains the device queue
    (whether that costs more than it saves there is ROADMAP C5). At
    n >= 8192 a cheap finiteness
    sync still guards the O(n^3) inverse from running on a NaN factor.

    ``start_scales``: per-block multiplier on the nugget-escalation starting
    point (from a previous attempt's verdict).
    """
    from ..ops.backend import is_accelerator

    on_accelerator = is_accelerator()
    if solve_mode == "auto":
        solve_mode = "inverse" if on_accelerator else "trsm"
    factors = {}
    inv_factors = {}
    scales = {}
    col_scales = {}
    quality = {}
    pending_scales = {}
    pts = {
        k: jnp.asarray(v, dtype=dtype) for k, v in problem.points.items()
    }
    for b in problem.blocks:
        theta, nug = _assemble_block(b.kernel, b.observables, pts, nugget_type, nugget)
        if equilibrate:
            want_inv = solve_mode == "inverse"
            # Escalation start: the equilibrated matrix has unit diagonal, so
            # the effective relative nugget is ``nugget * s``. Reference CLI
            # configs use f64-era nuggets as small as 1e-13
            # (main_NonLinElliptic2d.py:28 upstream); below a few ulps of the
            # working dtype they are no regularization at all, so start the
            # retry ladder at a dtype-aware floor instead of burning attempts.
            eps = float(jnp.finfo(theta.dtype).eps)
            s0 = max(1.0, (4.0 * eps) / max(nugget, 1e-300))
            if start_scales:
                s0 = max(s0, float(start_scales.get(b.name, 1.0)))
            s = s0
            # The non-finite (nugget-too-small) class escalates INSIDE the
            # Cholesky executable - zero host round trips, and a deferred
            # pipeline never re-runs GN over it. The host loop below exists
            # only for the finite-but-CORRUPT class, which only the
            # whitening-quality probe can see.
            for _ in range(8):
                L, d_isqrt, s_dev, ok_dev = _equilibrated_cholesky(
                    theta, nug, s, on_accelerator
                )
                if not want_inv:
                    ok = bool(ok_dev)  # CPU/trsm path: syncs are cheap there
                    if not ok:
                        raise FloatingPointError(
                            f"block {b.name!r}: Cholesky non-finite after "
                            f"in-executable nugget escalation (start {s:g}x)"
                        )
                    s = float(s_dev)
                    break
                # tri-inverse kept OUT of the Cholesky executable on purpose
                # (see _equilibrated_cholesky); within that constraint the
                # refine+scale+probe stages fuse into one dispatch. Raw f32
                # inverse carries ~1e-2 left-residual on these ill-conditioned
                # factors; one Newton step restores ~1e-4.
                inv, q_dev = _refine_scale_quality(
                    L, d_isqrt, _probe_vec(L.shape[0], L.dtype), on_accelerator
                )
                if defer_quality:
                    inv_factors[b.name] = inv
                    quality[b.name] = q_dev
                    pending_scales[b.name] = (s_dev, ok_dev)
                    break
                import math

                q, s, ok = map(float, jax.device_get((q_dev, s_dev, ok_dev)))
                if not ok:
                    raise FloatingPointError(
                        f"block {b.name!r}: Cholesky non-finite after "
                        f"in-executable nugget escalation to {s:g}x"
                    )
                if math.isfinite(q) and q < QUALITY_TOL:
                    inv_factors[b.name] = inv
                    break
                s *= 10.0  # finite but corrupted factor: escalate anyway
            else:
                raise FloatingPointError(
                    f"block {b.name!r}: factor quality still bad after "
                    f"nugget escalation to {s:g}x"
                )
            col_scales[b.name] = d_isqrt
        else:
            L, s = cholesky_with_retry(theta, nug)
            if solve_mode == "inverse":
                inv_factors[b.name] = jax.jit(tri_inverse)(L)
        factors[b.name] = L
        scales[b.name] = s
    return FactoredProblem(
        problem, factors, inv_factors, scales, col_scales, quality,
        pending_scales,
    )


def _slice_structure(problem: CollocationProblem):
    """Static metadata for the structured Jacobian fast path, or ``None``.

    Structure = the latent vector is ``s`` slices of length ``N`` (the
    interior point count) and every residual row depends only on the latent
    entries *at the same point* (true for every elimination-form collocation
    problem: each row block is a pointwise map of latent slices, boundary/
    data rows are constants). Then the raw Jacobian is a stack of diagonals
    and the whitened Jacobian panel ``J = W J_r`` is a sum of column-scaled
    slabs of ``W`` - O(m n N) elementwise work instead of the dense
    (n x n)@(n x latent) matmul (the dominant per-iteration cost at large N).
    Validated numerically by :func:`_structure_holds` before use.
    """
    pts = problem.points.get("domain")
    if pts is None:
        return None
    N = int(pts.shape[0])
    if N == 0 or problem.latent_dim % N:
        return None
    s = problem.latent_dim // N
    seginfo = []
    for b in problem.blocks:
        sizes = observable_sizes(b.observables, problem.points)
        segs, off = [], 0
        for sz in sizes:
            segs.append((off, int(sz)))
            off += int(sz)
        seginfo.append(tuple(segs))
    return s, N, tuple(seginfo)


def _block_diagonals(residual, data, z, s, N):
    """Per-slice diagonal vectors ``D_j`` (length n_rows) of the raw residual
    Jacobian, extracted with ``s`` slice-indicator JVPs (exact when the
    structure holds: a pointwise row's slice-row-sum IS its diagonal)."""
    _, jvp = jax.linearize(lambda zz: residual(zz, data), z)
    outs = []
    for j in range(s):
        e = jnp.zeros_like(z).at[j * N : (j + 1) * N].set(1.0)
        outs.append(jvp(e))
    return outs


_STRUCTURE_CACHE: dict = {}


def validate_slice_structure(
    problem: CollocationProblem, structure, dtype, probes: int = 2
) -> bool:
    """Numerically verify the pointwise-slice structure (eager, setup-time).

    For random tangents v, the structured prediction
    ``sum_j D_j[rows_i] * v[slice j]`` (zero on non-interior rows) must match
    the true JVP of the *raw* residuals. Two independent probes make a false
    positive vanishingly unlikely for any residual with genuine cross-point
    coupling. Used by both the single-device and the distributed structured
    Jacobian paths (the check involves no whitening, only raw residuals).

    The verdict is cached on (residual function identities, structure,
    dtype): model constructors produce ``lru_cache``'d residuals, so
    rebuilding the same problem configuration skips revalidation - the
    eager probes would otherwise dominate small-problem solve time. The
    whole check costs ONE host sync.
    """
    import numpy as np

    p = problem
    key = (tuple(b.residual for b in p.blocks), structure, jnp.dtype(dtype).name)
    try:
        cached = _STRUCTURE_CACHE.get(key)
    except TypeError:  # unhashable residual: validate without caching
        key, cached = None, None
    if cached is not None:
        return cached

    s, N, seginfo = structure
    rng = np.random.default_rng(0)
    z = jnp.asarray(rng.standard_normal(p.latent_dim), dtype)
    worst = jnp.asarray(0.0, dtype)  # max relative mismatch across everything
    for b, segs in zip(p.blocks, seginfo):
        f = lambda zz: b.residual(zz, p.data)
        F, jvp = jax.linearize(f, z)
        D = _block_diagonals(b.residual, p.data, z, s, N)
        for _ in range(probes):
            v = jnp.asarray(rng.standard_normal(p.latent_dim), dtype)
            pred = jnp.zeros_like(F)
            for off, sz in segs:
                if sz != N:
                    continue
                contrib = sum(
                    D[j][off : off + sz] * v[j * N : (j + 1) * N]
                    for j in range(s)
                )
                pred = pred.at[off : off + sz].set(contrib)
            actual = jvp(v)
            scale = jnp.max(jnp.abs(actual)) + 1.0
            worst = jnp.maximum(worst, jnp.max(jnp.abs(actual - pred)) / scale)
    ok = bool(worst < 1e-4)  # single host sync
    if key is not None:
        _STRUCTURE_CACHE[key] = ok
    return ok


def _structure_holds(fp: FactoredProblem, structure, probes: int = 2) -> bool:
    """Structured fast path applies iff every block has a precomputed
    whitening operator AND the raw-residual structure validates."""
    p = fp.problem
    if any(b.name not in fp.inv_factors for b in p.blocks):
        return False
    dtype = next(iter(fp.factors.values())).dtype
    return validate_slice_structure(p, structure, dtype, probes)


_IDENTITY_ROW_CACHE: dict = {}


def identity_slice_rows(problem: CollocationProblem, structure, dtype):
    """For each latent slice ``j``, the ``(block_index, row_offset)`` of a
    residual row segment that is the exact identity on that slice, or
    ``None`` if any slice lacks one.

    Every elimination-form collocation problem here includes each free
    latent slice verbatim among its residual rows (they ARE the observed
    nodal values, e.g. the Darcy ``[w1;w2;w0]`` / ``[...;v0;...]`` stacks,
    upstream ``src/InverseProblems.py:105-120``). Those rows give a
    selection ``S`` with ``S J = I`` whose prior restriction ``S Theta S^T``
    maps random probes onto the smooth latent modes - the deflation basis of
    the Krylov step solvers. Verified numerically (two full random-tangent
    JVP probes per candidate; setup-time, cached like
    :func:`validate_slice_structure`)."""
    import numpy as np

    p = problem
    key = (
        tuple(b.residual for b in p.blocks), structure, jnp.dtype(dtype).name,
    )
    try:
        cached = _IDENTITY_ROW_CACHE.get(key, "missing")
    except TypeError:
        key, cached = None, "missing"
    if cached != "missing":
        return cached

    s, N, seginfo = structure
    rng = np.random.default_rng(7)
    z = jnp.asarray(rng.standard_normal(p.latent_dim), dtype)
    t1 = jnp.asarray(rng.standard_normal(p.latent_dim), dtype)
    t2 = jnp.asarray(rng.standard_normal(p.latent_dim), dtype)
    found = [None] * s
    for bi, (b, segs) in enumerate(zip(p.blocks, seginfo)):
        _, jvp = jax.linearize(lambda zz: b.residual(zz, p.data), z)
        y1, y2 = jvp(t1), jvp(t2)
        for off, sz in segs:
            if sz != N:
                continue
            for j in range(s):
                if found[j] is not None:
                    continue
                ok1 = bool(
                    jnp.max(jnp.abs(y1[off : off + N] - t1[j * N : (j + 1) * N]))
                    < 1e-6 * (1.0 + float(jnp.max(jnp.abs(t1))))
                )
                if not ok1:
                    continue
                ok2 = bool(
                    jnp.max(jnp.abs(y2[off : off + N] - t2[j * N : (j + 1) * N]))
                    < 1e-6 * (1.0 + float(jnp.max(jnp.abs(t2))))
                )
                if ok2:
                    found[j] = (bi, off)
                    break
    result = tuple(found) if all(f is not None for f in found) else None
    if key is not None:
        _IDENTITY_ROW_CACHE[key] = result
    return result


def _misfit_jacobi_precond(misfit_spec, data, z):
    """Jacobi preconditioner for the matrix-free CG normal solve, or
    ``None`` when the problem has no misfits.

    Heavily-weighted data misfits (the Darcy inverse uses ``1/noise^2 ~
    1e6``) put entries of that scale on scattered diagonal elements of
    ``J^T J`` while the whitened GP blocks contribute O(1..1e2) - a
    condition-number floor of ~1e4..1e6 that unpreconditioned CG pays
    ~sqrt(cond) iterations for (measured: the mesh-path Darcy CG ran away
    at its default iteration budget). The misfit rows are few (n_data), so
    their exact Jacobian costs ``n_data`` VJPs and the exact misfit
    contribution to ``diag(J^T J)`` is its squared column sums; the
    equilibrated GP blocks are approximated by 1. Returns the CG ``M``
    operator ``v -> v / diag``."""
    if not misfit_spec:
        return None
    d = jnp.ones_like(z)
    for residual, weight in misfit_spec:
        f = lambda zz, _r=residual: _r(zz, data)
        Fm, vjp = jax.vjp(f, z)
        basis = jnp.eye(Fm.shape[0], dtype=z.dtype)
        Jm = jax.vmap(lambda e: vjp(e)[0])(basis)  # (n_mis, m)
        d = d + weight * jnp.sum(Jm * Jm, axis=0)
    return lambda v: v / d


def _whitened_residual_from(spec, arrays, z):
    """Rebuild the stacked whitened residual from the hashable structure
    ``spec`` and the array pytree ``arrays`` (see :func:`_gn_scan`)."""
    parts = []
    for name, residual, use_inv, use_scale in spec[0]:
        v = residual(z, arrays["data"])
        if use_inv:
            v = jnp.matmul(
                arrays["inv"][name], v, precision=jax.lax.Precision.HIGHEST
            )
        else:
            if use_scale:
                v = v * arrays["scale"][name]
            v = whiten(arrays["factors"][name], v)
        parts.append(v)
    for residual, weight in spec[1]:
        parts.append(jnp.sqrt(weight) * residual(z, arrays["data"]))
    return jnp.concatenate(parts)


@partial(
    jax.jit,
    static_argnames=(
        "spec",
        "max_iter",
        "step_size",
        "hessian_jitter",
        "step_solver",
        "cg_tol",
        "cg_maxiter",
        "structure",
        "tol",
    ),
)
def _gn_scan(
    arrays,
    z_init,
    spec,
    max_iter,
    step_size,
    hessian_jitter,
    step_solver,
    cg_tol,
    cg_maxiter,
    structure=None,
    tol=None,
):
    """The compiled GN loop, cache-keyed on problem *structure* not instance.

    ``spec`` = ((name, residual_fn, use_inv, use_scale) per block,
    (misfit_fn, weight) per misfit). Residual functions come from
    ``lru_cache``'d factories in ``models/``, so rebuilding the same problem
    configuration (fresh points/data, same shapes) reuses the executable.
    """
    n = z_init.shape[0]
    hi = jax.lax.Precision.HIGHEST
    wr = lambda z: _whitened_residual_from(spec, arrays, z)

    def build_J_structured(z):
        """Whitened Jacobian panel without the (n x n)@(n x latent) matmul.

        Per block: slice diagonals ``D_j`` (s indicator JVPs, elementwise),
        then ``J[:, slice j] = sum_i W[:, rows_i] * D_j[rows_i]`` - column
        slabs of the precomputed whitening operator, scaled elementwise.
        Misfit rows fall back to a dense (small) jacobian.
        """
        s, N, seginfo = structure
        parts = []
        for (name, residual, use_inv, use_scale), segs in zip(
            spec[0], seginfo
        ):
            D = _block_diagonals(residual, arrays["data"], z, s, N)
            W = arrays["inv"][name]
            cols = []
            for j in range(s):
                acc = None
                for off, sz in segs:
                    if sz != N:
                        continue
                    term = W[:, off : off + sz] * D[j][off : off + sz][None, :]
                    acc = term if acc is None else acc + term
                cols.append(acc)
            parts.append(jnp.concatenate(cols, axis=1))
        for residual, weight in spec[1]:
            Jm = jax.jacfwd(lambda zz: residual(zz, arrays["data"]))(z)
            parts.append(jnp.sqrt(weight) * Jm)
        return jnp.concatenate(parts, axis=0)

    def solve_from_J(r, J):
        H = jnp.matmul(J.T, J, precision=hi)
        g = jnp.matmul(J.T, r, precision=hi)
        return spd_solve(H, g, jitter=hessian_jitter)

    def delta_direct(z):
        r, jvp = jax.linearize(wr, z)
        J = jax.vmap(jvp)(jnp.eye(n, dtype=z.dtype)).T  # (n_resid, n)
        return solve_from_J(r, J)

    def delta_structured(z):
        return solve_from_J(wr(z), build_J_structured(z))

    def delta_cg(z):
        r, jvp = jax.linearize(wr, z)
        _, vjp = jax.vjp(wr, z)

        def normal_op(V):
            HV = jax.vmap(
                lambda v: vjp(jvp(v))[0], in_axes=1, out_axes=1
            )(V)
            if hessian_jitter:
                HV = HV + hessian_jitter * V
            return HV

        g = vjp(r)[0]
        M = _misfit_jacobi_precond(spec[1], arrays["data"], z)
        Mb = None if M is None else M  # columnwise-safe (elementwise scale)
        X, it = _batched_cg(
            normal_op, g[:, None], cg_tol, cg_maxiter, M=Mb
        )
        return X[:, 0], it

    def delta_woodbury(z):
        """Exact step for misfit-coupled problems at any latent dimension:
        CG on the misfit-FREE normal operator (whose spectrum is the
        well-conditioned whitened-GP one - the ``1/noise^2`` misfit rows
        are exactly what stalls plain CG, measured in PERF.md), then the
        rank-K Sherman-Morrison-Woodbury correction through the (K, K)
        capacitance matrix. State beyond the factors: O(m K). See
        :func:`_woodbury_correct`."""
        wr0 = lambda zz: _whitened_residual_from((spec[0], ()), arrays, zz)
        r0, jvp0 = jax.linearize(wr0, z)
        _, vjp0 = jax.vjp(wr0, z)

        def H0(V):
            HV = jax.vmap(
                lambda v: vjp0(jvp0(v))[0], in_axes=1, out_axes=1
            )(V)
            jit_eff = hessian_jitter if hessian_jitter else 0.0
            return HV + jit_eff * V if jit_eff else HV

        g = vjp0(r0)[0]
        for residual, weight in spec[1]:
            f = lambda zz, _r=residual: _r(zz, arrays["data"])
            Fm, vjpm = jax.vjp(f, z)
            g = g + weight * vjpm(Fm)[0]
        U, wvec = _woodbury_pieces(spec[1], arrays["data"], z)
        R = jnp.concatenate([g[:, None], U], axis=1)
        X, it = _batched_cg(H0, R, cg_tol, cg_maxiter)
        return _woodbury_correct(X, U, wvec, hessian_jitter), it

    inner = {
        "cg": delta_cg,
        "woodbury": delta_woodbury,
        "structured": lambda z: (delta_structured(z), jnp.asarray(0)),
        "direct": lambda z: (delta_direct(z), jnp.asarray(0)),
    }[step_solver]

    def step(carry, _):
        z, ok = carry
        delta, it = inner(z)
        z_new = z - step_size * delta
        finite = jnp.all(jnp.isfinite(z_new))
        z_next = jnp.where(finite, z_new, z)
        ok = jnp.logical_and(ok, finite)
        r_next = wr(z_next)
        loss = jnp.dot(r_next, r_next, precision=hi)
        return (z_next, ok), (loss, jnp.asarray(it, jnp.int32))

    if tol is None:
        (z_final, ok), (losses, iters) = jax.lax.scan(
            step, (z_init, jnp.asarray(True)), None, length=max_iter
        )
        return z_final, losses, ok, iters

    # convergence-tolerance mode: iterate until the loss plateaus
    # (|prev - cur| <= tol * cur) or max_iter, as a device-side while_loop
    # (no per-iteration host sync). Motivated by a measured Burgers draw
    # where 8 fixed iterations stop mid-oscillation (loss 130, L2 0.18)
    # while 16 converge (loss 25.4, L2 5.2e-3): a plateau test with a
    # generous cap is the robust configuration for production solves.
    big = jnp.asarray(jnp.finfo(z_init.dtype).max, z_init.dtype)

    def cond(c):
        z, ok, i, losses, iters, prev, cur = c
        plateaued = jnp.abs(prev - cur) <= tol * jnp.maximum(
            cur, jnp.finfo(z_init.dtype).tiny
        )
        return (i < max_iter) & (~plateaued | (i < 2)) & ok

    def body(c):
        z, ok, i, losses, iters, prev, cur = c
        (z2, ok2), (loss, it) = step((z, ok), None)
        losses = jax.lax.dynamic_update_index_in_dim(losses, loss, i, 0)
        iters = jax.lax.dynamic_update_index_in_dim(iters, it, i, 0)
        return (z2, ok2, i + 1, losses, iters, cur, loss)

    z_final, ok, n_it, losses, iters, _, last = jax.lax.while_loop(
        cond, body,
        (z_init, jnp.asarray(True), jnp.asarray(0), jnp.full((max_iter,), big),
         jnp.zeros((max_iter,), jnp.int32), big, big),
    )
    # pad untaken iterations with the final loss so the history is monotone
    losses = jnp.where(jnp.arange(max_iter) < n_it, losses, last)
    return z_final, losses, ok, iters


def gn_solve(
    fp: FactoredProblem,
    z0: jnp.ndarray | None = None,
    max_iter: int = 8,
    step_size: float = 1.0,
    hessian_jitter: float = 0.0,
    step_solver: str = "auto",
    cg_tol: float = 1e-10,
    cg_maxiter: int | None = None,
    tol: float | None = None,
) -> GNState:
    """Run ``max_iter`` Gauss-Newton steps as one compiled ``lax.scan``.

    Each step: linearize the whitened residual at ``z``, solve the GN normal
    system, damped update. Steps producing non-finite iterates are rejected
    (z frozen) rather than poisoning the run.

    ``tol``: optional relative loss-plateau tolerance. When set, iteration
    stops as soon as ``|loss_prev - loss| <= tol * loss`` (device-side
    ``while_loop``, no per-iteration sync) with ``max_iter`` as the cap -
    the robust configuration for unlucky collocation draws where a fixed
    small iteration count stops mid-oscillation (see PERF.md "Burgers
    accuracy parity").

    ``step_solver``:
    * ``'auto'`` (default) - ``'structured'`` when the problem's residuals
      are verified pointwise-per-slice and whitening operators are
      precomputed (``solve_mode='inverse'``, the GPU regime); ``'direct'``
      otherwise.
    * ``'structured'`` - exploit the diagonal-stack raw Jacobian of
      elimination-form collocation problems: the whitened panel is built
      from column-scaled slabs of ``W`` (O(m n N) elementwise) instead of a
      (n x n)@(n x latent) matmul - the dominant per-iteration cost at
      large N disappears; only the ``J^T J`` GEMM remains.
    * ``'direct'`` - materialize the Jacobian panel ``J`` (one batched
      push-forward = one big matmul/TRSM), form ``J^T J`` and solve by
      SPD Cholesky. Right choice while the latent dimension fits (memory
      O(n_resid * latent)).
    * ``'cg'`` - matrix-free conjugate gradients on ``v -> J^T (J v)`` using
      one jvp + one vjp per CG iteration; memory O(n_resid + latent). This
      is the path past the reference's dense limit: at 100k+ collocation
      points the explicit Jacobian panel no longer fits, but whitening keeps
      ``J^T J`` well-conditioned so CG converges quickly.
    * ``'woodbury'`` - for misfit-coupled problems (the Darcy inverse): CG
      on the misfit-FREE normal operator (the ``1/noise^2``-weighted misfit
      rows are exactly what stalls plain CG) against the stacked
      ``[g, J_misfit^T]`` right-hand sides, then the exact rank-K
      Sherman-Morrison-Woodbury correction through the (K, K) capacitance
      matrix (K = total misfit rows, e.g. n_data = 60). Memory beyond the
      factors: O(latent * K). Requires the misfit-free normal operator to
      be positive definite (true whenever every latent slice appears in
      some GP-block residual row, as in all elimination-form problems
      here).

    ``cg_maxiter`` defaults to **500** (not JAX's ``10 * latent_dim``): an
    unconverged hard normal operator would otherwise run a multi-minute
    device-side while_loop that can take down its worker. A step
    truncated by the cap is observable: ``GNState.cg_iters`` records the
    inner iteration count per GN step - ``cg_iters == cg_maxiter`` means
    the tolerance was not reached.
    """
    z_init = fp.problem.init_latent() if z0 is None else jnp.asarray(z0)
    dtype = next(iter(fp.factors.values())).dtype
    z_init = z_init.astype(dtype)
    if cg_maxiter is None:
        cg_maxiter = 500  # hang guard (see docstring); surfaced via cg_iters

    p = fp.problem
    if step_solver == "woodbury" and not p.misfits:
        raise ValueError(
            "step_solver='woodbury' is the misfit-coupled step; this "
            "problem has no misfit terms (use 'cg' or 'direct')"
        )
    structure = None
    if step_solver in ("auto", "structured"):
        cand = _slice_structure(p)
        valid = (
            cand is not None
            and all(b.name in fp.inv_factors for b in p.blocks)
            and _structure_holds(fp, cand)
        )
        if step_solver == "structured" and not valid:
            raise ValueError(
                "step_solver='structured' requires solve_mode='inverse' "
                "factors and pointwise-per-slice residuals (structure "
                "validation failed for this problem)"
            )
        if valid:
            step_solver, structure = "structured", cand
        elif step_solver == "auto":
            step_solver = "direct"
    block_spec = tuple(
        (
            b.name,
            b.residual,
            b.name in fp.inv_factors,
            b.name in fp.col_scales,
        )
        for b in p.blocks
    )
    misfit_spec = tuple((m.residual, float(m.weight)) for m in p.misfits)
    arrays = {
        "factors": dict(fp.factors),
        "inv": dict(fp.inv_factors),
        "scale": dict(fp.col_scales),
        "data": p.data,
    }
    z_final, losses, ok, iters = _gn_scan(
        arrays,
        z_init,
        (block_spec, misfit_spec),
        int(max_iter),
        float(step_size),
        float(hessian_jitter),
        step_solver,
        float(cg_tol),
        cg_maxiter,
        structure=structure,
        tol=None if tol is None else float(tol),
    )
    return GNState(z=z_final, losses=losses, converged_finite=ok, cg_iters=iters)
