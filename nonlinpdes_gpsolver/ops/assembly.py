"""Block Gram-matrix assembly for GP-PDE collocation.

Replaces the per-equation hand-written block layouts of the upstream
assembler (``src/Gram_matrice.py:11-187`` and ``:190-289``) with a single
generic routine driven by a list of :class:`Observable` functionals.
Key differences from upstream:

* no ``jnp.tile``/``transpose``/``flatten`` N^2 coordinate materialization -
  each block is a fused broadcasted closed-form evaluation (XLA fuses the
  difference/polynomial/exp chain into one pass over the output tile);
* no per-block host ``numpy`` writeback - the whole Gram matrix stays on
  device;
* symmetry is exploited by computing only upper blocks and transposing.

The trace-adaptive nugget (upstream ``src/PDEs.py:62-69`` et passim) is kept
verbatim in semantics: derivative blocks get ``nugget * trace(Theta_ii) /
trace(Theta_anchor)`` on their diagonal, identity blocks get ``nugget``,
where the anchor is the union of all identity-functional blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import jax.numpy as jnp

from .kernels import SquaredExponential
from .operators import LinearOp


def _pair_impl(kernel: SquaredExponential, op_x: LinearOp, op_y: LinearOp):
    """Block evaluator: the XLA closed form on every platform. XLA's loop
    fusion emits the difference/polynomial/exp chain as one pass over the
    output block; a Pallas tile kernel on the GPU's Triton route was
    measured no faster (PERF.md, Findings)."""
    return kernel.pair_fn(op_x, op_y)


@dataclasses.dataclass(frozen=True)
class Observable:
    """A batch of linear functionals: ``op`` evaluated at point-set ``points``."""

    points: str  # key into the points dict ('domain', 'boundary', ...)
    op: LinearOp


def observable_sizes(
    observables: Sequence[Observable], points: Dict[str, jnp.ndarray]
) -> Tuple[int, ...]:
    return tuple(points[o.points].shape[0] for o in observables)


def gram_matrix(
    kernel: SquaredExponential,
    observables: Sequence[Observable],
    points: Dict[str, jnp.ndarray],
    dtype=None,
) -> jnp.ndarray:
    """Assemble the symmetric block Gram matrix ``Theta``.

    ``Theta[I, J] = (op_I (x) op_J) kappa`` evaluated on the point panels of
    observables I (rows) and J (columns).
    """
    pts = {k: jnp.asarray(v, dtype=dtype) for k, v in points.items()}
    n = len(observables)
    blocks: list[list[jnp.ndarray]] = [[None] * n for _ in range(n)]
    for i, oi in enumerate(observables):
        for j in range(i, n):
            oj = observables[j]
            fn = _pair_impl(kernel, oi.op, oj.op)
            bij = fn(pts[oi.points], pts[oj.points])
            blocks[i][j] = bij
            if j != i:
                # kappa is symmetric & stationary: Theta[J,I] = Theta[I,J]^T
                blocks[j][i] = bij.T
    return jnp.block(blocks)


def cross_gram(
    kernel: SquaredExponential,
    row_op: LinearOp,
    X_rows: jnp.ndarray,
    observables: Sequence[Observable],
    points: Dict[str, jnp.ndarray],
    dtype=None,
) -> jnp.ndarray:
    """Rectangular cross-covariance between ``row_op`` at ``X_rows`` and the
    training functionals (upstream ``construct_Theta_test``,
    ``src/Gram_matrice.py:190-289``): derivatives land on the y (training)
    side."""
    X_rows = jnp.asarray(X_rows, dtype=dtype)
    pts = {k: jnp.asarray(v, dtype=dtype) for k, v in points.items()}
    blocks = [
        _pair_impl(kernel, row_op, o.op)(X_rows, pts[o.points])
        for o in observables
    ]
    return jnp.concatenate(blocks, axis=1)


def adaptive_nugget_diag(
    theta: jnp.ndarray,
    observables: Sequence[Observable],
    sizes: Sequence[int],
    nugget: float,
    nugget_type: str = "adaptive",
) -> jnp.ndarray:
    """Diagonal regularizer following the upstream trace-ratio rule."""
    n_total = int(sum(sizes))
    if nugget_type == "none":
        return jnp.zeros(n_total, dtype=theta.dtype)
    if nugget_type == "identity":
        return jnp.full(n_total, nugget, dtype=theta.dtype)
    if nugget_type != "adaptive":
        raise ValueError(f"unknown nugget_type {nugget_type!r}")

    offsets = []
    off = 0
    for s in sizes:
        offsets.append(off)
        off += s
    diag = jnp.diagonal(theta)
    # anchor trace: union of identity-functional blocks
    anchor = 0.0
    for o, s, start in zip(observables, sizes, offsets):
        if o.op.is_identity:
            anchor = anchor + jnp.sum(diag[start : start + s])
    parts = []
    for o, s, start in zip(observables, sizes, offsets):
        if o.op.is_identity:
            ratio = jnp.asarray(1.0, dtype=theta.dtype)
        else:
            ratio = jnp.sum(diag[start : start + s]) / anchor
        parts.append(jnp.full(s, nugget, dtype=theta.dtype) * ratio)
    return jnp.concatenate(parts)


def regularized_gram(
    kernel: SquaredExponential,
    observables: Sequence[Observable],
    points: Dict[str, jnp.ndarray],
    nugget: float,
    nugget_type: str = "adaptive",
    dtype=None,
) -> jnp.ndarray:
    theta = gram_matrix(kernel, observables, points, dtype=dtype)
    sizes = observable_sizes(observables, points)
    nug = adaptive_nugget_diag(theta, observables, sizes, nugget, nugget_type)
    return theta + jnp.diag(nug)
