"""Fused streaming assembly + factorization: the Gram matrix is never
materialized.

SURVEY.md section 7 "hard parts" item 5 (assembly/factorization overlap at
scale): the two-pass path (:func:`.gram.assemble_gram_sharded` writing the
full equilibrated Gram shard, then :func:`.cholesky._chol_sharded` factoring
it in place) streams the whole ``n^2/P`` shard through HBM twice and
evaluates derivative-kernel tiles for BOTH triangles of a symmetric matrix.
This module fuses the two into a single *left-looking* block-cyclic
factorization organized in **superblocks** of ``S`` columns (round-4 rewrite;
the round-3 per-panel kernel assembled and updated every local row at every
panel step, which cost full-``n^2`` kernel evaluations and ``n^3/2`` update
MACs - more than the right-looking path):

* the outer superblock loop is unrolled at trace time, so each step slices
  the factor to the statically-known trailing rows ``>= S * j`` - kernel
  evaluations cover the lower triangle only (``n^2/2 + n S/2`` evaluations)
  and the left-looking update GEMM runs at the textbook ``n^3/6`` MAC count;
* the update contracts ``L[trailing rows, :c0] @ L[superblock rows, :c0]^T``
  in ``S``-wide output panels - one large GEMM per column chunk instead
  of the per-``B``-panel rank-``B`` updates of the round-3 kernel, whose
  all_gather -> B x B factor -> GEMM critical path left the matmul units
  idle between panels;
* the ``S x S`` superblock diagonal is factored once (replicated, recursive
  precision-controlled Cholesky + Newton-refined triangular inverse) and the
  whole below-superblock panel solve is a single ``(rows, S) @ (S, S)``
  GEMM; the per-``B``-block diagonal inverses the distributed TRSMs consume
  are the diagonal blocks of the refined ``W_sup`` (exact: the diagonal
  blocks of a triangular inverse are the inverses of the diagonal blocks,
  and the Newton correction restricted to a diagonal block is the
  per-block Newton correction);
* HBM write traffic per superblock is one column panel (the factor is
  written exactly once; the right-looking path rewrites the trailing shard
  every panel step);
* per-device peak memory is the ``n_pad^2/P`` factor shard (allocated zero
  and donated) plus one ``(rows/P, S)`` column panel and a ``(S, chunk)``
  gathered row strip.

Zero-initialization is load-bearing: at superblock ``j`` every read of ``L``
columns ``>= c0 = j*S`` returns 0 (those columns are written only at their
own step), so the chunked update GEMMs need no masking - a chunk that
overruns ``c0`` contracts against zeros on both operands.

The matrix A~ being factored is identical (same tile evaluators, same
trace-adaptive nugget, same equilibration) to the two-pass path's - asserted
by equivalence tests on the virtual CPU mesh (to factorization accuracy; the
contraction order differs, so agreement is to rounding, not bitwise). Since
A~ never exists, the factor-quality guard uses :func:`sampled_row_quality`:
a handful of statically-chosen rows of A~ are re-assembled independently
(cost ``O(sample * n)``) and compared against ``L (L^T v)`` on a fixed probe
vector - the same finite-but-corrupt-factor failure class coverage as the
full pre-factorization matvec (a corrupt factor corrupts essentially every
row product), at negligible cost.

In-executable nugget escalation: a too-small nugget at f32 shows up as a
non-finite superblock Cholesky. That block is computed from all_gather'd
(hence REPLICATED) rows, so every device sees the same failure flag; the
remaining superblocks are skipped through replicated ``lax.cond``s (branch
choice replicated, so the collectives stay aligned), and a device-side
while_loop multiplies the nugget scale tenfold and restarts on the zeroed
buffer. A failed attempt costs only the superblocks up to first failure and
no host round trip. Non-finite entries confined to one device's
off-diagonal rows reach the next replicated superblock diagonal, so
detection is at most one superblock late, never missed. The finite-but-WRONG
factor class (round-1 backend miscompile) is invisible to finiteness checks
by construction; the sampled-row probe guards it.

Reference counterpart: none (the reference assembles dense host-side numpy,
``src/Gram_matrice.py:11-187`` upstream, and calls ``jnp.linalg.cholesky``,
``src/PDEs.py:75-80`` upstream).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.assembly import cross_gram
from .cholesky import BlockCyclicFactor, _block_perm, pad_to_blocks
from .gram import _segments


def _superblocks(nb: int, F: int):
    """Static partition of the ``nb`` block-columns into superblocks of at
    most ``F`` block-columns (the last may be smaller)."""
    F = max(1, min(F, nb))
    return [(k, min(F, nb - k)) for k in range(0, nb, F)]


def _seg_ranges(segs, c0: int, c1: int, n: int):
    """Static (op, lo, hi) column ranges of the global segment layout cut to
    the window ``[c0, c1)`` (offsets relative to ``c0``), with ``op=None``
    for the padding tail beyond ``n``."""
    ranges = []
    for start, size, op in segs:
        lo, hi = max(start, c0), min(start + size, c1)
        if hi > lo:
            ranges.append((op, lo - c0, hi - c0))
    if c1 > n:
        ranges.append((None, max(n, c0) - c0, c1 - c0))
    return ranges


def _fused_chol_kernel(
    local, Xrow, Xcols, diag_const_pad, nug_share_pad, s0, *,
    kernel, segs, nb: int, B: int, P_: int, axis: str, n: int,
    chunk_cols: int = 4096, superblock_cols: int = 2048,
    assemble_rows: int = 8192, max_attempts: int = 8,
):
    """shard_map body: superblock left-looking fused assemble+factorize with
    in-executable nugget escalation (see module docstring).

    ``local`` (nbl, B, n_pad): this device's ZERO-INITIALIZED donated factor
    shard. ``Xrow`` (nbl, B, d): its block-cyclic row coordinates.
    ``Xcols`` (n_pad, d): replicated. ``diag_const_pad``/``nug_share_pad``
    (n_pad,): the per-row stationary diagonal constant and its trace-
    adaptive nugget share, so the equilibration ``d^{-1/2} =
    rsqrt(c + s * nug)`` is recomputed per attempt from the live scale
    ``s``. Returns ``(factor shard, diag inverses, d_isqrt_pad, s, ok)``.
    """
    from ..ops.linalg import _cholesky_rec, _tri_inverse_rec

    nbl = nb // P_
    n_pad = nb * B
    dim = Xcols.shape[1]
    p = lax.axis_index(axis)
    leaf = min(B, 128)
    Wc = max(1, chunk_cols // B) * B
    hi = jax.lax.Precision.HIGHEST
    one = jnp.asarray(1.0, local.dtype)

    row_ops = []
    for _, _, op in segs:
        if op not in row_ops:
            row_ops.append(op)

    def _row_mask(rop, row_global):
        m = jnp.zeros(row_global.shape, bool)
        for start, size, o in segs:
            if o == rop:
                m = m | ((row_global >= start) & (row_global < start + size))
        return m

    sbs = _superblocks(nb, max(1, superblock_cols // B))

    def _do_superblock(local, winvs, d_isqrt_pad, kb0, F):
        c0, S = kb0 * B, F * B
        s_lo = kb0 // P_                  # first local slot any device needs
        nsl = nbl - s_lo                  # trimmed trailing slots
        s_hi = (kb0 + F - 1) // P_ + 1    # slots spanning the superblock rows
        nsg = s_hi - s_lo
        # static (owner device, trimmed slot) of each superblock block-row
        owners = [((kb0 + f) % P_, (kb0 + f) // P_ - s_lo) for f in range(F)]

        g_idx = jnp.arange(s_lo, nbl) * P_ + p
        row_global = (g_idx[:, None] * B + jnp.arange(B)[None, :]).reshape(-1)
        Xr = lax.slice_in_dim(Xrow, s_lo, nbl, axis=0).reshape(nsl * B, dim)
        dr = d_isqrt_pad[row_global]

        # assemble my trailing rows of (equilibrated, regularized) columns
        # [c0, c0+S) - the only kernel evaluations this superblock performs.
        # The tile evaluator is the XLA closed form (kernel.pair_fn), which
        # materializes a (rows, w, dim) broadcasted-difference temporary, so
        # the window is assembled in bounded ROW chunks (``assemble_rows``)
        # - unchunked, the temporaries alone outgrow device memory at
        # card-filling sizes. The last chunk's start is clamped; the
        # overlap recomputes identical values.
        h = nsl * B
        Rch = min(h, max(B, (assemble_rows // B) * B))
        nrc = -(-h // Rch)
        ranges = _seg_ranges(segs, c0, c0 + S, n)
        dc = lax.slice_in_dim(d_isqrt_pad, c0, c0 + S, axis=0)

        def row_chunk(i, Acol):
            r0 = jnp.minimum(i * Rch, h - Rch)
            Xr_c = lax.dynamic_slice(Xr, (r0, 0), (Rch, dim))
            rg_c = lax.dynamic_slice(row_global, (r0,), (Rch,))
            dr_c = lax.dynamic_slice(dr, (r0,), (Rch,))
            pieces = []
            for cop, lo, hi_ in ranges:
                w = hi_ - lo
                if cop is None:
                    pieces.append(jnp.zeros((Rch, w), local.dtype))
                    continue
                Xc_sub = lax.slice_in_dim(Xcols, c0 + lo, c0 + hi_, axis=0)
                piece = jnp.zeros((Rch, w), local.dtype)
                for rop in row_ops:
                    K = kernel.pair_fn(rop, cop)(Xr_c, Xc_sub)
                    piece = jnp.where(_row_mask(rop, rg_c)[:, None], K, piece)
                pieces.append(piece)
            acc = (
                pieces[0] if len(pieces) == 1
                else jnp.concatenate(pieces, axis=1)
            )
            acc = acc * (dr_c[:, None] * dc[None, :])
            on_diag = (c0 + jnp.arange(S))[None, :] == rg_c[:, None]
            acc = jnp.where(on_diag, one, acc)
            return lax.dynamic_update_slice(Acol, acc, (r0, 0))

        Acol = lax.fori_loop(
            0, nrc, row_chunk, jnp.zeros((h, S), local.dtype)
        )  # (nsl*B, S)

        # left-looking update: Acol -= L[trailing, :c0] @ L[sup rows, :c0]^T
        # in column chunks; chunks may overrun c0 (both operands read zeros
        # there - those columns are unwritten). One (nsl*B, Wc) x (Wc, S)
        # GEMM per chunk: large GEMMs, no per-B-panel critical path.
        if c0:
            Wc_j = min(Wc, n_pad - c0)   # keeps the last chunk in bounds
            nch = -(-c0 // Wc_j)

            def chunk_body(c, Acol):
                start = c * Wc_j
                Lc = lax.dynamic_slice(
                    local, (s_lo, 0, start), (nsl, B, Wc_j)
                ).reshape(nsl * B, Wc_j)
                cand = lax.dynamic_slice(
                    local, (s_lo, 0, start), (nsg, B, Wc_j)
                )
                g = lax.all_gather(cand, axis)  # (P, nsg, B, Wc_j)
                R = jnp.stack([g[o, sl] for o, sl in owners]).reshape(S, Wc_j)
                return Acol - jnp.matmul(Lc, R.T, precision=hi)

            Acol = lax.fori_loop(0, nch, chunk_body, Acol)
        Acol3 = Acol.reshape(nsl, B, S)

        # replicated S x S superblock diagonal: factor once, refine inverse
        diag_cand = lax.slice_in_dim(Acol3, 0, nsg, axis=0)
        gg = lax.all_gather(diag_cand, axis)  # (P, nsg, B, S)
        Dsup = jnp.concatenate(
            [gg[o, sl][None] for o, sl in owners], axis=0
        ).reshape(S, S)
        L_sup = _cholesky_rec(Dsup, leaf)
        fin = jnp.all(jnp.isfinite(L_sup))  # REPLICATED failure signal
        W_sup = _tri_inverse_rec(L_sup, leaf)
        E = jnp.eye(S, dtype=local.dtype) - jnp.matmul(W_sup, L_sup, precision=hi)
        W_sup = W_sup + jnp.matmul(E, W_sup, precision=hi)
        # per-B-block diagonal inverses for the TRSMs: diagonal blocks of a
        # (refined) triangular inverse ARE the (refined) per-block inverses
        Wd = jnp.stack(
            [W_sup[f * B:(f + 1) * B, f * B:(f + 1) * B] for f in range(F)]
        )
        winvs = lax.dynamic_update_slice(winvs, Wd, (kb0, 0, 0))

        # panel solve for every trailing row in ONE GEMM; superblock rows
        # take L_sup itself, stray rows above the superblock (block-cyclic
        # slack, < P of them) are zeroed
        Lcol = jnp.einsum("sbc,dc->sbd", Acol3, W_sup,
                          preferred_element_type=local.dtype, precision=hi)
        Lsup3 = L_sup.reshape(F, B, S)
        cand_diag = Lsup3[jnp.clip(g_idx - kb0, 0, F - 1)]
        below = (g_idx >= kb0 + F)[:, None, None]
        in_diag = ((g_idx >= kb0) & (g_idx < kb0 + F))[:, None, None]
        new_col = jnp.where(
            below, Lcol,
            jnp.where(in_diag, cand_diag, jnp.zeros_like(Lcol)),
        )
        local = lax.dynamic_update_slice(local, new_col, (s_lo, 0, c0))
        return local, winvs, fin

    def factor_once(local, winvs, d_isqrt_pad):
        ok = jnp.asarray(True)
        for kb0, F in sbs:
            # replicated predicate: all devices take the same branch, so the
            # collectives inside stay aligned; after a failure the remaining
            # superblocks each cost one skipped cond
            local, winvs, fin = lax.cond(
                ok,
                lambda a, kb0=kb0, F=F: _do_superblock(
                    a[0], a[1], d_isqrt_pad, kb0, F
                ),
                lambda a: (a[0], a[1], jnp.asarray(True)),
                (local, winvs),
            )
            ok = ok & fin
        return local, winvs, ok

    def attempt_cond(carry):
        local, winvs, d_pad, s, att, ok = carry
        return (~ok) & (att < max_attempts)

    def attempt_body(carry):
        local, winvs, d_pad, s, att, ok = carry
        d_pad = jax.lax.rsqrt(diag_const_pad + s * nug_share_pad)
        local = jnp.zeros_like(local)
        local, winvs, ok = factor_once(local, winvs, d_pad)
        s_next = jnp.where(ok, s, s * 10.0)
        return local, winvs, d_pad, s_next, att + 1, ok

    d_pad0 = jax.lax.rsqrt(diag_const_pad + s0 * nug_share_pad)
    init = (
        local, jnp.zeros((nb, B, B), local.dtype), d_pad0,
        jnp.asarray(s0, local.dtype), jnp.asarray(0), jnp.asarray(False),
    )
    local, winvs, d_pad, s, att, ok = lax.while_loop(
        attempt_cond, attempt_body, init
    )
    # s was advanced past the used value only on failure; on success it is
    # the scale the accepted factor used
    return local, winvs, d_pad, s, ok


@partial(
    jax.jit, static_argnums=(1, 2, 5, 6, 7, 8, 9, 10, 11, 12),
    donate_argnums=(0,)
)
def _fused_arranged(
    out,
    kernel,
    observables,
    points,
    nugget_scale,
    nugget_type: str,
    nugget: float,
    mesh: Mesh,
    axis: str,
    block: int,
    chunk_cols: int = 4096,
    superblock_cols: int = 2048,
    assemble_rows: int = 8192,
):
    """One executable: equilibration constants + fused assemble/factorize
    with in-executable nugget escalation.

    Mirrors the preamble of ``gram._assemble_arranged`` (same trace-adaptive
    nugget rule, same block-cyclic row-coordinate arrangement), then runs
    the superblock left-looking kernel. ``nugget_scale`` is the traced
    escalation STARTING scale. Returns ``(factor shards, diag inverses,
    d_isqrt, s, ok)`` with ``s`` the scale the accepted factor actually
    used.
    """
    from .gram import _equilibration_parts

    segs_pts = _segments(observables, points)
    X_all = jnp.concatenate(
        [jnp.asarray(points[o.points]) for o in observables], axis=0
    )
    n, dim = X_all.shape
    dtype = X_all.dtype
    c_vec, nug_vec = _equilibration_parts(
        kernel, segs_pts, nugget_type, nugget, dtype
    )

    P_ = mesh.shape[axis]
    n_pad = pad_to_blocks(n, block, P_)
    nb = n_pad // block
    pad = n_pad - n
    # padded identity tail: constant 1, no nugget -> d = 1 exactly
    c_pad = jnp.concatenate([c_vec, jnp.ones(pad, dtype)])
    nug_pad = jnp.concatenate([nug_vec, jnp.zeros(pad, dtype)])
    X_pad = jnp.pad(X_all, ((0, pad), (0, 0)), mode="edge")
    perm = _block_perm(nb, P_)
    Xrow = X_pad.reshape(nb, block, dim)[perm]
    Xrow = jax.lax.with_sharding_constraint(
        Xrow, NamedSharding(mesh, P(axis, None, None))
    )

    fn = shard_map(
        partial(
            _fused_chol_kernel,
            kernel=kernel, segs=segs_pts, nb=nb, B=block, P_=P_,
            axis=axis, n=n, chunk_cols=chunk_cols,
            superblock_cols=superblock_cols, assemble_rows=assemble_rows,
        ),
        mesh=mesh,
        in_specs=(
            P(axis, None, None), P(axis, None, None), P(None, None),
            P(None), P(None), P(),
        ),
        out_specs=(
            P(axis, None, None), P(None, None, None), P(None), P(), P(),
        ),
        check_vma=False,
    )
    local, winvs, d_pad, s, ok = fn(
        out, Xrow, X_pad, c_pad, nug_pad, jnp.asarray(nugget_scale, dtype)
    )
    return local, winvs, d_pad[:n], s, ok


def assemble_factor_fused(
    kernel,
    observables: Tuple,
    points,
    mesh: Mesh,
    axis: str = "p",
    block: int = 256,
    nugget: float = 1e-10,
    nugget_type: str = "adaptive",
    nugget_scale=1.0,
    chunk_cols: int = 4096,
    superblock_cols: int = 2048,
    assemble_rows: int = 8192,
):
    """Factor the (never-materialized) equilibrated regularized Gram matrix.

    Returns ``(BlockCyclicFactor, d_isqrt, s, ok)`` - drop-in for the
    ``assemble_gram_sharded`` + ``cholesky`` pair: lower-triangle-only
    kernel evaluations, ``n^3/6`` update MACs in superblock-wide GEMMs, one
    executable launch (see module docstring). ``s``/``ok`` are DEVICE
    scalars: the nugget-escalation scale the in-executable ladder settled on
    starting from ``nugget_scale``, and whether the factor is finite (fetch
    them together with other results - no sync here). ``superblock_cols``
    sets the column-panel width ``S`` (the GEMM-efficiency / replicated
    ``S x S``-diagonal-work tradeoff; 2048 was tuned on the platform this
    solver was first built for and is not re-measured on the H100,
    ROADMAP A8)."""
    pts = {k: jnp.asarray(v) for k, v in points.items()}
    observables = tuple(observables)
    n = sum(int(pts[o.points].shape[0]) for o in observables)
    dtype = jnp.result_type(*(pts[o.points] for o in observables))
    P_ = mesh.shape[axis]
    n_pad = pad_to_blocks(n, block, P_)
    nb = n_pad // block
    sharding = NamedSharding(mesh, P(axis, None, None))
    out = jax.jit(
        lambda: jnp.zeros((nb, block, n_pad), dtype), out_shardings=sharding
    )()
    local, winvs, d_isqrt, s, ok = _fused_arranged(
        out, kernel, observables, pts, jnp.asarray(nugget_scale),
        nugget_type, nugget, mesh, axis, block, chunk_cols, superblock_cols,
        assemble_rows,
    )
    fac = BlockCyclicFactor(
        local=local, mesh=mesh, axis=axis, block=block,
        n=n, n_pad=n_pad, diag_inv=winvs,
    )
    return fac, d_isqrt, s, ok


# --------------------------------------------------------------------------
# sampled-row factor-quality probe
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnums=(0, 1, 3))
def _sampled_rows_matvec(kernel, observables, points, row_layout, d_isqrt, v):
    """``y_S = A~[S, :] v`` for the statically-chosen sample rows - the rows
    are re-assembled here via ``cross_gram`` strips (independent of the
    factorization), so agreement with ``L(L^T v)`` checks the factor against
    ground truth. ``row_layout`` = tuple of (op, points key, segment row
    offset, local indices tuple) per segment."""
    n = d_isqrt.shape[0]
    vn = v[:n] * d_isqrt
    parts = []
    for (op, pts_key, off, idx) in row_layout:
        X_rows = jnp.asarray(points[pts_key])[jnp.asarray(idx)]
        strip = cross_gram(kernel, op, X_rows, observables, points)
        y = jnp.matmul(strip, vn, precision=jax.lax.Precision.HIGHEST)
        rows = off + jnp.asarray(idx)
        d_r = d_isqrt[rows]
        y = y * d_r
        # the assembled matrix has an exact unit diagonal (nugget folded into
        # d): correct the sampled rows' diagonal term theta(x,x)*d^2 -> 1
        c = kernel.pair_fn(op, op)(X_rows[:1], X_rows[:1])[0, 0]
        y = y + v[rows] * (1.0 - d_r * d_r * c)
        parts.append((rows, y))
    rows = jnp.concatenate([r for r, _ in parts])
    ys = jnp.concatenate([y for _, y in parts])
    return rows, ys


def sampled_row_quality(
    fac: BlockCyclicFactor,
    kernel,
    observables,
    points,
    d_isqrt,
    rows_per_segment: int = 32,
) -> jnp.ndarray:
    """Relative residual ``max|(L L^T v - A~ v)[S]| / max|A~ v[S]|`` on a
    fixed probe vector over statically-sampled rows S (``rows_per_segment``
    evenly spaced rows from every observable segment, so every operator
    block is covered). Returns a device scalar - callers fetch it together
    with their other results."""
    from .cholesky import matvec_blockcyclic

    pts = {k: jnp.asarray(v) for k, v in points.items()}
    observables = tuple(observables)
    segs = _segments(observables, pts)
    layout = []
    for o, (off, size, op) in zip(observables, segs):
        take = min(rows_per_segment, size)
        idx = tuple(np.linspace(0, size - 1, take).astype(int).tolist())
        layout.append((op, o.points, off, idx))
    n_pad = fac.n_pad
    v = jnp.asarray(
        np.random.default_rng(0).standard_normal(n_pad), fac.local.dtype
    )
    rows, y = _sampled_rows_matvec(
        kernel, observables, pts, tuple(layout), d_isqrt, v
    )
    w = matvec_blockcyclic(
        fac.local, fac.mesh, fac.axis, fac.block,
        matvec_blockcyclic(fac.local, fac.mesh, fac.axis, fac.block, v,
                           trans=True, n=n_pad),
        n=n_pad,
    )
    w_s = w[rows]
    return jnp.max(jnp.abs(w_s - y)) / jnp.max(jnp.abs(y))
