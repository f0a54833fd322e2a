"""Distributed dense Cholesky + triangular solve over a 1-D device mesh.

XLA has no sharded ``cholesky`` - under ``pjit`` a sharded operand is simply
gathered to every device. This module hand-rolls the classic *right-looking
block-cyclic panel algorithm* with ``shard_map`` + XLA collectives, the
equivalent of a ScaLAPACK ``pdpotrf``/``pdtrsm`` (SURVEY.md
section 2, "new components" table - the reference's counterpart is a
single-device ``jnp.linalg.cholesky``, ``src/PDEs.py:77`` upstream):

* the matrix is split into ``nb x nb`` blocks of size ``B``; block-row ``g``
  lives on device ``g % P`` (block-cyclic for load balance as the trailing
  submatrix shrinks);
* step ``k``: the owner's diagonal block is shared (``all_gather`` of one
  ``B x B`` block), every device factors it redundantly (cheaper than a
  broadcast round-trip), locally TRSMs its own below-diagonal blocks of
  panel ``k``, then one ``all_gather`` shares the finished panel column and
  every device applies the rank-``B`` trailing update to its rows - a big
  batched matmul;
* communication per step is ``O(n B)`` (one panel), total ``O(n^2)`` - the
  same asymptotics as the matrix itself; XLA hands the collectives to
  NCCL on the GPU.

The forward substitution (:func:`trsm_blockcyclic`) walks block rows in
order, sharing each owner row once; the right-hand-side block is solved
redundantly on every device so the solution stays replicated (what the
Gauss-Newton step wants - the latent vector is replicated).

Everything runs unchanged on a virtual CPU mesh
(``--xla_force_host_platform_device_count``), which is how the test-suite
checks 1-chip == P-chip equivalence without a pod.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.scipy.linalg import solve_triangular
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P



def pad_to_blocks(n: int, block: int, n_dev: int) -> int:
    """Smallest padded size that is a multiple of ``block * n_dev``."""
    q = block * n_dev
    return ((n + q - 1) // q) * q


def _block_perm(nb: int, P_: int) -> np.ndarray:
    """Permutation placing global block-row ``g = j*P + p`` at sharded
    position ``p*nbl + j`` (device p, slot j)."""
    nbl = nb // P_
    perm = np.empty(nb, dtype=np.int64)
    for p in range(P_):
        for j in range(nbl):
            perm[p * nbl + j] = j * P_ + p
    return perm


@dataclasses.dataclass
class BlockCyclicFactor:
    """Lower Cholesky factor in sharded block-cyclic row layout.

    ``diag_inv`` holds the Newton-refined inverse of every B x B diagonal
    block (replicated, (nb, B, B) in global panel order). The triangular
    solves consume it so each panel step is one GEMM instead of B
    sequential substitution rows - the substitution's sequential depth is
    ``n`` (pure latency per row), the inverse-multiply's is
    ``nb``. It is produced for free by the factorization (which already
    inverts each diagonal block for its own panel solve); use
    :func:`diag_inverses` to reconstruct it for a factor loaded without
    one (e.g. from a round-1 checkpoint).
    """

    local: jax.Array  # (nb, B, n_pad) array sharded over axis 0 by 'p'
    mesh: Mesh
    axis: str
    block: int
    n: int      # original (unpadded) size
    n_pad: int
    diag_inv: jax.Array | None = None  # (nb, B, B) replicated

    def dense(self) -> jnp.ndarray:
        """Gather to a replicated dense (n, n) lower factor (tests only)."""
        nb = self.n_pad // self.block
        perm = _block_perm(nb, self.mesh.shape[self.axis])
        inv = np.argsort(perm)
        blocks = np.asarray(jax.device_get(self.local))[inv]
        full = blocks.reshape(self.n_pad, self.n_pad)
        return jnp.asarray(full[: self.n, : self.n])


def shard_rows_blockcyclic(
    A: np.ndarray, mesh: Mesh, axis: str, block: int
) -> jax.Array:
    """Pad + rearrange a dense (n, n) matrix into the sharded layout.

    Padding extends the diagonal with the identity so the factorization of
    the padded matrix is the factorization of the original plus an identity
    tail.
    """
    n = A.shape[0]
    P_ = mesh.shape[axis]
    n_pad = pad_to_blocks(n, block, P_)
    Ap = np.zeros((n_pad, n_pad), dtype=A.dtype)
    Ap[:n, :n] = np.asarray(A)
    if n_pad > n:
        Ap[range(n, n_pad), range(n, n_pad)] = 1.0
    nb = n_pad // block
    arranged = Ap.reshape(nb, block, n_pad)[_block_perm(nb, P_)]
    sharding = NamedSharding(mesh, P(axis, None, None))
    return jax.device_put(arranged, sharding)


def unshard_rows_blockcyclic(
    local: jax.Array, mesh: Mesh, axis: str, block: int, n: int
) -> np.ndarray:
    nb = local.shape[0]
    inv = np.argsort(_block_perm(nb, mesh.shape[axis]))
    blocks = np.asarray(jax.device_get(local))[inv]
    return blocks.reshape(nb * block, -1)[:n, :n]


def _chol_kernel(local, *, nb: int, B: int, P_: int, axis: str,
                 chunk_cols: int = 4096):
    """shard_map body: local is (nbl, B, n_pad), factored IN PLACE.

    One ``fori_loop`` over all ``nb`` panels; the loop-carried buffer is the
    matrix itself (donated by the caller), updated only through
    ``dynamic_update_slice`` so XLA keeps a single ``n_pad^2/P`` allocation
    alive - the round-1 grouped-window variant materialized a second
    trailing-view copy per group. The trailing rank-``B`` update is applied in fixed-width column
    chunks (``chunk_cols``), each a bounded ``(n_pad/P, chunk)`` temporary;
    the chunk loop starts at the panel's own chunk, so total flops stay
    within ~1.3x of the textbook blocked right-looking count (the partial
    first chunk is masked, not recomputed).

    Per-panel numerics: precision-true recursive factorization of the
    diagonal block (rank-1 leaves, HIGHEST-precision dots), then the
    panel solve ``L_ik = A_ik L_kk^{-T}`` as one batched GEMM against a
    Newton-refined triangular inverse of ``L_kk`` - substitution row-by-row
    over the whole panel is memory-bound and was the measured hot spot.
    """
    from ..ops.linalg import _cholesky_rec, _tri_inverse_rec

    nbl = nb // P_
    n_pad = nb * B
    p = lax.axis_index(axis)
    g_idx = jnp.arange(nbl) * P_ + p
    leaf = min(B, 128)
    Wb = min(nb, max(1, chunk_cols // B))   # block-columns per update chunk
    Wc = Wb * B
    nch = -(-nb // Wb)
    hi = jax.lax.Precision.HIGHEST

    def body(k, carry):
        local, winvs = carry
        kB = k * B
        owner = k % P_
        slot = k // P_
        cand_row = lax.dynamic_index_in_dim(local, slot, 0, keepdims=False)
        diag_cand = lax.dynamic_slice(cand_row, (0, kB), (B, B))
        A_kk = lax.all_gather(diag_cand, axis)[owner]
        # precision-true small factorization (every dot at HIGHEST, see
        # ops.linalg)
        L_kk = _cholesky_rec(A_kk, leaf)
        # refined inverse: one Newton step squares the f32 inverse residual,
        # keeping the GEMM panel solve as accurate as substitution
        W_kk = _tri_inverse_rec(L_kk, leaf)
        E = jnp.eye(B, dtype=local.dtype) - jnp.matmul(W_kk, L_kk, precision=hi)
        W_kk = W_kk + jnp.matmul(E, W_kk, precision=hi)
        winvs = lax.dynamic_update_slice(winvs, W_kk[None], (k, 0, 0))

        colk = lax.dynamic_slice(local, (0, 0, kB), (nbl, B, B))
        # L_ik = A_ik L_kk^{-T} = A_ik W_kk^T - one batched GEMM
        Lcol = jnp.einsum("sbc,dc->sbd", colk, W_kk,
                          preferred_element_type=local.dtype, precision=hi)
        below = (g_idx > k)[:, None, None]
        diag_here = (g_idx == k)[:, None, None]
        new_colk = jnp.where(
            below, Lcol,
            jnp.where(diag_here, jnp.broadcast_to(L_kk, colk.shape), colk),
        )
        local = lax.dynamic_update_slice(local, new_colk, (0, 0, kB))

        # share the finished panel column, zero-masked above the diagonal
        contrib = jnp.where(below, Lcol, 0.0)
        gathered = lax.all_gather(contrib, axis)  # (P, nbl, B, B)
        C = gathered.transpose(1, 0, 2, 3).reshape(n_pad, B)

        # trailing update A_ij -= L_ik L_jk^T, rows below, columns > kB+B,
        # in bounded column chunks updated in place. The last chunk's start
        # is clamped to keep a static width; the logical-range mask keeps
        # the clamped overlap from double-updating.
        def chunk_body(c, local):
            start = jnp.minimum(c * Wb, nb - Wb) * B
            cols = start + jnp.arange(Wc)
            colmask = (cols >= (c * Wc)) & (cols >= kB + B) & (cols < (c + 1) * Wc)
            Cc = lax.dynamic_slice(C, (start, 0), (Wc, B))
            upd = jnp.einsum("sbc,nc->sbn", Lcol, Cc,
                             preferred_element_type=local.dtype, precision=hi)
            upd = jnp.where(below & colmask[None, None, :], upd, 0.0)
            tile = lax.dynamic_slice(local, (0, 0, start), (nbl, B, Wc)) - upd
            return lax.dynamic_update_slice(local, tile, (0, 0, start))

        c0 = (k + 1) // Wb
        local = lax.fori_loop(c0, nch, chunk_body, local)
        return local, winvs

    winvs0 = jnp.zeros((nb, B, B), local.dtype)
    local, winvs = lax.fori_loop(0, nb, body, (local, winvs0))

    # zero the strictly-upper remnants so the result is a clean lower factor
    row_global = g_idx[:, None] * B + jnp.arange(B)[None, :]
    keep = jnp.arange(n_pad)[None, None, :] <= row_global[:, :, None]
    return jnp.where(keep, local, 0.0), winvs


@partial(jax.jit, static_argnums=(1, 2, 3, 4), donate_argnums=(0,))
def _chol_sharded(arranged, mesh: Mesh, axis: str, block: int,
                  chunk_cols: int = 4096):
    """Factor in place: ``arranged`` is donated, so at scale the peak
    per-device footprint is one n_pad^2/P shard plus panel temporaries (the
    caller must take any probe matvec against the unfactored matrix *before*
    this call). Returns ``(lower_factor_shards, diag_inverses)``.

    ``chunk_cols`` bounds the trailing-update temporary width; it is exposed
    (rather than hard-coded) so tests can force the multi-chunk path
    (``nch > 1``) on small matrices - the clamped-start + mask logic
    otherwise first runs on real hardware at n_pad > 4096."""
    nb = arranged.shape[0]
    P_ = mesh.shape[axis]
    fn = shard_map(
        partial(_chol_kernel, nb=nb, B=block, P_=P_, axis=axis,
                chunk_cols=chunk_cols),
        mesh=mesh,
        in_specs=P(axis, None, None),
        out_specs=(P(axis, None, None), P(None, None, None)),
        check_vma=False,
    )
    return fn(arranged)


def diag_inverses(local, mesh: Mesh, axis: str, block: int) -> jax.Array:
    """(Re)build the replicated (nb, B, B) refined diagonal-block inverses
    from a finished factor - for factors that arrived without one (e.g.
    loaded from an old checkpoint)."""
    from ..ops.linalg import _tri_inverse_rec

    nb = local.shape[0]
    P_ = mesh.shape[axis]
    hi = jax.lax.Precision.HIGHEST

    def kern(local):
        p = lax.axis_index(axis)
        nbl = nb // P_

        def one(slot):
            k = slot * P_ + p
            row = lax.dynamic_index_in_dim(local, slot, 0, keepdims=False)
            L_kk = lax.dynamic_slice(row, (0, k * block), (block, block))
            W = _tri_inverse_rec(L_kk, min(block, 128))
            E = jnp.eye(block, dtype=local.dtype) - jnp.matmul(W, L_kk, precision=hi)
            return W + jnp.matmul(E, W, precision=hi)

        mine = jax.vmap(one)(jnp.arange(nbl))          # (nbl, B, B)
        gathered = lax.all_gather(mine, axis)          # (P, nbl, B, B)
        return gathered.transpose(1, 0, 2, 3).reshape(nb, block, block)

    fn = shard_map(
        kern, mesh=mesh, in_specs=P(axis, None, None),
        out_specs=P(None, None, None), check_vma=False,
    )
    return fn(local)


def cholesky_blockcyclic(
    A, mesh: Mesh, axis: str = "p", block: int = 256, chunk_cols: int = 4096
) -> BlockCyclicFactor:
    """Factor a replicated dense SPD matrix across the mesh.

    ``A`` may be a NumPy or JAX array (host layout is rearranged once).
    """
    n = A.shape[0]
    arranged = shard_rows_blockcyclic(np.asarray(A), mesh, axis, block)
    n_pad = arranged.shape[0] * block
    local, winvs = _chol_sharded(arranged, mesh, axis, block, chunk_cols)
    return BlockCyclicFactor(
        local=local, mesh=mesh, axis=axis, block=block,
        n=n, n_pad=n_pad, diag_inv=winvs,
    )


def _matvec_kernel(local, v, *, nb: int, B: int, P_: int, axis: str):
    """``y = A v`` for a block-cyclic row-sharded matrix; v, y replicated.

    Each device contracts its own block rows (one batched matvec),
    then one ``all_gather`` + static re-interleave restores natural row order
    (sharded slot ``(p, j)`` holds global block row ``j*P + p``).
    """
    rows = jnp.einsum(
        "sbn,n->sb", local, v,
        preferred_element_type=v.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    gathered = lax.all_gather(rows, axis)  # (P, nbl, B)
    # global block g = j*P + p lives at gathered[p, j] -> transpose to (j, p)
    return gathered.transpose(1, 0, 2).reshape(nb * B)


def _matvec_t_kernel(local, v, *, nb: int, B: int, P_: int, axis: str):
    """``y = A^T v``: every device contracts its rows against its slice of
    ``v`` and one ``psum`` combines the partial results.

    Written as the canonical GEMV ``v_flat @ local_2d`` (contraction over
    the rhs ROW dimension), NOT an einsum over the block axes: XLA lowers
    ``sbn,sb->n`` by materializing a transposed copy of ``local`` (a full
    n_pad^2/P temporary), while the row-major
    GEMV is a single memory-bound pass."""
    p = lax.axis_index(axis)
    nbl = nb // P_
    g_idx = jnp.arange(nbl) * P_ + p
    v_my = jax.vmap(lambda g: lax.dynamic_slice(v, (g * B,), (B,)))(g_idx)
    part = jnp.matmul(
        v_my.reshape(1, nbl * B), local.reshape(nbl * B, nb * B),
        precision=jax.lax.Precision.HIGHEST,
    )[0]
    return lax.psum(part, axis)


@partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _matvec_sharded(local, v, mesh: Mesh, axis: str, block: int, trans: bool):
    nb = local.shape[0]
    P_ = mesh.shape[axis]
    kern = _matvec_t_kernel if trans else _matvec_kernel
    fn = shard_map(
        partial(kern, nb=nb, B=block, P_=P_, axis=axis),
        mesh=mesh,
        in_specs=(P(axis, None, None), P(None)),
        out_specs=P(None),
        check_vma=False,
    )
    return fn(local, v)


def matvec_blockcyclic(
    local, mesh: Mesh, axis: str, block: int, v, trans: bool = False, n=None
) -> jnp.ndarray:
    """``A v`` (or ``A^T v``) for any matrix in the sharded block-cyclic row
    layout - used by the factor-quality probe (``L (L^T v)`` vs ``A~ v``)
    and anywhere a residual against the *unfactored* sharded matrix is
    needed without gathering it."""
    v = jnp.asarray(v)
    n_pad = local.shape[0] * block
    if n is None:
        n = v.shape[0]
    if n_pad > v.shape[0]:
        v = jnp.concatenate([v, jnp.zeros(n_pad - v.shape[0], dtype=v.dtype)])
    y = _matvec_sharded(local, v, mesh, axis, block, trans)
    return y[:n]


def _trsm_kernel(localL, winvs, V, *, nb: int, B: int, P_: int, axis: str):
    """Forward substitution ``Y = L^{-1} V``.

    The same body serves both RHS layouts: V replicated (n_pad, m) or
    column-sharded (n_pad, m/P per device) - every step's collective is the
    owner-row ``all_gather`` over L only, and each device's columns are
    solved independently. The diagonal solve is one GEMM against the
    factorization's refined block inverse (``winvs``): substitution's
    sequential depth is n rows, the inverse-multiply's is nb panels."""
    hi = jax.lax.Precision.HIGHEST

    def body(k, Y):
        kB = k * B
        owner = k % P_
        slot = k // P_
        cand_row = lax.dynamic_index_in_dim(localL, slot, 0, keepdims=False)
        row = lax.all_gather(cand_row, axis)[owner]  # (B, n_pad), correct row
        # Y above kB is already solved; at/below kB it is still zero, and
        # row[:, > diag] is zero in the factor, so row @ Y picks exactly the
        # solved prefix.
        prod = jnp.matmul(row, Y, precision=hi)
        rhs = lax.dynamic_slice(V, (kB, 0), (B, V.shape[1])) - prod
        W_kk = lax.dynamic_index_in_dim(winvs, k, 0, keepdims=False)
        yk = jnp.matmul(W_kk, rhs, precision=hi)
        return lax.dynamic_update_slice(Y, yk, (kB, 0))

    return lax.fori_loop(0, nb, body, jnp.zeros_like(V))


def _trsm_t_kernel(localL, winvs, V, *, nb: int, B: int, P_: int, axis: str):
    """Backward substitution ``Y = L^{-T} V``; V and Y replicated (n_pad, m).

    Column ``k`` of ``L`` is spread over the row owners, so each step is a
    local partial product + one ``psum`` - the transpose-apply analog of the
    forward solve's owner-row broadcast. Diagonal solve: ``W_kk^T rhs``
    against the refined block inverse.
    """
    p = lax.axis_index(axis)
    nbl = nb // P_
    g_idx = jnp.arange(nbl) * P_ + p
    m = V.shape[1]
    hi = jax.lax.Precision.HIGHEST

    def body(i, Y):
        k = nb - 1 - i
        kB = k * B
        colk = lax.dynamic_slice(localL, (0, 0, kB), (nbl, B, B))
        Yblk = jax.vmap(
            lambda g: lax.dynamic_slice(Y, (g * B, 0), (B, m))
        )(g_idx)
        below = (g_idx > k)[:, None, None]
        partial_sum = jnp.einsum(
            "sbc,sbm->cm",
            jnp.where(below, colk, 0.0),
            Yblk,
            preferred_element_type=Y.dtype,
            precision=hi,
        )
        total = lax.psum(partial_sum, axis)
        rhs = lax.dynamic_slice(V, (kB, 0), (B, m)) - total
        W_kk = lax.dynamic_index_in_dim(winvs, k, 0, keepdims=False)
        yk = jnp.matmul(W_kk.T, rhs, precision=hi)
        return lax.dynamic_update_slice(Y, yk, (kB, 0))

    return lax.fori_loop(0, nb, body, jnp.zeros_like(V))


def _trsm_t_kernel_cols(localL, winvs, V, *, nb: int, B: int, P_: int, axis: str):
    """Backward substitution ``Y = L^{-T} V`` for a *column-sharded* RHS
    (V local is (n_pad, m/P)).

    The replicated-RHS transpose kernel reduces partial products with a
    ``psum`` - wrong here, since each device's partials belong to different
    column shards. Instead each step ``all_gather``s block-*column* ``k`` of
    ``L`` (the transpose-apply analog of the forward solve's owner-row
    gather; same O(nB) bytes) and every device contracts it against its own
    columns locally. ``Y`` rows at/above block ``k`` are still zero and
    strictly-upper blocks of ``L`` are zero in the factor, so the unmasked
    ``C^T Y`` picks exactly the solved suffix, and rows ``kB:kB+B`` of the
    gathered column are ``L_kk`` itself."""
    m = V.shape[1]
    nbl = nb // P_
    n_pad = nb * B
    hi = jax.lax.Precision.HIGHEST

    def body(i, Y):
        k = nb - 1 - i
        kB = k * B
        colk = lax.dynamic_slice(localL, (0, 0, kB), (nbl, B, B))
        gathered = lax.all_gather(colk, axis)  # (P, nbl, B, B)
        C = gathered.transpose(1, 0, 2, 3).reshape(n_pad, B)
        total = jnp.matmul(C.T, Y, precision=hi)
        rhs = lax.dynamic_slice(V, (kB, 0), (B, m)) - total
        W_kk = lax.dynamic_index_in_dim(winvs, k, 0, keepdims=False)
        yk = jnp.matmul(W_kk.T, rhs, precision=hi)
        return lax.dynamic_update_slice(Y, yk, (kB, 0))

    return lax.fori_loop(0, nb, body, jnp.zeros_like(V))


@partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def _trsm_sharded(
    localL, winvs, V, mesh: Mesh, axis: str, block: int, trans: bool,
    shard_cols: bool = False,
):
    nb = localL.shape[0]
    P_ = mesh.shape[axis]
    if shard_cols:
        # forward body is layout-agnostic; transpose needs the column-gather
        kern = _trsm_t_kernel_cols if trans else _trsm_kernel
        vspec = P(None, axis)
    else:
        kern = _trsm_t_kernel if trans else _trsm_kernel
        vspec = P(None, None)
    fn = shard_map(
        partial(kern, nb=nb, B=block, P_=P_, axis=axis),
        mesh=mesh,
        in_specs=(P(axis, None, None), P(None, None, None), vspec),
        out_specs=vspec,
        check_vma=False,
    )
    return fn(localL, winvs, V)


def trsm_blockcyclic(
    factor: BlockCyclicFactor, V, trans: bool = False, shard_cols: bool = False
) -> jnp.ndarray:
    """``L^{-1} V`` (or ``L^{-T} V`` with ``trans``) for a block-cyclic
    factor.

    ``shard_cols=False``: V is (n, m) replicated (latent-sized panels, the
    Gauss-Newton default). ``shard_cols=True``: V is column-sharded over the
    mesh axis - per-device memory drops to ``n * m/P`` (round-1 VERDICT weak
    item 3: whitening a wide Jacobian panel must not replicate it). Columns
    are zero-padded to a multiple of the mesh size and sliced back.
    """
    V = jnp.asarray(V)
    squeeze = V.ndim == 1
    if squeeze:
        V = V[:, None]
    n, m = V.shape
    if n != factor.n:
        raise ValueError(f"V has {n} rows, factor expects {factor.n}")
    if factor.n_pad > n:
        V = jnp.concatenate(
            [V, jnp.zeros((factor.n_pad - n, m), dtype=V.dtype)]
        )
    m_pad = m
    if shard_cols:
        P_ = factor.mesh.shape[factor.axis]
        m_pad = ((m + P_ - 1) // P_) * P_
        if m_pad > m:
            V = jnp.concatenate(
                [V, jnp.zeros((V.shape[0], m_pad - m), dtype=V.dtype)], axis=1
            )
        V = jax.lax.with_sharding_constraint(
            V, NamedSharding(factor.mesh, P(None, factor.axis))
        )
    if factor.diag_inv is None:
        factor.diag_inv = diag_inverses(
            factor.local, factor.mesh, factor.axis, factor.block
        )
    Y = _trsm_sharded(
        factor.local, factor.diag_inv, V, factor.mesh, factor.axis,
        factor.block, trans, shard_cols,
    )
    Y = Y[: factor.n]
    if m_pad > m:
        Y = Y[:, :m]
    return Y[:, 0] if squeeze else Y


def kernel_solve_blockcyclic(factor: BlockCyclicFactor, V) -> jnp.ndarray:
    """``Theta^{-1} V = L^{-T} L^{-1} V`` - distributed representer weights."""
    return trsm_blockcyclic(factor, trsm_blockcyclic(factor, V), trans=True)
