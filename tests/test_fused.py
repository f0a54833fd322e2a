"""Fused streaming assemble+factorize (``parallel/fused.py``): equivalence
with the two-pass path, superblock/chunk coverage, sampled-row probe
sensitivity, and end-to-end solver integration."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nonlinpdes_gpsolver.ops import (
    Observable,
    SquaredExponential,
    d,
    d2,
    identity,
    laplacian,
)
from nonlinpdes_gpsolver.parallel.cholesky import (
    _chol_sharded,
    unshard_rows_blockcyclic,
)
from nonlinpdes_gpsolver.parallel.fused import (
    _seg_ranges,
    _superblocks,
    assemble_factor_fused,
    sampled_row_quality,
)
from nonlinpdes_gpsolver.parallel.gram import _segments, assemble_gram_sharded
from nonlinpdes_gpsolver.parallel.mesh import make_mesh


def _elliptic_setup(n_dom=70, n_bd=22, f32=False):
    rng = np.random.default_rng(0)
    dt = np.float32 if f32 else np.float64
    Xd = jnp.asarray(rng.uniform(0, 1, (n_dom, 2)).astype(dt))
    Xb = jnp.asarray(rng.uniform(0, 1, (n_bd, 2)).astype(dt))
    k = SquaredExponential.gaussian(0.3)
    obs = (
        Observable("domain", laplacian()),
        Observable("domain", identity()),
        Observable("boundary", identity()),
    )
    return k, obs, {"domain": Xd, "boundary": Xb}, n_dom + n_dom + n_bd


def _burgers_setup():
    """4 operators with uneven segment sizes - exercises superblocks that
    straddle segment boundaries."""
    rng = np.random.default_rng(1)
    Xd = jnp.asarray(rng.uniform(0, 1, (37, 2)))
    Xb = jnp.asarray(rng.uniform(0, 1, (13, 2)))
    k = SquaredExponential.anisotropic((3.0, 20.0), "precision")
    obs = (
        Observable("domain", d(0)),
        Observable("domain", d(1)),
        Observable("domain", d2(1, 1)),
        Observable("domain", identity()),
        Observable("boundary", identity()),
    )
    return k, obs, {"domain": Xd, "boundary": Xb}, 4 * 37 + 13


@pytest.mark.parametrize("P_", [1, 4, 8])
@pytest.mark.parametrize(
    "block,chunk,sup",
    [(8, 8, 16), (8, 24, 32), (16, 10**9, 16), (16, 64, 10**9)],
)
def test_fused_matches_two_pass_elliptic(eight_devices, P_, block, chunk, sup):
    """The superblock left-looking factor must whiten the same A~ the
    two-pass right-looking path factors. The contraction orders differ
    (superblock-wide GEMMs vs per-panel rank-B updates), so agreement is to
    factorization accuracy, not bitwise; the sampled-row probe then checks
    L L^T against independently re-assembled rows of A~ (ground truth)."""
    k, obs, pts, n = _elliptic_setup()
    mesh = make_mesh(P_)
    arranged, d1 = assemble_gram_sharded(
        k, obs, pts, mesh, block=block, nugget=1e-4
    )
    lower, _ = _chol_sharded(arranged, mesh, "p", block, chunk)
    Lt = unshard_rows_blockcyclic(lower, mesh, "p", block, n)
    fac, d2_, s_dev, ok_dev = assemble_factor_fused(
        k, obs, pts, mesh, block=block, nugget=1e-4, chunk_cols=chunk,
        superblock_cols=sup,
    )
    assert bool(ok_dev) and float(s_dev) == 1.0  # single in-kernel attempt
    Lf = np.asarray(fac.dense())
    assert float(jnp.max(jnp.abs(d1 - d2_))) == 0.0
    err = np.max(np.abs(Lf - np.asarray(Lt)))
    assert err < 1e-8  # f64 under the test harness
    q = float(sampled_row_quality(fac, k, obs, pts, d2_))
    assert np.isfinite(q) and q < 1e-8


@pytest.mark.parametrize(
    "P_,block,chunk,sup", [(1, 8, 16, 24), (4, 8, 8, 16), (8, 16, 16, 32)]
)
def test_fused_matches_two_pass_burgers_ops(eight_devices, P_, block, chunk, sup):
    """Anisotropic 4-operator layout: superblock column windows straddle
    segment boundaries (37 is not a multiple of the block size)."""
    k, obs, pts, n = _burgers_setup()
    mesh = make_mesh(P_)
    # the anisotropic derivative blocks are brutally conditioned: 1e-2 keeps
    # the regularized matrix PD in f64 (1e-4 is numerically indefinite and
    # both paths NaN identically - separately verified)
    arranged, d1 = assemble_gram_sharded(
        k, obs, pts, mesh, block=block, nugget=1e-2
    )
    lower, _ = _chol_sharded(arranged, mesh, "p", block, chunk)
    Lt = unshard_rows_blockcyclic(lower, mesh, "p", block, n)
    fac, d2_, s_dev, ok_dev = assemble_factor_fused(
        k, obs, pts, mesh, block=block, nugget=1e-2, chunk_cols=chunk,
        superblock_cols=sup,
    )
    assert bool(ok_dev) and float(s_dev) == 1.0
    Lf = np.asarray(fac.dense())
    err = np.max(np.abs(Lf - np.asarray(Lt)))
    assert err < 1e-8
    q = float(sampled_row_quality(fac, k, obs, pts, d2_))
    assert np.isfinite(q) and q < 1e-8


def test_superblock_partition():
    assert _superblocks(12, 4) == [(0, 4), (4, 4), (8, 4)]
    assert _superblocks(13, 4) == [(0, 4), (4, 4), (8, 4), (12, 1)]
    assert _superblocks(5, 100) == [(0, 5)]
    for nb in (1, 5, 12, 108):
        for F in (1, 3, 8, 1000):
            sbs = _superblocks(nb, F)
            # exact tiling of [0, nb)
            assert sbs[0][0] == 0 and sum(f for _, f in sbs) == nb
            for (a, fa), (b, _) in zip(sbs, sbs[1:]):
                assert a + fa == b


def test_seg_ranges_cover_window():
    k, obs, pts, n = _elliptic_setup()
    segs = _segments(obs, pts)
    n_pad = 192  # > n = 162: padding tail present
    for c0, c1 in [(0, 64), (64, 160), (128, 192), (160, 192), (0, 192)]:
        ranges = _seg_ranges(segs, c0, c1, n)
        spans = sorted((lo, hi) for _, lo, hi in ranges)
        # every column of the window is covered exactly once
        assert spans[0][0] == 0 and spans[-1][1] == c1 - c0
        for (a, b), (c, e) in zip(spans, spans[1:]):
            assert b == c
        # padding columns fall in an op=None range
        for op, lo, hi in ranges:
            if c0 + lo >= n:
                assert op is None


def test_sampled_row_probe_catches_corruption(eight_devices):
    """A corrupted factor (finite but wrong) must fail the sampled-row
    probe - the failure class the round-1 backend miscompile produced."""
    import dataclasses

    k, obs, pts, n = _elliptic_setup()
    mesh = make_mesh(4)
    fac, d2_, _, _ = assemble_factor_fused(k, obs, pts, mesh, block=8, nugget=1e-4)
    q_good = float(sampled_row_quality(fac, k, obs, pts, d2_))
    assert q_good < 1e-8
    bad = dataclasses.replace(fac, local=fac.local * 1.01)  # finite, wrong
    q_bad = float(sampled_row_quality(bad, k, obs, pts, d2_))
    assert q_bad > 1e-2


def test_factorize_distributed_fused_end_to_end(eight_devices):
    """GPSolver on the mesh path with the fused factorization must agree
    with the two-pass factorization end-to-end (same GN solution)."""
    from nonlinpdes_gpsolver import GPSolver, models

    def u_truth(x):
        return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])

    def rhs_f(x):
        return -jnp.trace(jax.hessian(u_truth)(x)) + u_truth(x) ** 3

    from nonlinpdes_gpsolver.solvers.distributed import (
        factorize_distributed,
        gn_solve_distributed,
    )
    from nonlinpdes_gpsolver.utils import sample_random

    Xd, Xb = sample_random(jax.random.PRNGKey(0), 80, 24)
    kern = SquaredExponential.gaussian(0.3)
    prob = models.nonlinear_elliptic(kern, Xd, Xb, rhs_f, u_truth, seed=1)
    mesh = make_mesh(8)
    fp_f = factorize_distributed(
        prob, mesh, nugget=1e-8, block=8, fused=True, superblock_cols=32
    )
    fp_t = factorize_distributed(prob, mesh, nugget=1e-8, block=8, fused=False)
    st_f = gn_solve_distributed(fp_f, max_iter=3, step_solver="direct")
    st_t = gn_solve_distributed(fp_t, max_iter=3, step_solver="direct")
    np.testing.assert_allclose(
        np.asarray(st_f.z), np.asarray(st_t.z), rtol=0, atol=1e-5
    )
    assert fp_f.nugget_scales == fp_t.nugget_scales


def test_factorize_distributed_fused_escalates(eight_devices, fused=True):
    """Duplicated collocation points + f32 + the elliptic bi-Laplacian block
    make the factorization genuinely fail at the requested nugget; the fused
    path's sampled-row probe must escalate exactly like the two-pass probe
    (mirror of test_factorize_distributed_escalates_on_singular_gram)."""
    import jax as _jax

    import nonlinpdes_gpsolver as gpt
    from nonlinpdes_gpsolver.solvers.distributed import factorize_distributed

    _jax.config.update("jax_enable_x64", False)
    try:
        rng = np.random.default_rng(0)
        Xd_q = rng.uniform(0, 1, (30, 2)).astype(np.float32)
        Xd = jnp.asarray(np.concatenate([Xd_q] * 4))
        Xb = jnp.asarray(rng.uniform(0, 1, (12, 2)).astype(np.float32))

        def u_truth(x):
            return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1])

        def rhs_f(x):
            return -jnp.trace(jax.hessian(u_truth)(x)) + u_truth(x) ** 3

        k = SquaredExponential.gaussian(0.3)
        prob = gpt.models.nonlinear_elliptic(k, Xd, Xb, rhs_f, u_truth, seed=1)
        mesh = make_mesh(8)
        dfp = factorize_distributed(
            prob, mesh, nugget=1e-6, block=16, fused=fused
        )
        assert dfp.nugget_scales["u"] > 1.0
        r = dfp.whitened_residual(prob.init_latent().astype(jnp.float32))
        assert bool(jnp.all(jnp.isfinite(r)))
    finally:
        _jax.config.update("jax_enable_x64", True)


def test_fused_multi_row_chunk_assembly(eight_devices):
    """Small ``assemble_rows`` forces the clamped multi-chunk row assembly
    (the HBM-bounding path at scale) - must match the one-chunk result
    exactly (the clamped overlap recomputes identical values)."""
    k, obs, pts, n = _elliptic_setup()
    mesh = make_mesh(4)
    base, d0_, s0_, ok0 = assemble_factor_fused(
        k, obs, pts, mesh, block=8, nugget=1e-4, superblock_cols=32
    )
    chunked, d1_, s1_, ok1 = assemble_factor_fused(
        k, obs, pts, mesh, block=8, nugget=1e-4, superblock_cols=32,
        assemble_rows=16,
    )
    assert bool(ok0) and bool(ok1)
    np.testing.assert_array_equal(
        np.asarray(base.dense()), np.asarray(chunked.dense())
    )
