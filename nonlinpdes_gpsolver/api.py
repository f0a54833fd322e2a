"""User-facing solver facade.

Plays the role of upstream ``solver_GP`` (``src/solver.py:41-206``) minus its
quirks: no import-time matplotlib/LaTeX rc mutation (``src/solver.py:17-39``
upstream), no string dispatch (problems are :class:`CollocationProblem`
values built by the ``models`` constructors), metrics returned as data rather
than printed device scalars, and posterior representer weights cached.

Typical use::

    from nonlinpdes_gpsolver import GPSolver, models, ops, utils

    prob = models.nonlinear_elliptic(ops.SquaredExponential.gaussian(0.2),
                                     X_domain, X_boundary, rhs_f, bdy_g)
    solver = GPSolver(prob, nugget=1e-13)
    result = solver.solve(max_iter=4)
    u_test = result.posterior.extend(X_test)
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .models.spec import CollocationProblem
from .solvers.gn import FactoredProblem, GNState, factorize, gn_solve
from .solvers.posterior import Posterior
from .utils.metrics import ErrorStats, PhaseTimers, error_stats

log = logging.getLogger("nonlinpdes_gpsolver")


@dataclasses.dataclass
class SolveResult:
    state: GNState
    posterior: "Posterior"  # or DistributedPosterior on the mesh path
    timers: dict

    @property
    def z(self) -> jnp.ndarray:
        return self.state.z

    @property
    def losses(self) -> np.ndarray:
        return np.asarray(self.state.losses)


# Dense-vs-fused crossover: past it the dense path is slower than the
# fused streaming mesh path and memory-bound (full Gram matrix plus an
# explicit whitening operator); below a few thousand rows the mesh path's
# fixed overheads dominate. Auto-selection flips to the fused path above
# this many Gram rows. Not re-measured on the H100 (ROADMAP A8).
_AUTO_MESH_GRAM_ROWS = 16384


class GPSolver:
    """Factorizes once, then supports repeated solves / posterior queries.

    Pass ``mesh`` (a ``jax.sharding.Mesh``, e.g. from
    :func:`..parallel.make_mesh`) to run the memory-bounded distributed path
    end-to-end: tile-streamed sharded assembly, guarded distributed panel
    Cholesky, column-sharded/matrix-free Gauss-Newton, distributed
    posterior. A 1-device mesh is valid (same code path, single chip).

    ``auto_mesh`` (default on): with no explicit ``mesh``, problems whose
    largest Gram block exceeds the dense-vs-fused crossover
    (~16k rows) are routed to the fused streaming mesh path over all local
    accelerator devices automatically - at those sizes the dense path is
    strictly slower AND memory-bound (it materializes the full Gram matrix
    plus an explicit whitening operator). Pass ``auto_mesh=False`` to force
    the dense path.
    """

    def __init__(
        self,
        problem: CollocationProblem,
        nugget: float = 1e-10,
        nugget_type: str = "adaptive",
        dtype=None,
        mesh=None,
        mesh_block: int = 512,
        defer_quality: Optional[bool] = None,
        solve_mode: str = "auto",
        auto_mesh: bool = True,
    ):
        self.problem = problem
        if mesh is None and auto_mesh:
            from .ops.backend import is_accelerator

            n_max = max(
                sum(
                    int(problem.points[o.points].shape[0])
                    for o in b.observables
                )
                for b in problem.blocks
            )
            if is_accelerator() and n_max >= _AUTO_MESH_GRAM_ROWS:
                import jax

                from .parallel.mesh import make_mesh

                mesh = make_mesh(len(jax.devices()))
                log.info(
                    "auto_mesh: largest Gram block has %d rows (>= %d); "
                    "using the fused streaming mesh path on %d device(s)",
                    n_max, _AUTO_MESH_GRAM_ROWS, len(mesh.devices.ravel()),
                )
        self.mesh = mesh
        self.timers = PhaseTimers()
        self._mesh_block = mesh_block
        self._fact_args = dict(
            nugget=nugget, nugget_type=nugget_type, dtype=dtype,
            solve_mode=solve_mode,
        )
        if defer_quality is None:
            # Optimistic pipeline on the GPU (no mid-factorize sync; a bad
            # verdict costs a rare full redo); the eager in-factorize ladder
            # on CPU. Applies to BOTH the dense and the mesh path (the mesh
            # probe verdict defers identically).
            from .ops.backend import is_accelerator

            defer_quality = is_accelerator()
        self._defer_quality = bool(defer_quality)
        self._start_scales: dict = {}
        self._factorize()

    def _factorize(self):
        problem = self.problem
        with self.timers.phase("factorize"):
            if self.mesh is not None:
                from .solvers.distributed import factorize_distributed

                dtype = self._fact_args["dtype"]
                if dtype is not None:
                    problem = dataclasses.replace(
                        problem,
                        points={
                            k: jnp.asarray(v, dtype)
                            for k, v in problem.points.items()
                        },
                    )
                    self.problem = problem
                self.fp = factorize_distributed(
                    problem,
                    self.mesh,
                    nugget=self._fact_args["nugget"],
                    nugget_type=self._fact_args["nugget_type"],
                    block=self._mesh_block,
                    defer_quality=self._defer_quality,
                    start_scales=self._start_scales or None,
                )
            else:
                self.fp = factorize(
                    problem,
                    defer_quality=self._defer_quality,
                    start_scales=self._start_scales or None,
                    **self._fact_args,
                )
        for name, scale in self.fp.nugget_scales.items():
            if scale != 1.0:
                log.warning(
                    "block %r: nugget escalated x%g to keep Cholesky finite",
                    name,
                    scale,
                )

    def solve(
        self,
        max_iter: int = 8,
        step_size: float = 1.0,
        z0: Optional[jnp.ndarray] = None,
        hessian_jitter: float = 0.0,
        step_solver: str = "auto",
        tol: Optional[float] = None,
    ) -> SolveResult:
        """Run the Gauss-Newton solve (see :func:`..solvers.gn.gn_solve`).

        ``tol``: optional loss-plateau stopping tolerance - iterate until
        relative loss change <= tol or ``max_iter`` (both the single-device
        and the mesh path; device-side while_loop, no per-iteration sync).
        """
        import math

        import jax

        for _ in range(8):
            with self.timers.phase("gauss_newton"):
                if self.mesh is not None:
                    from .solvers.distributed import gn_solve_distributed

                    state = gn_solve_distributed(
                        self.fp,
                        z0=z0,
                        max_iter=max_iter,
                        step_size=step_size,
                        hessian_jitter=hessian_jitter,
                        step_solver=step_solver,
                        tol=tol,
                    )
                else:
                    state = gn_solve(
                        self.fp,
                        z0=z0,
                        max_iter=max_iter,
                        step_size=step_size,
                        hessian_jitter=hessian_jitter,
                        step_solver=step_solver,
                        tol=tol,
                    )
            # Queue the posterior-weight dispatches BEFORE the sync so the
            # device pipeline does not drain.
            with self.timers.phase("posterior_weights"):
                if self.mesh is not None:
                    from .solvers.distributed import DistributedPosterior

                    post = DistributedPosterior(self.fp, state.z)
                else:
                    post = Posterior(self.fp, state.z)
            # ONE device->host round trip covers the completion barrier, the
            # finiteness verdict, the loss history for logging, AND any
            # pending deferred whitening-quality verdicts (separate syncs
            # would each drain the device queue).
            qnames = sorted(getattr(self.fp, "quality", {}) or {})
            pend = getattr(self.fp, "pending_scales", {}) or {}
            finite, losses, qvals, pvals = jax.device_get(
                (
                    state.converged_finite,
                    state.losses,
                    [self.fp.quality[n] for n in qnames] if qnames else [],
                    [pend[n] for n in qnames if n in pend],
                )
            )
            # resolve the in-executable escalation ladder's outcome: the
            # real scale each block used, and whether it ran out of rungs
            for n, (s_used, ok) in zip([n for n in qnames if n in pend], pvals):
                if not bool(ok):
                    raise FloatingPointError(
                        f"problem {self.problem.name!r} block {n!r}: "
                        f"factorization non-finite after in-executable "
                        f"nugget escalation to {float(s_used):g}x"
                    )
                prev = self.fp.nugget_scales.get(n)
                self.fp.nugget_scales[n] = float(s_used)
                if float(s_used) != (prev if prev is not None else 1.0):
                    log.warning(
                        "block %r: nugget escalated x%g to keep Cholesky "
                        "finite", n, float(s_used),
                    )
            from .solvers.gn import QUALITY_TOL

            bad = {
                n: float(q)
                for n, q in zip(qnames, qvals)
                if not (math.isfinite(float(q)) and float(q) < QUALITY_TOL)
            }
            if not bad:
                break
            # Deferred-quality verdict failed: the whole optimistic pipeline
            # ran on a corrupt factor. Escalate the failing blocks' nugget
            # 10x past what was attempted and redo factorize+solve (rare -
            # and the redo costs less than an always-on mid-pipeline sync).
            for n in bad:
                self._start_scales[n] = 10.0 * float(
                    self.fp.nugget_scales.get(n, 1.0)
                )
            log.warning(
                "problem %r: deferred whitening-quality check failed for "
                "block(s) %s; re-factorizing with escalated nugget",
                self.problem.name,
                bad,
            )
            # drop EVERY reference to the corrupt factors before the redo:
            # holding the old n^2(/P) arrays across the re-assembly doubles
            # peak HBM exactly when escalation triggers at scale (the
            # round-2 retry-OOM class)
            post = None  # noqa: F841 - frees the posterior's factor refs
            state = None  # noqa: F841
            self.fp = None
            self._factorize()
        else:
            raise FloatingPointError(
                f"problem {self.problem.name!r}: factorization quality still "
                f"bad after nugget escalation to {self._start_scales}"
            )
        if not bool(finite):
            log.warning(
                "problem %r: at least one GN step was rejected as non-finite "
                "(nugget may be too small)",
                self.problem.name,
            )
        log.info("problem %r: GN losses %s", self.problem.name, losses)
        return SolveResult(state=state, posterior=post, timers=self.timers.as_dict())

    # -- convenience metrics (reference: src/solver.py:169-194 upstream) ----
    @staticmethod
    def errors(pred, truth) -> ErrorStats:
        return error_stats(pred, truth)
