"""Gaussian-process solver for nonlinear PDEs and inverse problems.

A from-scratch JAX/XLA re-design of the capabilities of
yifanc96/NonLinPDEs-GPsolver (Chen, Hosseini, Owhadi, Stuart, JCP 2021):
declarative PDE specs, compiled derivative-kernel Gram assembly, whitened
Gauss-Newton, GP posterior extension, and mesh-sharded dense linear algebra.
"""

__version__ = "0.1.0"

from .ops import (  # noqa: E402,F401
    LinearOp,
    identity,
    d,
    d2,
    laplacian,
    SquaredExponential,
    ad_pair_fn,
    Observable,
    gram_matrix,
    cross_gram,
    adaptive_nugget_diag,
    regularized_gram,
    observable_sizes,
)
from . import compat, models, ops, parallel, solvers, utils  # noqa: E402,F401
from .api import GPSolver, SolveResult  # noqa: E402,F401
from .solvers import factorize, gn_solve, Posterior  # noqa: E402,F401
