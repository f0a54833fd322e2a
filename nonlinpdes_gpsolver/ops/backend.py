"""Backend classification shared by every precision/dispatch decision.

The program runs on two platforms: XLA-CPU and the GPU. Its entry points
run in f64 on both (``utils.config.DEFAULT_X64``, set by
``utils.config.setup_runtime``), as the reference does (``src/kernels.py:4``
et passim upstream). f32 stays available (x64 off): then the solver
equilibrates every factor and runs every dot at ``Precision.HIGHEST`` (plain
FP32 on the GPU, never TF32). On the H100 that f32 path misses accuracy
gates of the upstream configurations (PERF.md, Findings).

On the GPU the solver keeps, in either dtype, the decisions it was tuned
under: whitening by a precomputed triangular inverse (``solve_mode=
'inverse'``), the hand-rolled Cholesky/inverse family of :mod:`.linalg`,
the deferred quality verdict, and ``auto_mesh``. They are keyed on the
platform, not on the dtype, so f64 on the GPU still takes them while f64 on
the CPU takes LAPACK. That fork is open: whether cuSOLVER does as well at
f64 is decided by measurement (ROADMAP A4). Every module calls
:func:`is_accelerator` instead of testing backend strings.
"""

from __future__ import annotations

import jax


def is_accelerator() -> bool:
    """True on the GPU, False on XLA-CPU; any other platform is an error."""
    platform = jax.default_backend()
    if platform == "gpu":
        return True
    if platform == "cpu":
        return False
    raise RuntimeError(
        f"unsupported JAX platform {platform!r}: this program runs on 'gpu' "
        "or 'cpu'"
    )
