"""Error metrics and phase timers.

The reference reports max / L2(=RMS) errors via prints inside the facade
(``src/solver.py:169-194`` upstream); here metrics are plain data so tests
and benchmarks can assert on them, and timing is explicit (the reference has
no timing at all - SURVEY.md section 5).
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class ErrorStats:
    max: float
    l2: float  # RMS: sqrt(mean(err^2)) - the reference's "L2 error"

    def __repr__(self):
        return f"ErrorStats(max={self.max:.4e}, l2={self.l2:.4e})"


def error_stats(pred, truth) -> ErrorStats:
    """Max / RMS error. When both operands already live on a device the
    reduction runs there and only two scalars cross the host boundary
    instead of the full prediction."""
    try:
        import jax

        if (
            isinstance(pred, jax.Array)
            and isinstance(truth, jax.Array)
            and not isinstance(pred, jax.core.Tracer)
            and not isinstance(truth, jax.core.Tracer)
        ):
            mx, l2 = jax.device_get(_error_scalars(pred, truth))
            return ErrorStats(max=float(mx), l2=float(l2))
    except ImportError:
        pass
    err = np.abs(np.asarray(pred) - np.asarray(truth))
    return ErrorStats(max=float(err.max()), l2=float(np.sqrt(np.mean(err**2))))


_ERR_JIT = None


def _error_scalars(pred, truth):
    global _ERR_JIT
    if _ERR_JIT is None:
        import jax
        import jax.numpy as jnp

        @jax.jit
        def _stats(p, t):
            e = jnp.abs(p - t)
            return jnp.max(e), jnp.sqrt(jnp.mean(e * e))

        _ERR_JIT = _stats
    return _ERR_JIT(pred, truth)


class PhaseTimers:
    """Named wall-clock accumulators (assembly / factorization / GN / ...)."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def as_dict(self) -> Dict[str, float]:
        return dict(self.seconds)
