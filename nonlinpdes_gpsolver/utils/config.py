"""Config schema shared by the example drivers.

The reference duplicates an argparse block per driver with `type=bool` flags
that are always-true footguns (``main_NonLinElliptic2d.py:44-45`` upstream;
SURVEY.md quirk list). Here: one dataclass, per-problem defaults supplied by
each driver, real boolean flags (``--show-figure/--no-show-figure``), and
explicit platform/precision control (the device/x64 decisions the reference
hard-codes at import time).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path
from typing import List, Optional

# The program's default precision, on both platforms: f64. On the H100 the
# f32 path misses accuracy gates of the upstream configurations (PERF.md,
# Findings); f32 stays opt-in (``--no-x64``, or points cast to f32).
DEFAULT_X64 = True


@dataclasses.dataclass
class SolverConfig:
    # kernel
    kernel: str = "gaussian"
    kernel_parameter: List[float] = dataclasses.field(default_factory=lambda: [0.2])
    aniso_convention: str = "lengthscale"  # or "precision" (notebook convention)
    nugget: float = 1e-10
    nugget_type: str = "adaptive"
    # sampling
    sampled_type: str = "random"
    N_domain: int = 900
    N_boundary: int = 124
    seed: int = 0
    # Gauss-Newton
    GNsteps: int = 8
    step_size: float = 1.0
    initial: str = "random"
    method: str = "elimination"  # or "relaxation" (elliptic only)
    pen_lambda: float = 1e-10
    # runtime
    platform: Optional[str] = None  # None = whatever JAX picks (GPU if present)
    x64: bool = DEFAULT_X64
    show_figure: bool = False


def add_config_args(parser: argparse.ArgumentParser, defaults: SolverConfig) -> None:
    d = defaults
    parser.add_argument("--kernel", type=str, default=d.kernel,
                        choices=["gaussian", "anisotropic_gaussian"])
    parser.add_argument("--kernel_parameter", type=float, nargs="+",
                        default=d.kernel_parameter)
    parser.add_argument("--aniso_convention", type=str, default=d.aniso_convention,
                        choices=["lengthscale", "precision"])
    parser.add_argument("--nugget", type=float, default=d.nugget)
    parser.add_argument("--nugget_type", type=str, default=d.nugget_type,
                        choices=["adaptive", "identity", "none"])
    parser.add_argument("--sampled_type", type=str, default=d.sampled_type,
                        choices=["random", "grid"])
    parser.add_argument("--N_domain", type=int, default=d.N_domain)
    parser.add_argument("--N_boundary", type=int, default=d.N_boundary)
    parser.add_argument("--seed", type=int, default=d.seed)
    parser.add_argument("--GNsteps", type=int, default=d.GNsteps)
    parser.add_argument("--step_size", type=float, default=d.step_size)
    parser.add_argument("--initial", type=str, default=d.initial,
                        choices=["random", "zero"])
    parser.add_argument("--method", type=str, default=d.method,
                        choices=["elimination", "relaxation"])
    parser.add_argument("--pen_lambda", type=float, default=d.pen_lambda)
    parser.add_argument("--platform", type=str, default=d.platform)
    parser.add_argument("--x64", action=argparse.BooleanOptionalAction, default=d.x64)
    parser.add_argument("--show_figure", action=argparse.BooleanOptionalAction,
                        default=d.show_figure)


def config_from_args(args: argparse.Namespace) -> SolverConfig:
    fields = {f.name for f in dataclasses.fields(SolverConfig)}
    return SolverConfig(**{k: v for k, v in vars(args).items() if k in fields})


def setup_compile_cache() -> str:
    """Use JAX's persistent compile cache; return the directory in use.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is left to JAX. Otherwise the
    cache is the fixed ``<repo>/.jax_cache`` - a fixed path, because the
    path is part of the cache key and a moving directory never hits.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(Path(__file__).resolve().parents[2] / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def setup_runtime(x64: bool = DEFAULT_X64) -> str:
    """Precision and compile cache for an entry point, before any device
    use: the one place the program's precision is set. Returns the
    compile-cache directory in use."""
    import jax

    jax.config.update("jax_enable_x64", bool(x64))
    return setup_compile_cache()


def card_info() -> str:
    """``name, power limit`` of each GPU, one line per card, from
    ``nvidia-smi`` (a plain subprocess, off JAX). Raises if it fails: a
    device number is kept only beside the card's name and power limit."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no card")
    return out


def apply_runtime(cfg: SolverConfig) -> None:
    """Set platform/precision and the compile cache before any device use."""
    import jax

    if cfg.platform:
        jax.config.update("jax_platforms", cfg.platform)
    setup_runtime(cfg.x64)


def build_kernel(cfg: SolverConfig):
    from ..ops.kernels import SquaredExponential

    if cfg.kernel == "gaussian":
        if len(cfg.kernel_parameter) != 1:
            raise ValueError("gaussian kernel takes one parameter (sigma)")
        return SquaredExponential.gaussian(cfg.kernel_parameter[0])
    return SquaredExponential.anisotropic(cfg.kernel_parameter, cfg.aniso_convention)
