#!/usr/bin/env python
"""Darcy-flow inverse driver: infer a and u in -div(a grad u) = 1 on [0,1]^2
from noisy point values of u.

Capability match for upstream ``main_DarcyFlow2d.py`` (truth
``a = exp(sin(2 pi x1) + sin(2 pi x2)) + exp(-sin(2 pi x1) - sin(2 pi x2))``,
observations from an 80x80 finite-volume solve interpolated to the data
points, Gaussian noise).

  python examples/darcy.py --kernel gaussian --kernel_parameter 0.2 \
      --nugget 1e-8 --N_domain 400 --N_boundary 100 --N_data 60 \
      --noise_level 0.001 --GNsteps 8
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nonlinpdes_gpsolver.utils.config import (
    SolverConfig, add_config_args, apply_runtime, build_kernel, config_from_args,
)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    defaults = SolverConfig(
        nugget=1e-8, N_domain=400, N_boundary=100, GNsteps=8, seed=9999
    )
    add_config_args(parser, defaults)
    parser.add_argument("--N_data", type=int, default=60)
    parser.add_argument("--noise_level", type=float, default=1e-3)
    parser.add_argument("--mesh", type=int, default=0,
                        help="run the memory-bounded distributed path on an "
                             "N-device mesh (1 = same path, single chip)")
    parser.add_argument("--mesh_block", type=int, default=512)
    parser.add_argument("--step_solver", type=str, default="auto")
    parser.add_argument("--tol", type=float, default=None,
                        help="loss-plateau stopping tolerance (GNsteps caps)")
    args = parser.parse_args()
    cfg = config_from_args(args)
    apply_runtime(cfg)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.interpolate import RegularGridInterpolator
    import nonlinpdes_gpsolver as gpt
    from nonlinpdes_gpsolver.utils.classical import darcy_fd_solve

    def a_true(x1, x2):
        s = np.sin(2 * np.pi * x1) + np.sin(2 * np.pi * x2)
        return np.exp(s) + np.exp(-s)

    # classical FD truth on an 80x80 grid (incl. boundary ring)
    xs, ys, U = darcy_fd_solve(78, a_true, lambda x1, x2: np.ones_like(x1))
    interp = RegularGridInterpolator((ys, xs), U)

    key = jax.random.PRNGKey(cfg.seed)
    if cfg.sampled_type == "grid":
        Xd, Xb = gpt.utils.sample_grid(cfg.N_domain, cfg.N_boundary)
    else:
        Xd, Xb = gpt.utils.sample_random(key, cfg.N_domain, cfg.N_boundary)
    Xdata = np.asarray(Xd[: args.N_data])
    clean = interp(np.stack([Xdata[:, 1], Xdata[:, 0]], axis=1))
    rng = np.random.default_rng(cfg.seed)
    noisy = clean + args.noise_level * rng.standard_normal(args.N_data)

    kernel = build_kernel(cfg)
    prob = gpt.models.darcy_flow(
        kernel, kernel, Xd, Xb, jnp.asarray(noisy),
        rhs_f=lambda x: 1.0, noise_level=args.noise_level,
        init=cfg.initial, seed=cfg.seed,
    )
    mesh = None
    if args.mesh:
        from nonlinpdes_gpsolver.parallel import make_mesh

        mesh = make_mesh(args.mesh)
    solver = gpt.GPSolver(prob, nugget=cfg.nugget, nugget_type=cfg.nugget_type,
                          mesh=mesh, mesh_block=args.mesh_block)
    res = solver.solve(max_iter=cfg.GNsteps, step_size=cfg.step_size,
                       step_solver=args.step_solver, tol=args.tol)
    print(f"[GN] losses: {res.losses}")

    X1, X2 = np.meshgrid(xs, ys)
    Xt = jnp.asarray(np.stack([X1.ravel(), X2.ravel()], axis=1))
    pred_u = res.posterior.extend(Xt, block="u")
    pred_a = np.exp(np.asarray(res.posterior.extend(Xt, block="a")))
    err_u = gpt.GPSolver.errors(pred_u, U.ravel())
    a_vals = a_true(X1, X2).ravel()
    err_a = gpt.GPSolver.errors(pred_a, a_vals)
    rel_a = err_a.l2 / np.sqrt(np.mean(a_vals**2))
    print(f"[Test error u] max {err_u.max:.4e}  L2 {err_u.l2:.4e}")
    print(f"[Test error a] max {err_a.max:.4e}  L2 {err_a.l2:.4e}  rel-L2 {rel_a:.3f}")
    print(f"[Timers] {res.timers}")

    if cfg.show_figure:
        from nonlinpdes_gpsolver.utils.plotting import field_panels

        field_panels(
            Xt,
            [a_vals, pred_a, U.ravel(), np.asarray(pred_u)],
            ["truth a", "recovered a", "truth u", "recovered u"],
        )


if __name__ == "__main__":
    main()
