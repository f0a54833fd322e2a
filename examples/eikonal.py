#!/usr/bin/env python
"""Regularized Eikonal driver: |grad u|^2 = f^2 + eps Delta u on [0,1]^2, u=0
on the boundary, f = 1.

Capability match for upstream ``main_Eikonal2d.py`` (truth via Cole-Hopf FD
solve on an interior grid).

  python examples/eikonal.py --kernel gaussian --kernel_parameter 0.2 \
      --nugget 1e-5 --N_domain 1000 --N_boundary 200 --GNsteps 8
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
        nugget=1e-5, N_domain=1000, N_boundary=200, GNsteps=8, initial="zero"
    )
    add_config_args(parser, defaults)
    parser.add_argument("--eps", type=float, default=0.1)
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
    import nonlinpdes_gpsolver as gpt
    from nonlinpdes_gpsolver.utils.classical import eikonal_cole_hopf_solve

    key = jax.random.PRNGKey(cfg.seed)
    if cfg.sampled_type == "grid":
        Xd, Xb = gpt.utils.sample_grid(cfg.N_domain, cfg.N_boundary)
    else:
        Xd, Xb = gpt.utils.sample_random(key, cfg.N_domain, cfg.N_boundary)

    kernel = build_kernel(cfg)
    prob = gpt.models.eikonal(
        kernel, Xd, Xb, rhs_f=lambda x: 1.0, eps=args.eps,
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

    # truth on the interior FD grid (reference uses 58x58 interior points)
    X1, X2, U = eikonal_cole_hopf_solve(58, args.eps)
    Xt = jnp.asarray(np.stack([X1.ravel(), X2.ravel()], axis=1))
    pred = res.posterior.extend(Xt)
    errt = gpt.GPSolver.errors(pred, U.ravel())
    print(f"[Test error] max {errt.max:.4e}  L2 {errt.l2:.4e}")
    print(f"[Timers] {res.timers}")

    if cfg.show_figure:
        from nonlinpdes_gpsolver.utils.plotting import contour_error

        contour_error(Xt, pred, U.ravel(), title="Eikonal test error")


if __name__ == "__main__":
    main()
