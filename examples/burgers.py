#!/usr/bin/env python
"""Burgers driver: u_t + alpha u u_x - nu u_xx = 0 on (t,x) in [0,1]x[-1,1].

Capability match for upstream ``main_Burgers1d.py`` (IC u(0,x) = -sin(pi x),
truth via Cole-Hopf + Gauss-Hermite quadrature).

  python examples/burgers.py --kernel anisotropic_gaussian \
      --kernel_parameter 0.3 0.05 --nugget 1e-5 --N_domain 1000 \
      --N_boundary 200 --GNsteps 8
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
        kernel="anisotropic_gaussian", kernel_parameter=[0.3, 0.05],
        nugget=1e-5, N_domain=1000, N_boundary=200, GNsteps=8,
    )
    add_config_args(parser, defaults)
    parser.add_argument("--alpha", type=float, default=1.0)
    parser.add_argument("--nu", type=float, default=0.02)
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
    from nonlinpdes_gpsolver.utils.classical import burgers_cole_hopf_truth

    domain = ((0.0, 1.0), (-1.0, 1.0))
    key = jax.random.PRNGKey(cfg.seed)
    if cfg.sampled_type == "grid":
        Xd, Xb = gpt.utils.sample_grid(
            cfg.N_domain, cfg.N_boundary, domain, time_dependent=True
        )
    else:
        Xd, Xb = gpt.utils.sample_random(
            key, cfg.N_domain, cfg.N_boundary, domain, time_dependent=True
        )

    def g(x):  # IC at t=0, homogeneous Dirichlet on spatial faces
        return jnp.where(x[0] == 0.0, -jnp.sin(jnp.pi * x[1]), 0.0)

    kernel = build_kernel(cfg)
    prob = gpt.models.burgers(
        kernel, Xd, Xb, g, alpha=args.alpha, nu=args.nu,
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

    u_truth = burgers_cole_hopf_truth(args.nu)
    Xt = gpt.utils.test_grid(60, 60, domain)
    pred = res.posterior.extend(Xt)
    truth = u_truth(np.asarray(Xt[:, 0]), np.asarray(Xt[:, 1]))
    errt = gpt.GPSolver.errors(pred, truth)
    print(f"[Test error, space-time] max {errt.max:.4e}  L2 {errt.l2:.4e}")

    # time-slice errors as in the reference notebook
    for t_slice in (0.2, 0.5, 0.8):
        xs = np.linspace(-1, 1, 200)
        Xs = jnp.asarray(np.stack([np.full_like(xs, t_slice), xs], axis=1))
        errs = gpt.GPSolver.errors(res.posterior.extend(Xs), u_truth(t_slice, xs))
        print(f"[Test error, t={t_slice}] max {errs.max:.4e}  L2 {errs.l2:.4e}")
    print(f"[Timers] {res.timers}")

    if cfg.show_figure:
        from nonlinpdes_gpsolver.utils.plotting import contour_error

        contour_error(Xt, pred, truth, title="Burgers test error")


if __name__ == "__main__":
    main()
