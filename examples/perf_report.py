#!/usr/bin/env python
"""Performance harness: per-phase wall-clock + TFLOP/s for any of the four
reference workloads at one or more sizes (the SURVEY.md section 6 north-star
metrics: assembly / Cholesky TFLOP/s per chip, GN iterations per second).

  python examples/perf_report.py --sizes 900 4000 10000 --warm
  python examples/perf_report.py --workload darcy --mesh 1 --sizes 5000 --warm

``--workload`` selects the problem family at its reference CLI configuration
(elliptic/burgers/eikonal: ``main_*.py`` upstream; darcy:
``main_DarcyFlow2d.py:54-78`` upstream - the BASELINE.md north-star inverse
problem); ``--sizes`` scales N_domain. ``--mesh P`` runs the fused streaming
mesh path (1 is valid: same code path, single chip - the configuration that
crosses the reference's ~10k dense wall).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    from nonlinpdes_gpsolver.utils.config import DEFAULT_X64, setup_runtime

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", type=str, default="elliptic",
                        choices=["elliptic", "burgers", "eikonal", "darcy"])
    parser.add_argument("--sizes", type=int, nargs="+", default=[900, 2000])
    parser.add_argument("--gn_steps", type=int, default=4)
    parser.add_argument("--nugget", type=float, default=1e-5)
    parser.add_argument("--platform", type=str, default=None)
    parser.add_argument("--x64", action=argparse.BooleanOptionalAction,
                        default=DEFAULT_X64)
    parser.add_argument(
        "--warm", action="store_true",
        help="run each size twice and report the second (compile-free) pass",
    )
    parser.add_argument(
        "--mesh", type=int, default=0,
        help="run the memory-bounded distributed path on an N-device mesh "
             "(1 is valid: same code path, single chip)",
    )
    parser.add_argument("--mesh_block", type=int, default=512)
    parser.add_argument("--superblock", type=int, default=2048)
    parser.add_argument(
        "--step_solver", type=str, default="auto",
        choices=["auto", "direct", "cg", "structured", "normal", "woodbury"],
    )
    parser.add_argument("--cg_maxiter", type=int, default=None)
    parser.add_argument("--cg_tol", type=float, default=None)
    parser.add_argument("--tol", type=float, default=None,
                        help="loss-plateau stopping tolerance (gn_steps caps)")
    parser.add_argument("--test_grid", type=int, default=60)
    parser.add_argument("--N_data", type=int, default=60)
    parser.add_argument("--noise_level", type=float, default=1e-3)
    args = parser.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    setup_runtime(args.x64)
    import jax.numpy as jnp
    import numpy as np
    import nonlinpdes_gpsolver as gpt
    from nonlinpdes_gpsolver.utils.profiling import flop_model, tflops

    G = args.test_grid

    def make_elliptic(N, seed):
        def u_truth(x):
            return jnp.sin(jnp.pi * x[0]) * jnp.sin(jnp.pi * x[1]) + 2 * jnp.sin(
                4 * jnp.pi * x[0]
            ) * jnp.sin(4 * jnp.pi * x[1])

        def rhs_f(x):
            return -jnp.trace(jax.hessian(u_truth)(x)) + u_truth(x) ** 3

        kernel = gpt.SquaredExponential.gaussian(0.2)
        Xt = gpt.utils.test_grid(G, G)
        truth = jax.vmap(u_truth)(Xt)
        Xd, Xb = gpt.utils.sample_random(
            jax.random.PRNGKey(seed), N, max(4, N // 8)
        )
        prob = gpt.models.nonlinear_elliptic(
            kernel, Xd, Xb, rhs_f, u_truth, seed=seed + 1
        )
        return prob, Xt, truth, None

    def make_burgers(N, seed):
        from nonlinpdes_gpsolver.utils.classical import (
            burgers_cole_hopf_truth,
        )

        domain = ((0.0, 1.0), (-1.0, 1.0))
        kernel = gpt.SquaredExponential.anisotropic([0.3, 0.05], "lengthscale")
        Xd, Xb = gpt.utils.sample_random(
            jax.random.PRNGKey(seed), N, max(4, N // 5), domain,
            time_dependent=True,
        )

        def g(x):
            return jnp.where(x[0] == 0.0, -jnp.sin(jnp.pi * x[1]), 0.0)

        prob = gpt.models.burgers(kernel, Xd, Xb, g, nu=0.02, seed=seed + 1)
        Xt = gpt.utils.test_grid(G, G, domain)
        u_truth = burgers_cole_hopf_truth(0.02)
        truth = jnp.asarray(
            u_truth(np.asarray(Xt[:, 0]), np.asarray(Xt[:, 1]))
        )
        return prob, Xt, truth, None

    def make_eikonal(N, seed):
        from nonlinpdes_gpsolver.utils.classical import (
            eikonal_cole_hopf_solve,
        )

        kernel = gpt.SquaredExponential.gaussian(0.2)
        Xd, Xb = gpt.utils.sample_random(
            jax.random.PRNGKey(seed), N, max(4, N // 5)
        )
        prob = gpt.models.eikonal(
            kernel, Xd, Xb, rhs_f=lambda x: 1.0, eps=0.1, init="zero",
            seed=seed + 1,
        )
        X1, X2, U = eikonal_cole_hopf_solve(58, 0.1)
        Xt = jnp.asarray(np.stack([X1.ravel(), X2.ravel()], axis=1))
        return prob, Xt, jnp.asarray(U.ravel()), None

    def make_darcy(N, seed):
        from scipy.interpolate import RegularGridInterpolator

        from nonlinpdes_gpsolver.utils.classical import darcy_fd_solve

        def a_true(x1, x2):
            s = np.sin(2 * np.pi * x1) + np.sin(2 * np.pi * x2)
            return np.exp(s) + np.exp(-s)

        xs, ys, U = darcy_fd_solve(78, a_true, lambda x1, x2: np.ones_like(x1))
        interp = RegularGridInterpolator((ys, xs), U)
        kernel = gpt.SquaredExponential.gaussian(0.2)
        Xd, Xb = gpt.utils.sample_random(
            jax.random.PRNGKey(seed), N, max(4, N // 4)
        )
        Xdata = np.asarray(Xd[: args.N_data])
        clean = interp(np.stack([Xdata[:, 1], Xdata[:, 0]], axis=1))
        rng = np.random.default_rng(seed)
        noisy = clean + args.noise_level * rng.standard_normal(args.N_data)
        prob = gpt.models.darcy_flow(
            kernel, kernel, Xd, Xb, jnp.asarray(noisy),
            rhs_f=lambda x: 1.0, noise_level=args.noise_level, seed=seed + 1,
        )
        X1, X2 = np.meshgrid(xs, ys)
        Xt = jnp.asarray(np.stack([X1.ravel(), X2.ravel()], axis=1))

        def extra(post):
            pred_a = np.exp(np.asarray(post.extend(Xt, block="a")))
            a_vals = a_true(X1, X2).ravel()
            rel = gpt.GPSolver.errors(pred_a, a_vals).l2 / float(
                np.sqrt(np.mean(a_vals**2))
            )
            return f"a_relL2 {rel:.3f}"

        return prob, Xt, jnp.asarray(U.ravel()), extra

    builders = {
        "elliptic": make_elliptic, "burgers": make_burgers,
        "eikonal": make_eikonal, "darcy": make_darcy,
    }
    build = builders[args.workload]

    mesh = None
    if args.mesh:
        from nonlinpdes_gpsolver.parallel import make_mesh

        mesh = make_mesh(args.mesh)
    print(
        f"workload={args.workload} backend={jax.default_backend()} "
        f"x64={args.x64} mesh={args.mesh or 'off'} solver={args.step_solver}"
    )
    print(
        f"{'N':>7} {'factor_s':>9} {'gn_s':>8} {'post_s':>8} "
        f"{'chol_TF/s':>10} {'gn_TF/s':>9} {'gn_it/s':>8} {'test_L2':>10}"
    )

    for N in args.sizes:

        def run(seed):
            prob, Xt, truth, extra = build(N, seed)
            t0 = time.perf_counter()
            if mesh is not None:
                from nonlinpdes_gpsolver.solvers.distributed import (
                    DistributedPosterior,
                    factorize_distributed,
                    gn_solve_distributed,
                )

                fp = factorize_distributed(
                    prob, mesh, nugget=args.nugget, block=args.mesh_block,
                    superblock_cols=args.superblock,
                )
                t1 = time.perf_counter()
                st = gn_solve_distributed(
                    fp, max_iter=args.gn_steps, step_solver=args.step_solver,
                    tol=args.tol, cg_maxiter=args.cg_maxiter,
                    cg_tol=args.cg_tol,
                )
                st.z.block_until_ready()
                t2 = time.perf_counter()
                post = DistributedPosterior(fp, st.z)
            else:
                from nonlinpdes_gpsolver.solvers import (
                    Posterior, factorize, gn_solve,
                )

                fp = factorize(prob, nugget=args.nugget)
                t1 = time.perf_counter()
                st = gn_solve(
                    fp, max_iter=args.gn_steps, step_solver=args.step_solver,
                    tol=args.tol,
                    **(
                        {"cg_maxiter": args.cg_maxiter}
                        if args.cg_maxiter is not None else {}
                    ),
                    **(
                        {"cg_tol": args.cg_tol}
                        if args.cg_tol is not None else {}
                    ),
                )
                st.z.block_until_ready()
                t2 = time.perf_counter()
                post = Posterior(fp, st.z)
            pred = post.extend(Xt, block="u" if args.workload == "darcy" else None)
            pred.block_until_ready()
            t3 = time.perf_counter()
            err = gpt.GPSolver.errors(pred, truth)
            note = extra(post) if extra else ""
            iters = np.asarray(st.cg_iters) if st.cg_iters is not None else None
            if iters is not None and iters.any():
                note = f"{note} cg_iters {iters.tolist()}".strip()
            return prob, (t1 - t0, t2 - t1, t3 - t2), err, note

        prob, ts, err, note = run(0)
        if args.warm:
            prob, ts, err, note = run(1)
        fm = flop_model(prob, gn_iters=args.gn_steps)
        print(
            f"{N:>7} {ts[0]:>9.3f} {ts[1]:>8.3f} {ts[2]:>8.3f} "
            f"{tflops(fm['cholesky'], ts[0]):>10.2f} "
            f"{tflops(fm['gn_total'], ts[1]):>9.2f} "
            f"{args.gn_steps / ts[1]:>8.1f} {err.l2:>10.3e}  {note}",
            flush=True,
        )


if __name__ == "__main__":
    main()
