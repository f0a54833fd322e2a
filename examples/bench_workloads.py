#!/usr/bin/env python
"""End-to-end wall-clock for all four reference workloads at their CLI configs.

Each workload runs twice - the first pass pays compilation (persistent
compile cache, see ``utils.config.setup_runtime``), the second is the
reported warm number, timed to ``block_until_ready`` - and prints one line
with the warm end-to-end seconds plus accuracy, e.g.::

    [elliptic 900/124 GN4] warm end-to-end 0.571s  ->  ErrorStats(l2=2.09e-03, ...)

Configurations and ground truths: :mod:`nonlinpdes_gpsolver.utils.workloads`
(the reference's README commands).

    python examples/bench_workloads.py              # all four
    python examples/bench_workloads.py --only burgers darcy
    python examples/bench_workloads.py --only mesh --mesh_N 20000
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--only", nargs="+", default=["elliptic", "burgers", "eikonal", "darcy"],
        choices=["elliptic", "burgers", "eikonal", "darcy", "mesh"],
        help="'mesh' runs the elliptic workload through the distributed "
             "mesh path at --mesh_N collocation points - PAST the "
             "reference's ~10k dense limit",
    )
    parser.add_argument("--mesh_N", type=int, default=20000)
    parser.add_argument("--platform", type=str, default=None)
    args = parser.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    import json

    import jax.numpy as jnp
    import nonlinpdes_gpsolver as gpt
    from nonlinpdes_gpsolver.utils import workloads
    from nonlinpdes_gpsolver.utils.config import setup_runtime

    setup_runtime()
    dev = jax.devices()[0]
    print(f"backend: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          flush=True)

    ref_path = Path(__file__).resolve().parent.parent / "REF_BASELINE.json"
    ref = json.loads(ref_path.read_text()) if ref_path.exists() else {}

    def timed(w, ref_key=None, mesh=None):
        truth = jnp.asarray(w.truth)

        def run():
            res = gpt.GPSolver(w.make(), nugget=w.nugget, mesh=mesh).solve(
                max_iter=w.max_iter
            )
            pred = res.posterior.extend(w.X_test, block=w.block)
            pred.block_until_ready()
            return pred

        run()  # warm: compile (persistent-cached)
        t0 = time.perf_counter()
        pred = run()
        dt = time.perf_counter() - t0
        vs = ""
        if ref_key in ref:
            vs = (f"  ({ref[ref_key]['seconds']:.1f}s reference CPU -> "
                  f"{ref[ref_key]['seconds'] / dt:.1f}x)")
        print(f"[{w.name}] warm end-to-end {dt:.3f}s{vs}  ->  "
              f"{gpt.GPSolver.errors(pred, truth)}", flush=True)

    builders = {"elliptic": workloads.elliptic, "burgers": workloads.burgers,
                "eikonal": workloads.eikonal, "darcy": workloads.darcy}
    for name, build in builders.items():
        if name in args.only:
            timed(build(), name)
    if "mesh" in args.only:
        # elliptic at N past the reference's dense wall (upstream
        # README.md:9), through the memory-bounded mesh path on however
        # many devices are visible
        from nonlinpdes_gpsolver.parallel import make_mesh

        N = args.mesh_N
        timed(workloads.elliptic(N=N, Nb=N // 8, key=1), mesh=make_mesh())


if __name__ == "__main__":
    main()
