#!/usr/bin/env python
"""Benchmark: canonical nonlinear-elliptic workload, end-to-end, on the GPU.

Prints ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "device": {...}, "card": "<name>, <power limit>"}

Workload = BASELINE.md config 1 (the reference's README command):
NonLinElliptic2d, Gaussian sigma=0.2, N_domain=900, N_boundary=124, 4 GN
steps, posterior extension to a 60x60 test grid. Wall-clock covers
assembly + factorization + the full GN loop + posterior weights + test
extension, after one warm-up run (compile cache hot - the serving regime),
timed to ``block_until_ready``.

vs_baseline: speedup over the reference implementation executing its own
pipeline end-to-end on a host CPU (f64, the only mode it supports),
measured by `scripts/measure_reference.py` into REF_BASELINE.json - re-run
that script to re-derive the constant on a new host. Higher is better.

Accuracy is checked in the same run: the resulting test L2 error must be at
least as good as the notebook-recorded baseline 3.402e-3
(BASELINE.md row 1) or the benchmark reports failure.

Runs in f64 (the program's default precision, see ``ops.backend``).
Without a GPU it exits non-zero. ``--platform cpu`` is the rehearsal mode
on CPU; its time is not a device number.
"""

import argparse
import json
import os
import sys
import time

_FALLBACK_REF_SECONDS = 11.42  # scripts/measure_reference.py, 2026-08-19
BASELINE_L2 = 3.402e-3


def _ref_seconds() -> float:
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "REF_BASELINE.json")
    try:
        with open(path) as f:
            return float(json.load(f)["elliptic"]["seconds"])
    except Exception:
        return _FALLBACK_REF_SECONDS


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    args = ap.parse_args()

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if dev.platform != args.platform:
        sys.exit(f"bench: needs platform {args.platform!r}, JAX found "
                 f"{dev.platform!r} (pass --platform cpu to rehearse)")
    import nonlinpdes_gpsolver as gpt
    from nonlinpdes_gpsolver.utils import workloads
    from nonlinpdes_gpsolver.utils.config import card_info, setup_runtime

    setup_runtime()
    w = workloads.elliptic()
    truth = jax.numpy.asarray(w.truth)

    def run():
        res = gpt.GPSolver(w.make(), nugget=w.nugget).solve(max_iter=w.max_iter)
        pred = res.posterior.extend(w.X_test)
        pred.block_until_ready()
        return pred

    run()  # warm-up: compile cache
    t0 = time.perf_counter()
    pred = run()
    seconds = time.perf_counter() - t0
    err = gpt.GPSolver.errors(pred, truth)

    out = {
        "metric": "elliptic2d_e2e_n900_seconds",
        "value": seconds,
        "unit": "s",
        "vs_baseline": _ref_seconds() / seconds,
        "test_l2": err.l2,
        "accuracy_gate": BASELINE_L2,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_info().splitlines()[0] if dev.platform == "gpu" else "cpu rehearsal",
    }
    if err.l2 > BASELINE_L2:
        out["vs_baseline"] = 0.0
        out["error"] = f"accuracy regression: L2 {err.l2:.3e} > {BASELINE_L2}"
        print(json.dumps(out))
        sys.exit(1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
