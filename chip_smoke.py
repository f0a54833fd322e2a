#!/usr/bin/env python
"""Smoke run of the GP-PDE solver on the GPU, in one process.

    python chip_smoke.py          # one card: phases 0-3
    python chip_smoke.py --four   # four cards: phase 0 + the 4-card mesh path
    python chip_smoke.py --four --four-n 10000   # the same at N=10,000

Phase 0 checks the device (a GPU, nothing else). Phase 1 runs the four
upstream CLI configurations through ``GPSolver`` with the acceptance
suite's accuracy gates, the f32 ``exp`` accuracy over the Gram's argument
range, and the elliptic solve again under ``default_matmul_precision
('highest')``. Phase 2 runs elliptic N=20,000, which ``auto_mesh`` routes
to the fused streaming path on a 1-device mesh. Phase 3 runs the Darcy
inverse at N_d=5,000 with the Woodbury step on a 1-device mesh. Both run
cold, then warm. ``--four`` instead runs elliptic N=28,000 (59,904 Gram
rows on one card; ``--four-n`` sets N, with N/8 boundary points) on a
4-card mesh against the same problem on one card, in this process.

Every phase prints what it measured on its own line. A failed gate exits
non-zero before the last line; the last line is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ELLIPTIC_L2_GATE = 3.402e-3  # BASELINE.md row 1 (reference notebook)
FOUR_N = 28000  # --four's default N; N_boundary = N/8, as at N=20,000


def require_gpu():
    """The visible JAX devices; exits non-zero unless they are GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found platform "
            f"{devs[0].platform!r}"
        )
    return devs


def contract_line(devs) -> str:
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    })


def gate(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED {what}")


def solve(w, mesh=None, step_solver="auto"):
    """One end-to-end run of workload ``w``: problem build, factorization,
    GN, posterior extension on the test points; timed to
    ``block_until_ready``."""
    import nonlinpdes_gpsolver as gpt

    t0 = time.perf_counter()
    solver = gpt.GPSolver(w.make(), nugget=w.nugget, mesh=mesh)
    res = solver.solve(max_iter=w.max_iter, step_solver=step_solver)
    pred = res.posterior.extend(w.X_test, block=w.block)
    pred.block_until_ready()
    seconds = time.perf_counter() - t0
    return solver, res, pred, seconds


def errors(w, pred):
    import jax.numpy as jnp
    import nonlinpdes_gpsolver as gpt

    return gpt.GPSolver.errors(pred, jnp.asarray(w.truth, pred.dtype))


def exp_ulp(q_max: float) -> tuple:
    """Max ulp error of ``jnp.exp(-q)`` and of ``exp_neg_accurate`` in f32
    on the device, against f64 on the host, for q in [0, q_max]."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from nonlinpdes_gpsolver.ops.kernels import exp_neg_accurate

    q = np.linspace(0.0, q_max, 1 << 22, dtype=np.float32)
    ref = np.exp(-q.astype(np.float64))
    ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
    out = []
    for fn in (lambda x: jnp.exp(-x), exp_neg_accurate):
        got = np.asarray(jax.jit(fn)(jnp.asarray(q))).astype(np.float64)
        out.append(float(np.max(np.abs(got - ref) / ulp)))
    return tuple(out)


def phase_cli(card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from nonlinpdes_gpsolver.utils import workloads

    gates = {"elliptic": ELLIPTIC_L2_GATE, "burgers": 8e-3, "eikonal": 5e-3,
             "darcy-IP": 5e-3}
    for w in (workloads.elliptic(), workloads.burgers(), workloads.eikonal(),
              workloads.darcy()):
        solve(w)  # cold: compiles
        solver, res, pred, sec = solve(w)
        err = errors(w, pred)
        extra = ""
        if w.a_truth is not None:
            a = np.exp(np.asarray(res.posterior.extend(w.X_test, block="a")))
            a_rel = float(np.sqrt(np.mean((a - w.a_truth) ** 2))
                          / np.sqrt(np.mean(w.a_truth ** 2)))
            extra = f" a_relL2 {a_rel:.4e}"
            gate(a_rel < 0.45, f"{w.name}: a rel-L2 {a_rel} >= 0.45")
        print(f"phase1 [{w.name}] warm end-to-end {sec:.6f} s, test L2 "
              f"{err.l2:.4e} max {err.max:.4e}{extra} [{card}]", flush=True)
        gate(err.l2 < gates[w.name.split()[0]],
             f"{w.name}: test L2 {err.l2} over its gate")

    # the f32 path (opt-in): no f32 result may depend on the TF32 default,
    # so forcing 'highest' everywhere must change nothing
    w32 = workloads.elliptic(dtype=jnp.float32)
    solve(w32)
    solver, res, pred, sec = solve(w32)
    with jax.default_matmul_precision("highest"):
        _, res_hi, _, _ = solve(w32)
    dz = float(np.max(np.abs(np.asarray(res_hi.z) - np.asarray(res.z))))
    print(f"phase1 [{w32.name} f32] warm end-to-end {sec:.6f} s, test L2 "
          f"{errors(w32, pred).l2:.4e}, nugget scale "
          f"{solver.fp.nugget_scales}; under default_matmul_precision"
          f"('highest') max|dz| {dz:.6e} [{card}]", flush=True)

    q_max = 2.0 * 12.5  # sum_k a_k |u_k|^2 on the unit square, sigma=0.2
    e_native, e_acc = exp_ulp(q_max)
    print(f"phase1 f32 exp(-q), q in [0, {q_max}]: max ulp jnp.exp "
          f"{e_native:.3f}, exp_neg_accurate {e_acc:.3f}", flush=True)


def phase_elliptic_20k(dev, card: str) -> None:
    from nonlinpdes_gpsolver.utils import workloads

    w = workloads.elliptic(N=20000, Nb=2500)
    cold = solve(w)[3]  # nothing of the cold run outlives it
    solver, res, pred, warm = solve(w)
    gate(solver.mesh is not None, "N=20,000 did not take the mesh path")
    err = errors(w, pred)
    fac = solver.fp.factors["u"]
    fbytes = fac.n_pad * fac.n_pad * fac.local.dtype.itemsize
    peak = dev.memory_stats()["peak_bytes_in_use"]
    print(f"phase2 [{w.name}] auto_mesh -> fused path on "
          f"{solver.mesh.devices.size} device(s), n_pad {fac.n_pad}: cold "
          f"{cold:.6f} s, warm {warm:.6f} s, test L2 {err.l2:.4e}, "
          f"peak_bytes_in_use {peak} = {peak / fbytes:.3f} x the factor, cg_iters "
          f"{[int(i) for i in res.state.cg_iters]} [{card}]", flush=True)
    gate(err.l2 <= ELLIPTIC_L2_GATE, f"N=20,000 test L2 {err.l2}")


def phase_darcy_5k(card: str) -> None:
    import numpy as np
    from nonlinpdes_gpsolver.parallel import make_mesh
    from nonlinpdes_gpsolver.utils import workloads

    w = workloads.darcy(N=5000, Nb=1250)
    mesh = make_mesh(1)
    cold = solve(w, mesh=mesh, step_solver="woodbury")[3]
    _, res, pred, warm = solve(w, mesh=mesh, step_solver="woodbury")
    err = errors(w, pred)
    iters = np.asarray(res.state.cg_iters)
    print(f"phase3 [{w.name}] woodbury on a 1-device mesh: cold {cold:.6f} s, "
          f"warm {warm:.6f} s, u test L2 {err.l2:.4e}, cg_iters "
          f"{iters.tolist()}, losses {np.asarray(res.losses).tolist()} "
          f"[{card}]", flush=True)
    gate(err.l2 < 5e-3, f"Darcy N_d=5,000 u L2 {err.l2}")
    gate(bool(np.all(np.isfinite(iters)) and np.all(iters > 0)),
         f"Darcy N_d=5,000 cg_iters {iters.tolist()}")


def phase_four(devs, card: str, N: int = FOUR_N) -> None:
    """Elliptic N on a 4-card mesh against a 1-device mesh; one run each,
    compile included."""
    import numpy as np
    from nonlinpdes_gpsolver.parallel import make_mesh
    from nonlinpdes_gpsolver.utils import workloads

    gate(len(devs) >= 4, f"--four needs 4 GPUs, found {len(devs)}")
    w = workloads.elliptic(N=N, Nb=N // 8)
    runs, peaks = {}, []
    # 4 cards first: peak_bytes_in_use is a per-process maximum, so each
    # card's peak is read before the 1-card run parks a full factor on one
    for P in (4, 1):
        solver, res, pred, sec = solve(w, mesh=make_mesh(P))
        err = errors(w, pred)
        fac = solver.fp.factors["u"]
        shard = fac.n_pad * fac.n_pad * fac.local.dtype.itemsize // P
        runs[P] = (np.asarray(res.z), float(res.losses[-1]))
        print(f"four [{w.name}] {P}-card mesh, n_pad {fac.n_pad}: "
              f"{sec:.6f} s (compile included), test L2 {err.l2:.4e}, final "
              f"loss {runs[P][1]:.6e}, nugget scale "
              f"{solver.fp.nugget_scales} [{card}]", flush=True)
        gate(err.l2 <= ELLIPTIC_L2_GATE, f"{P}-card test L2 {err.l2}")
        for d in devs[:P]:
            peak = d.memory_stats()["peak_bytes_in_use"]
            print(f"four {P}-card run, card {d.id}: peak_bytes_in_use {peak} "
                  f"= {peak / shard:.3f} x its factor shard ({shard} bytes)",
                  flush=True)
            if P == 4:
                gate(peak >= shard, f"card {d.id} peak {peak} < its shard")
                peaks.append(peak)
        del solver, res, pred, fac
    peak1 = devs[0].memory_stats()["peak_bytes_in_use"]
    gate(max(peaks) <= peak1 / 2,
         f"4-card peaks {peaks} are not a share of the 1-card peak {peak1}")
    (z4, l4), (z1, l1) = runs[4], runs[1]
    dz = float(np.max(np.abs(z4 - z1)) / np.max(np.abs(z1)))
    rel = abs(l4 / l1 - 1.0)
    print(f"four 4-card vs 1-card: final-loss rel diff {rel:.6e}, "
          f"max|dz|/max|z| {dz:.6e}, max 4-card peak / 1-card peak "
          f"{max(peaks) / peak1:.3f}", flush=True)
    gate(rel < 1e-3, f"4-card vs 1-card final losses differ by {rel}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh path and its 1-card comparison")
    ap.add_argument("--four-n", type=int, default=FOUR_N,
                    help="N_domain of the --four problem (default %(default)s)")
    args = ap.parse_args()

    devs = require_gpu()
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import jax
    from nonlinpdes_gpsolver.utils.config import card_info, setup_runtime

    cache = setup_runtime()  # the program's default precision, f64
    dev = devs[0]
    card = card_info()
    print(f"phase0 device {dev.device_kind}, count {len(devs)}, bytes_limit "
          f"{dev.memory_stats()['bytes_limit']}", flush=True)
    print(f"phase0 nvidia-smi: {'; '.join(card.splitlines())}", flush=True)
    print(f"phase0 compile cache {cache}, jax {jax.__version__}", flush=True)
    card = card.splitlines()[0]

    if args.four:
        phase_four(devs, card, args.four_n)
    else:
        phase_cli(card)
        phase_elliptic_20k(dev, card)
        phase_darcy_5k(card)
    print(contract_line(devs), flush=True)


if __name__ == "__main__":
    main()
