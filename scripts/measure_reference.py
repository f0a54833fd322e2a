#!/usr/bin/env python
"""Measure the upstream reference implementation end-to-end on this host.

Runs each of the reference's four README CLI workloads
(``/root/reference/README.md:15-21``) in a subprocess (CPU, f64 - the only
mode it supports) and records wall-clock seconds + the errors it prints to
``REF_BASELINE.json``. ``bench.py`` and PERF.md read these instead of a
hard-coded constant (round-1 VERDICT weak item 6).

    python scripts/measure_reference.py [--ref /root/reference] [--only elliptic]

The reference renders matplotlib figures with LaTeX text at show time; we
run with a non-interactive backend and show_figure disabled where exposed.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

WORKLOADS = {
    # name -> (script, args). Args = the README commands; elliptic uses the
    # 4-GN-step config that bench.py's headline measures against.
    "elliptic": (
        "main_NonLinElliptic2d.py",
        ["--kernel", "Gaussian", "--kernel_parameter", "0.2", "--nugget",
         "1e-13", "--N_domain", "900", "--N_boundary", "124", "--GNsteps", "4"],
    ),
    "burgers": (
        "main_Burgers1d.py",
        ["--kernel", "anisotropic_Gaussian", "--kernel_parameter", "0.3",
         "0.05", "--nugget", "1e-5", "--N_domain", "1000", "--N_boundary",
         "200", "--GNsteps", "8"],
    ),
    "eikonal": (
        "main_Eikonal2d.py",
        ["--kernel", "Gaussian", "--kernel_parameter", "0.2", "--nugget",
         "1e-5", "--N_domain", "1000", "--N_boundary", "200", "--GNsteps", "8"],
    ),
    "darcy": (
        "main_DarcyFlow2d.py",
        ["--kernel", "Gaussian", "--kernel_parameter", "0.2", "--nugget",
         "1e-8", "--N_domain", "400", "--N_boundary", "100", "--N_data",
         "60", "--noise_level", "0.001", "--GNsteps", "8"],
    ),
}

ERR_RE = re.compile(r"L2 error\s+([0-9.eE+-]+)")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ref", default="/root/reference")
    ap.add_argument("--only", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    ref = Path(args.ref)
    out_path = Path(
        args.out or Path(__file__).resolve().parent.parent / "REF_BASELINE.json"
    )

    results = {}
    if out_path.exists():
        results = json.loads(out_path.read_text())

    env = dict(os.environ)
    env["MPLBACKEND"] = "Agg"
    # the reference is CPU-only; pinning the child to the CPU also keeps it
    # off any GPU (a second JAX process on a card fails for want of memory)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ref)

    for name, (script, flags) in WORKLOADS.items():
        if args.only and args.only not in name:
            continue
        cmd = [sys.executable, str(ref / script), *flags, "--show_figure", ""]
        print(f"[{name}] {' '.join(cmd[1:])}", flush=True)
        t0 = time.perf_counter()
        proc = subprocess.run(
            cmd, cwd=str(ref), env=env, capture_output=True, text=True,
            timeout=7200,
        )
        dt = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stdout[-2000:])
            print(proc.stderr[-2000:])
            raise SystemExit(f"{name} failed rc={proc.returncode}")
        l2 = ERR_RE.findall(proc.stdout)
        results[name] = {
            "seconds": round(dt, 2),
            "l2_errors_printed": [float(x) for x in l2],
            "cmd": " ".join([script, *flags]),
            "host": "this-host CPU f64 (reference supports nothing else)",
        }
        print(f"  {dt:.1f}s  L2s={l2}", flush=True)
        out_path.write_text(json.dumps(results, indent=2) + "\n")
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
