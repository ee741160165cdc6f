#!/usr/bin/env python3
"""The main path's z-check: examples/basic on the port against the f64
oracle of artifacts/r5c3/capstone (C: 1000 thermalization pairs, 200 bins
of 40 sweeps on 8 walkers, float64).

Runs examples/basic/parameters.in through ``run_simulation`` with ``[io]
sink = spool`` (no h5py needed) in three arms on the fused engine: float32
at n_stab = 5, float32 at the example's n_stab = 10, and float64.  The
oracle's 1600 bins are bought with walkers: by default 64 walkers x 25
bins of 40 sweeps after 1000 thermalization pairs.  Each arm's logs are
read back with the port's ``read_spool``; density, doubleOcc and swave get
the delete-1 jackknife over every walker's bins (a copy of
dqmc_tpu/analysis/jackknife.py's estimator), and z = |port - oracle| /
sqrt(err_port^2 + err_oracle^2) against the oracle's table.

    python3 scripts/zcheck_basic.py                   # on the GPU
    python3 scripts/zcheck_basic.py --device cpu --walkers 2 --therms 2 \\
        --bins 3 --sweeps 2                           # a rehearsal

Prints the card's name and power limit, one line per arm and observable,
and writes every arm's numbers to ``<out>/zcheck.json``; the spool logs
stay under ``<out>/<arm>/`` (convert them with ``python -m
dqmc_tpu_torch.io.spool <out>/<arm>`` where h5py is installed).  Imports
only the port and numpy.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

# artifacts/r5c3/capstone/table.md, column C (the f64 oracle)
ORACLE = {"density": (0.913057, 6.9e-4), "doubleOcc": (0.342379, 3.9e-4),
          "swave": (1.6769, 1.5e-2)}
ARMS = {"f32_nstab5": dict(dtype="float32", n_stab=5),
        "f32_nstab10": dict(dtype="float32", n_stab=10),
        "f64": dict(dtype="float64", n_stab=10)}


def jackknife(data: np.ndarray):
    """(mean, error) of the delete-1 jackknife over a 1-D array of bins
    (dqmc_tpu/analysis/jackknife.py)."""
    data = np.asarray(data, dtype=np.float64)
    n = len(data)
    if n < 2:
        raise ValueError("Need at least 2 bins for jackknife analysis")
    full_mean = data.mean()
    theta = (n * full_mean - data) / (n - 1)
    var = ((theta - theta.mean()) ** 2).sum() * (n - 1) / n
    return float(full_mean), float(np.sqrt(var))


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or "nvidia-smi gave no output"
    except OSError:
        return "no nvidia-smi"


def run_arm(name, arm, opts, out: Path) -> dict:
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.io.spool import read_bins
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters(str(REPO / "examples" / "basic" / "parameters.in"))
    for key, val in dict(n_therms=opts.therms, n_bins=opts.bins,
                         n_sweeps=opts.sweeps, n_stab=arm["n_stab"],
                         dtype=arm["dtype"], engine="fused",
                         seed=opts.seed).items():
        params.set("simulation", key, val)
    params.set("walkers", "n_walkers", opts.walkers)
    params.set("io", "sink", "spool")
    t0 = time.perf_counter()
    summary = run_simulation(params, out_dir=str(out / name),
                             device=opts.device, verbose=False)
    wall = time.perf_counter() - t0
    series = {o: [] for o in ORACLE}
    for w in range(opts.walkers):
        bins = read_bins(out / name / f"data_{w}.spool")
        if sorted(bins) != list(range(opts.bins)):
            raise SystemExit(f"{name}: walker {w}'s log holds bins "
                             f"{sorted(bins)}")
        for b in sorted(bins):
            for o in ORACLE:
                series[o].append(bins[b]["scalar"][o])
    rec = dict(arm=name, **arm, walkers=opts.walkers, therms=opts.therms,
               bins=opts.bins, sweeps=opts.sweeps, wall_s=wall,
               rate=summary.sweeps_per_sec,
               self_check_max=summary.max_precision_error,
               self_check_mean=summary.mean_precision_error,
               acceptance=summary.acc_rate, observables={})
    for o, (ref, ref_err) in ORACLE.items():
        mean, err = jackknife(np.asarray(series[o]))
        z = abs(mean - ref) / np.hypot(err, ref_err)
        rec["observables"][o] = dict(mean=mean, err=err, z=float(z),
                                     n_bins=len(series[o]))
        print(f"zcheck {name}: {o} {mean:.6f} +- {err:.2e} over "
              f"{len(series[o])} bins against {ref} +- {ref_err:.1e}: "
              f"z = {z:.2f} ({'pass' if z < 2 else 'FAIL'})", flush=True)
    print(f"zcheck {name}: {wall:.1f} s wall, {summary.sweeps_per_sec:.3f} "
          f"walker-sweep-pairs/s measured, self-check max "
          f"{summary.max_precision_error:.3e} mean "
          f"{summary.mean_precision_error:.3e}, acceptance "
          f"{summary.acc_rate:.4f}", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", default=",".join(ARMS),
                    help="comma-separated arms (default: all three)")
    ap.add_argument("--walkers", type=int, default=64)
    ap.add_argument("--therms", type=int, default=1000)
    ap.add_argument("--bins", type=int, default=25)
    ap.add_argument("--sweeps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(REPO / "zcheck_out"))
    opts = ap.parse_args(argv)
    import torch
    if opts.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu for a "
                         "rehearsal")
    where = card() if opts.device == "cuda" else "cpu (rehearsal)"
    print(f"zcheck: {where}", flush=True)
    out = Path(opts.out)
    os.makedirs(out, exist_ok=True)
    records = [run_arm(name, ARMS[name], opts, out)
               for name in opts.arms.split(",")]
    (out / "zcheck.json").write_text(json.dumps(
        dict(device=where, oracle=ORACLE, arms=records), indent=1))


if __name__ == "__main__":
    main()
