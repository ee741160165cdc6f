#!/usr/bin/env python3
"""Parallel tempering's z-check: examples/tempering on the port, replica 0
against a standard run of the same model at its beta.

Runs examples/tempering/parameters.in as written (6x6, U=4, mu=-0.1,
nt=50, n_stab=10, the half-warp, betas 5.0-2.5, 300 thermalization pairs,
25 bins of 40 sweeps, an exchange attempt every 10 sweeps) through
``run_simulation`` with ``[io] sink = spool`` in two arms: float32 with
f64 exchange actions (the default on the card) and float64.  The
reference is a standard (non-PT) float64 run of the same model at beta =
5.0, the first replica's, with 64 walkers at the same depth.  Replica 0's
density, doubleOcc and swave (its 25 bins; the reference's 64 x 25) get
the delete-1 jackknife (scripts/zcheck_basic.py's), and z = |arm - ref| /
sqrt(err_arm^2 + err_ref^2) must stay below 2.

    python3 scripts/pt_zcheck.py                      # on the GPU
    python3 scripts/pt_zcheck.py --device cpu --therms 2 --bins 3 \\
        --sweeps 10 --walkers 2                       # a rehearsal

Prints the card's name and power limit, one line per arm and observable
with each arm's self-check and exchange rate, and writes every number to
``<out>/pt_zcheck.json``.  Imports only the port and numpy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

from zcheck_basic import card, jackknife  # noqa: E402

OBSERVABLES = ("density", "doubleOcc", "swave")
ARMS = {"pt_f32_f64actions": dict(dtype="float32", pt=True),
        "pt_f64": dict(dtype="float64", pt=True),
        "reference_f64": dict(dtype="float64", pt=False)}


def run_arm(name, arm, opts, out: Path) -> dict:
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.io.spool import read_bins
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters(str(REPO / "examples" / "tempering" /
                            "parameters.in"))
    for key, val in dict(n_therms=opts.therms, n_bins=opts.bins,
                         n_sweeps=opts.sweeps, dtype=arm["dtype"],
                         seed=opts.seed).items():
        params.set("simulation", key, val)
    params.set("io", "sink", "spool")
    walkers = 1
    if not arm["pt"]:
        params.set("ParallelTempering", "enabled", "false")
        params.set("walkers", "n_walkers", opts.walkers)
        walkers = opts.walkers
    t0 = time.perf_counter()
    summary = run_simulation(params, out_dir=str(out / name),
                             device=opts.device, verbose=False)
    wall = time.perf_counter() - t0
    series = {o: [] for o in OBSERVABLES}
    for w in range(walkers):         # a PT arm: replica 0 only
        bins = read_bins(out / name / f"data_{w}.spool")
        if sorted(bins) != list(range(opts.bins)):
            raise SystemExit(f"{name}: log {w} holds bins {sorted(bins)}")
        for b in sorted(bins):
            for o in OBSERVABLES:
                series[o].append(bins[b]["scalar"][o])
    rec = dict(arm=name, **arm, walkers=walkers, therms=opts.therms,
               bins=opts.bins, sweeps=opts.sweeps, wall_s=wall,
               rate=summary.sweeps_per_sec,
               exchange_rate=summary.exchange_rate,
               self_check_max=summary.max_precision_error,
               self_check_mean=summary.mean_precision_error,
               acceptance=summary.acc_rate, observables={})
    for o in OBSERVABLES:
        mean, err = jackknife(np.asarray(series[o]))
        rec["observables"][o] = dict(mean=mean, err=err,
                                     n_bins=len(series[o]))
    print(f"pt_zcheck {name}: {wall:.1f} s wall, {summary.sweeps_per_sec:.3f}"
          f" {'replica' if arm['pt'] else 'walker'}-sweep-pairs/s measured, "
          f"exchange rate {summary.exchange_rate:.4f}, self-check max "
          f"{summary.max_precision_error:.3e} mean "
          f"{summary.mean_precision_error:.3e}, acceptance "
          f"{summary.acc_rate:.4f}", flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--walkers", type=int, default=64,
                    help="the reference run's walkers")
    ap.add_argument("--therms", type=int, default=300)
    ap.add_argument("--bins", type=int, default=25)
    ap.add_argument("--sweeps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=str(REPO / "zcheck_out" / "pt"))
    opts = ap.parse_args(argv)
    import torch
    if opts.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: run with --device cpu for a "
                         "rehearsal")
    where = card() if opts.device == "cuda" else "cpu (rehearsal)"
    print(f"pt_zcheck: {where}", flush=True)
    out = Path(opts.out)
    os.makedirs(out, exist_ok=True)
    recs = {name: run_arm(name, arm, opts, out)
            for name, arm in ARMS.items()}
    ref = recs["reference_f64"]["observables"]
    failed = []
    for name in ("pt_f32_f64actions", "pt_f64"):
        for o in OBSERVABLES:
            a, r = recs[name]["observables"][o], ref[o]
            z = abs(a["mean"] - r["mean"]) / np.hypot(a["err"], r["err"])
            a["z"] = float(z)
            print(f"pt_zcheck {name}: replica 0 {o} {a['mean']:.6f} +- "
                  f"{a['err']:.2e} against the reference {r['mean']:.6f} "
                  f"+- {r['err']:.2e}: z = {z:.2f} "
                  f"({'pass' if z < 2 else 'FAIL'})", flush=True)
            if not z < 2:
                failed.append(f"{name} {o}")
    (out / "pt_zcheck.json").write_text(json.dumps(
        dict(device=where, arms=list(recs.values())), indent=1))
    if failed:
        raise SystemExit(f"pt_zcheck: z >= 2 in {failed}")


if __name__ == "__main__":
    main()
