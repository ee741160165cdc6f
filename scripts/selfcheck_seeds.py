#!/usr/bin/env python3
"""Steady self-check error of ``chip_smoke.py``'s phase 4 over several
seeds, on the card.

Phase 4 runs examples/basic through ``run_simulation`` in float32 with the
sweep counts cut (n_therms=50, n_bins=4, n_sweeps=20, n_stab=2) and gates
the steady self-check max (the largest naive-vs-stabilized error of the
measurement phase) at 1e-2.  That max is one tail event of one chain, so
one seed says little about a change of summation order.  This script runs
the same configuration once per seed, in worker processes (the runs are
host-bound, so they share the card well), and prints each seed's steady
max and mean and the sorted maxima.

    python3 scripts/selfcheck_seeds.py [--seeds 42,1,2,3] [--jobs 4]

It runs the package of the checkout it sits in; copy it into another
checkout to run that one.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CUT = dict(n_therms=50, n_bins=4, n_sweeps=20, n_stab=2)


def run_seed(seed: int) -> tuple:
    sys.path.insert(0, str(REPO))
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters(str(REPO / "examples" / "basic" / "parameters.in"))
    for key, val in {**CUT, "seed": seed}.items():
        params.set("simulation", key, val)
    t0 = time.perf_counter()
    s = run_simulation(params, out_dir=None, device="cuda")
    return (seed, s.max_precision_error, s.mean_precision_error, s.acc_rate,
            time.perf_counter() - t0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="42,1,2,3,4,5,6,7",
                    help="comma-separated seeds (42 is phase 4's)")
    ap.add_argument("--jobs", type=int, default=4)
    opts = ap.parse_args()
    seeds = [int(s) for s in opts.seeds.split(",")]
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from dqmc_tpu_torch import _cuda
    _cuda.build()                     # once, before the workers load it
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True)
    print(f"{REPO}: {smi.stdout.strip()}; examples/basic f32 "
          f"{', '.join(f'{k}={v}' for k, v in CUT.items())}", flush=True)
    with mp.get_context("spawn").Pool(opts.jobs) as pool:
        rows = pool.map(run_seed, seeds)
    for seed, mx, mean, acc, dt in rows:
        print(f"{REPO.name} seed {seed}: steady self-check max {mx:.3e}, "
              f"mean {mean:.3e}, acceptance {acc:.4f}, {dt:.1f} s",
              flush=True)
    maxima = sorted(r[1] for r in rows)
    print(f"{REPO.name} sorted maxima: "
          f"{', '.join(f'{m:.3e}' for m in maxima)}; above 1e-2: "
          f"{sum(m >= 1e-2 for m in maxima)} of {len(maxima)}", flush=True)


if __name__ == "__main__":
    main()
