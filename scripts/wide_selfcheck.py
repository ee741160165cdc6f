#!/usr/bin/env python3
"""Steady self-check error of ``chip_smoke.py``'s 40x40 run (phase 21 (b))
beside variants of it, on the card.

Phase 21 runs 40x40, U=4, mu=0, beta=4, nt=80, n_stab=5, W=4 in float32
on the per-slice engine (#3 and K1) for 1 + 2x1 sweep pairs.  This script
runs that configuration and one change of it per line -- the QR (K1 or
Householder), n_stab, the thermalization, the lattice, the site update,
the float type -- each through ``run_simulation`` in a worker process of
its own (the card is shared), and prints each run's steady self-check
max and mean (the measured pairs only) and the thermalization's max, so
that a float32 reading can be told from a kernel's fault.

    python3 scripts/wide_selfcheck.py [--jobs 4] [--only NAME,...]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BASE = dict(L=40, n_stab=5, n_therms=1, n_bins=2, dtype="float32",
            walkers=4, site_update="pallas", qr="cgs2")
# name: the changes from BASE
VARIANTS = {
    "phase 21": {},
    "householder": dict(qr="householder"),
    "n_stab=2": dict(n_stab=2),
    "n_stab=1": dict(n_stab=1),
    "10 therm": dict(n_therms=10),
    "20 therm": dict(n_therms=20),
    "40 therm": dict(n_therms=40),
    "16x16 40 therm": dict(L=16, n_therms=40, n_bins=10),
    "16x16": dict(L=16),
    "24x24": dict(L=24),
    "scan (#6)": dict(site_update="scan"),
    "float64": dict(dtype="float64", walkers=2),
}


def text_of(c: dict) -> str:
    return f"""
[Lattice]
L1 = {c['L']}
L2 = {c['L']}
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 4.0
nt = 80
n_stab = {c['n_stab']}
n_therms = {c['n_therms']}
n_bins = {c['n_bins']}
n_sweeps = 1
dtype = {c['dtype']}
site_update = {c['site_update']}
seed = 42
[walkers]
n_walkers = {c['walkers']}
"""


def run_variant(name: str) -> tuple:
    sys.path.insert(0, str(REPO))
    import torch
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.ops import linalg
    from dqmc_tpu_torch.run import run_simulation
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    c = {**BASE, **VARIANTS[name]}
    linalg.set_f32_orthogonalization(c["qr"])
    t0 = time.perf_counter()
    s = run_simulation(Parameters.from_string(text_of(c)), out_dir=None,
                       device="cuda", verbose=False)
    return (name, s.max_precision_error, s.mean_precision_error,
            s.therm_max_precision_error, s.acc_rate,
            time.perf_counter() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--only", default=",".join(VARIANTS))
    opts = ap.parse_args(argv)
    names = opts.only.split(",")
    with mp.get_context("spawn").Pool(opts.jobs) as pool:
        rows = pool.map(run_variant, names)
    print(f"{'run':14s} {'steady max':>11s} {'steady mean':>11s} "
          f"{'therm max':>11s} {'acc':>7s} {'s':>6s}")
    for name, mx, mean, therm, acc, dt in rows:
        print(f"{name:14s} {mx:11.3e} {mean:11.3e} {therm:11.3e} "
              f"{acc:7.4f} {dt:6.1f}")


if __name__ == "__main__":
    main()
