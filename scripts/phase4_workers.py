#!/usr/bin/env python3
"""``chip_smoke.py`` phase 4's wall time against the number of seed
workers beside its main run: seed 42 in this process and seeds 1-7 of
``scripts/selfcheck_seeds.py`` in k spawned workers, the same work each
time, at the smoke's sweep counts.

    python3 scripts/phase4_workers.py 7,3,1

Prints, per k, the main run's seconds, the whole phase's and the eight
steady self-check maxima (the same for every k).  Needs a CUDA card.
"""

import multiprocessing as mp
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))


def main() -> None:
    from dqmc_tpu_torch import _cuda
    from selfcheck_seeds import run_seed
    _cuda.build()                     # once, before the workers load it
    for k in [int(x) for x in sys.argv[1].split(",")]:
        t0 = time.perf_counter()
        pool = mp.get_context("spawn").Pool(k)
        others = pool.map_async(run_seed, [1, 2, 3, 4, 5, 6, 7])
        t1 = time.perf_counter()
        main_row = run_seed(42)
        t_main = time.perf_counter() - t1
        rows = others.get(timeout=1500)
        pool.close()
        pool.join()
        print(f"workers {k}: main run {t_main:.1f} s, all "
              f"{time.perf_counter() - t0:.1f} s; maxima "
              + ", ".join(f"{r[1]:.3e}" for r in [main_row] + rows),
              flush=True)


if __name__ == "__main__":
    main()
