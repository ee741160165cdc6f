#!/usr/bin/env python3
"""How far the fused submatrix site loop (#2c) lies from its twins in
float64 at ns = 512, over several seeds, on the card.

``chip_smoke.py`` phase 10 holds #2c's float64 site loop at 16 x 32
(ns = 512, W = 16, k = 32, the first slice of a fresh walker batch) to
the nearer of its two plain twins, the one on the card and the one on the
CPU: within max(1e-9, the twins' spread) and within min(max(1e-12,
spread / max|G|), 1e-11) of max|G|.  The twins differ only in summation
order, so their spread says how far a change of order alone moves G on
those inputs.  This script draws the phase's inputs from each seed (the
walkers' fields and the slice's streams) and prints, per seed, the
kernel's distance from each twin, the twins' spread, max|G|, the
decisions that differ, and whether the gate passes.  The gate is not
changed here.

    python3 scripts/sub_gate_seeds.py [--seeds 1,2,3,4,5,6,7,8]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def one_seed(torch, seed: int) -> dict:
    from chip_smoke import BLOCK_SHAPES_SUB_F64, block_inputs
    from dqmc_tpu_torch.engine import fused
    W, L, beta, nt, n = BLOCK_SHAPES_SUB_F64[1]
    dtype = torch.float64
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    model, states, order, props, us = block_inputs(
        torch, gen, W, L, beta, nt, n, dtype, seed=seed)
    ns = model.n_sites
    k = fused._k_delay(ns)
    _, _, gb, delta, _, _ = fused.site_factors(
        model, states.fields[:, :n], props, dtype)
    u_ = us.reshape(W, -1).contiguous()
    o32 = order.to(torch.int32).contiguous()
    G0 = states.G[:, 0].contiguous()

    def run_sites(fn, dev="cuda"):
        Gc = G0.to(dev).clone()
        m = torch.zeros((W, n * ns), dtype=dtype, device=dev)
        fn(Gc, m, o32.to(dev), gb.to(dev), delta.to(dev), u_.to(dev), 0, k)
        return Gc.cpu(), m.cpu()
    Gk, mk = run_sites(fused.site_loop_sub_cuda)
    Gc, mc = run_sites(fused.site_loop_sub_plain)
    Gh, mh = run_sites(fused.site_loop_sub_plain, "cpu")
    gmax = float(Gc.abs().max())
    to_card = float((Gk - Gc).abs().max())
    to_host = float((Gk - Gh).abs().max())
    spread = float((Gh - Gc).abs().max())
    near = min(to_card, to_host)
    tol = max(1e-9, spread)
    rtol = min(max(1e-12, spread / gmax), 1e-11)
    if tol == 1e-9 and rtol == 1e-12:
        near = to_card
    return dict(seed=seed, gmax=gmax, to_card=to_card, to_host=to_host,
                spread=spread, near=near,
                decisions=int((mk != mc).sum()) + int((mh != mc).sum()),
                accepted=int(mc[:, :ns].sum()),
                passes=near <= tol and near / gmax <= rtol)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="1,2,3,4,5,6,7,8")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from dqmc_tpu_torch import _cuda
    _cuda.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    rows = [one_seed(torch, int(s)) for s in opts.seeds.split(",")]
    for r in rows:
        print(f"sub_gate_seeds: seed {r['seed']}: ns = 512 f64, "
              f"{r['accepted']} accepted; kernel to the card's twin "
              f"{r['to_card']:.3e}, to the CPU's twin {r['to_host']:.3e}, "
              f"the twins' spread {r['spread']:.3e}, max|G| "
              f"{r['gmax']:.3e}; nearer twin / max|G| "
              f"{r['near'] / r['gmax']:.3e}, spread / max|G| "
              f"{r['spread'] / r['gmax']:.3e}; decisions that differ "
              f"{r['decisions']}; gate {'passes' if r['passes'] else 'FAILS'}",
              flush=True)
    print(f"sub_gate_seeds: {sum(r['passes'] for r in rows)} of {len(rows)} "
          f"seeds pass the gate", flush=True)


if __name__ == "__main__":
    main()
