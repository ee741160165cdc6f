#!/usr/bin/env python3
"""The float32 and float64 tau sweeps of both packages on free fermions, on
the CPU.

At U = 0 the tau-resolved Green's functions are exact:
Gt0(tau) = e^{-tau K} (I + e^{-beta K})^{-1} and Gtt(tau) = G.  This
script runs the JAX package's ``sweep_unequal_time`` and the port's on the
same configuration (by default the headline's 16x16, beta = 8, nt = 160,
n_stab = 5, mu = 0; one walker; float32 on the CPU takes Householder QR in
both packages) and prints each one's largest |Gt0 - exact| and |Gtt - G|
over every tau and its self-check.  ``chip_smoke.py`` phase 17 makes the
same comparison for the port on the card (K1 in float32); this script
gives the JAX package's own error beside it, which the card cannot run.

    JAX_PLATFORMS=cpu python3 scripts/tau_free_fermions.py [--L 16]
        [--beta 8] [--nt 160] [--n-stab 5]
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def exact(L, beta, nt, dtype):
    import numpy as np
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models.attractive_hubbard import build_kinetic_matrix
    lam, V = np.linalg.eigh(build_kinetic_matrix(square_lattice(L, L), 1.0,
                                                 0.0))
    occ = 1.0 / (1.0 + np.exp(-beta * lam))
    G = (V * occ) @ V.T
    # in the eigenbasis: e^{-tau K} and G apart would meet e^{+-beta |lam|}
    gt0 = [(V * (np.exp(-l * beta / nt * lam) * occ)) @ V.T
           for l in range(nt + 1)]
    return G, gt0


def report(name, Gtt, Gt0, err, G, gt0):
    import numpy as np
    d_t0 = max(np.abs(np.asarray(Gt0[l], np.float64) - w).max()
               for l, w in enumerate(gt0))
    d_tt = max(np.abs(np.asarray(Gtt[l], np.float64) - G).max()
               for l in range(len(gt0)))
    print(f"tau_free_fermions: {name}: max |Gt0 - exact| {d_t0:.3e}, "
          f"max |Gtt - G| {d_tt:.3e}, self-check {float(err):.3e}",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--L", type=int, default=16)
    ap.add_argument("--beta", type=float, default=8.0)
    ap.add_argument("--nt", type=int, default=160)
    ap.add_argument("--n-stab", type=int, default=5)
    o = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch
    from dqmc_tpu.engine.state import EngineConfig as JConfig
    from dqmc_tpu.engine.sweep import init_state as jinit
    from dqmc_tpu.engine.uneqtime import sweep_unequal_time as jsweep
    from dqmc_tpu.lattice import square_lattice as jsquare
    from dqmc_tpu.models import AttractiveHubbard as JModel
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.engine.uneqtime import sweep_unequal_time
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    G, gt0 = exact(o.L, o.beta, o.nt, None)
    print(f"tau_free_fermions: {o.L}x{o.L}, beta = {o.beta:g}, nt = {o.nt}, "
          f"n_stab = {o.n_stab}, U = 0, mu = 0, on the CPU", flush=True)
    for jdt, tdt in ((jnp.float64, torch.float64),
                     (jnp.float32, torch.float32)):
        jm = JModel.build(jsquare(o.L, o.L), U=0.0, t=1.0, mu=0.0,
                          beta=o.beta, nt=o.nt, dtype=jdt)
        jc = JConfig(nt=o.nt, n_stab=o.n_stab)
        ys, err = jsweep(jm, jc, jinit(jm, jc, jax.random.PRNGKey(3)))
        report(f"dqmc_tpu {jnp.dtype(jdt).name}", ys.Gtt[:, 0], ys.Gt0[:, 0],
               err, G, gt0)
        tm = AttractiveHubbard.build(square_lattice(o.L, o.L), U=0.0, t=1.0,
                                     mu=0.0, beta=o.beta, nt=o.nt, dtype=tdt)
        tc = EngineConfig(nt=o.nt, n_stab=o.n_stab)
        ys, err = sweep_unequal_time(
            tm, tc, init_state(tm, tc, make_generators(3, 1, "cpu")))
        report(f"dqmc_tpu_torch {str(tdt)[6:]}", ys.Gtt[0, :, 0],
               ys.Gt0[0, :, 0], err.max(), G, gt0)


if __name__ == "__main__":
    main()
