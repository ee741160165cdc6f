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

    python3 scripts/sub_gate_seeds.py [--seeds 1,2,3,4,5,6,7,8] [--save DIR]

needs a CUDA card; ``--save DIR`` also writes each seed's slice inputs and
the three results (kernel, card twin, CPU twin) to ``DIR/seed<N>.npz``.

The referee, on any machine with the JAX package (no card):

    python3 scripts/sub_gate_seeds.py referee DIR

replays each saved slice through (a) a numpy ``longdouble`` run of the
twin's arithmetic (``ops/kernels.py`` submatrix_slice_plain: decisions on
G[I, I] through the bordered inverse, then G += G[:, I] W (G[I, :] -
E_I), group by group; ``longdouble`` is x87 extended precision, 64-bit
mantissa, where the platform has it) and (b) the JAX package's #2c
(``dqmc_tpu.engine.fused.fused_block`` with update = "submatrix",
interpret mode, float64) as one backward slice of a model whose expK is
the identity, so that its wrap is diag(1/ev) G diag(ev) and is undone
exactly enough (two roundings per entry) to read the site loop's G.  It
prints, per seed, each result's distance from the longdouble referee over
max|G|.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def one_seed(torch, seed: int, save=None, ref=False) -> dict:
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
    out = {}
    if ref or save is not None:
        import numpy as np
        G_ref, acc_ref = twin_longdouble(
            G0.cpu().numpy(), o32.cpu().numpy(), gb.cpu().numpy(),
            delta.cpu().numpy(), u_.cpu().numpy(), k)
        gmax_ref = float(np.abs(G_ref).max())
        per_walker = {name: np.abs(G.numpy().astype(np.longdouble)
                                   - G_ref).max(axis=(1, 2)).astype(float)
                      for name, G in (("kernel", Gk), ("card twin", Gc),
                                      ("CPU twin", Gh))}
        out["ref"] = {name: float(d.max()) / gmax_ref
                      for name, d in per_walker.items()}
        o = o32[0].long().cpu().numpy()
        out["ref_decisions"] = int((mk.numpy()[:, o] != acc_ref).sum())
    if save is not None:
        # the walker whose kernel result lies farthest from the referee:
        # its inputs and the four results (the whole batch would not fit
        # the output directory)
        w = int(per_walker["kernel"].argmax())
        one = slice(w, w + 1)
        L1, L2 = L
        np.savez(Path(save) / f"seed{seed}.npz", walker=w,
                 G0=G0[one].cpu().numpy(), order=o32.cpu().numpy(),
                 gb=gb[one].cpu().numpy(), delta=delta[one].cpu().numpy(),
                 us=u_[one].cpu().numpy(),
                 fields=states.fields[one, :n].cpu().numpy(),
                 props=props[one].cpu().numpy(), k=k, n=n, L1=L1, L2=L2,
                 beta=beta, nt=nt, U=4.0, mu=-0.1, gmax=gmax_ref,
                 G_ref=G_ref[one].astype(np.float64),
                 G_kernel=Gk[one].numpy(), G_card_twin=Gc[one].numpy(),
                 G_cpu_twin=Gh[one].numpy(), acc_kernel=mk[one].numpy())
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
                spread=spread, near=near, **out,
                decisions=int((mk != mc).sum()) + int((mh != mc).sum()),
                accepted=int(mc[:, :ns].sum()),
                passes=near <= tol and near / gmax <= rtol)


def twin_longdouble(G0, order, gb, delta, us, k):
    """site_loop_sub_plain on slice 0 (one flavor) in numpy longdouble:
    gb and delta are site-indexed, us visit-indexed; returns G (W, n, n)
    and the acceptances (W, n) in visit order."""
    import numpy as np
    ld = np.longdouble
    G = G0.astype(ld)
    W, n, _ = G.shape
    o = order[0].astype(np.int64)
    gb, delta = gb[:, o].astype(ld), delta[:, o].astype(ld)
    us = us[:, :n].astype(ld)
    acc = np.zeros((W, n))
    sites = np.broadcast_to(o, (W, n))
    ar = np.arange(W)
    for v0 in range(0, n, k):
        cnt = min(k, n - v0)
        I = sites[:, v0:v0 + cnt]
        GII = G[ar[:, None, None], I[:, :, None], I[:, None, :]]
        Wb = np.zeros((W, cnt, cnt), ld)
        mask = np.zeros((W, cnt), ld)
        for t in range(cnt):
            idx = v0 + t
            b = -GII[:, t, :] * mask
            c = -GII[:, :, t] * mask
            Wc = np.einsum("wpq,wq->wp", Wb, c)
            bW = np.einsum("wp,wpq->wq", b, Wb)
            bWc = np.sum(b * Wc, axis=-1)
            d = delta[:, idx]
            rf = 1 + d * (1 - GII[:, t, t]) - d * bWc
            ok = us[:, idx] < gb[:, idx] * rf * rf
            inv_s = np.where(ok, d / rf, 0)
            Wb = Wb + inv_s[:, None, None] * Wc[:, :, None] * bW[:, None, :]
            Wb[:, t, :] = np.where(ok[:, None], -inv_s[:, None] * bW,
                                   Wb[:, t, :])
            Wb[:, :, t] = np.where(ok[:, None], -inv_s[:, None] * Wc,
                                   Wb[:, :, t])
            Wb[:, t, t] = np.where(ok, inv_s, Wb[:, t, t])
            mask[:, t] = np.where(ok, 1, mask[:, t])
            acc[:, idx] = ok
        rows = G[ar[:, None], I, :]                      # (W, cnt, n)
        rows[ar[:, None], np.arange(cnt)[None, :], I] -= 1
        Ut = np.swapaxes(G[ar[:, None], :, I], 1, 2)     # (W, n, cnt)
        G = G + Ut @ (Wb @ rows)
    return G, acc


def jax_replay(z):
    """The JAX package's #2c on the saved slice (interpret mode, float64):
    one backward slice of a model whose expK is the identity, its wrap
    undone.  Returns (G, the post-update fields)."""
    import dataclasses
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    from dqmc_tpu import hsfield
    from dqmc_tpu.engine.fused import fused_block
    from dqmc_tpu.lattice import square_lattice
    from dqmc_tpu.models import AttractiveHubbard
    m = AttractiveHubbard.build(
        square_lattice(int(z["L1"]), int(z["L2"])), U=float(z["U"]), t=1.0,
        mu=float(z["mu"]), beta=float(z["beta"]), nt=int(z["nt"]),
        dtype=jnp.float64)
    eye = jnp.eye(m.n_sites, dtype=jnp.float64)
    m = dataclasses.replace(m, expK=eye, invexpK=eye)
    n = int(z["n"])
    ns = m.n_sites
    G, fields, _, _ = fused_block(
        m, jnp.asarray(z["order"][:1]), jnp.asarray(z["props"][:, :1]),
        jnp.asarray(z["us"][:, :ns].reshape(-1, 1, ns)),
        jnp.asarray(z["G0"][:, None]), jnp.asarray(z["fields"][:, :1]),
        n_slices=1, k_delay=int(z["k"]), forward=False, interpret=True,
        update="submatrix")[:4]
    fields = np.asarray(fields)[:, 0]
    ev = np.exp(float(m.g) * np.asarray(hsfield.ETA)[fields])   # (W, ns)
    G = np.asarray(G)[:, 0]
    return ev[:, :, None] * G / ev[:, None, :], fields


def referee(path: Path) -> None:
    """The JAX package's #2c on each saved walker against the longdouble
    referee (recomputed here, and the card run's copy)."""
    import numpy as np
    for f in sorted(path.glob("seed*.npz")):
        z = np.load(f)
        G_ref, acc_ref = twin_longdouble(z["G0"], z["order"], z["gb"],
                                         z["delta"], z["us"], int(z["k"]))
        G_jax, _ = jax_replay(z)
        gmax = float(z["gmax"])
        rows = {name: z[key] for name, key in (
            ("kernel", "G_kernel"), ("card twin", "G_card_twin"),
            ("CPU twin", "G_cpu_twin"), ("the card run's referee", "G_ref"))}
        rows["JAX #2c (interpret)"] = G_jax
        dist = {name: float(np.abs(G.astype(np.longdouble) - G_ref).max())
                / gmax for name, G in rows.items()}
        o = z["order"][0].astype(np.int64)
        same = int((z["acc_kernel"][:, o] != acc_ref).sum())
        print(f"sub_gate_seeds referee: {f.stem}, walker {int(z['walker'])}"
              f" (the batch's max|G| {gmax:.4e}): distance from the "
              f"longdouble twin over max|G|: "
              + ", ".join(f"{k} {v:.3e}" for k, v in dist.items())
              + f"; kernel decisions differing from it {same}", flush=True)


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "referee":
        return referee(Path(sys.argv[2]))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="1,2,3,4,5,6,7,8")
    ap.add_argument("--save", default=None,
                    help="directory for each seed's worst walker's inputs "
                    "and results (implies --referee)")
    ap.add_argument("--referee", action="store_true",
                    help="also hold every result against the longdouble "
                    "twin")
    opts = ap.parse_args()
    if opts.save:
        Path(opts.save).mkdir(parents=True, exist_ok=True)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from dqmc_tpu_torch import _cuda
    _cuda.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    rows = [one_seed(torch, int(s), opts.save, opts.referee)
            for s in opts.seeds.split(",")]
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
        if "ref" in r:
            print(f"sub_gate_seeds: seed {r['seed']}: distance from the "
                  f"longdouble twin over its max|G|, the largest over the "
                  f"walkers: " + ", ".join(f"{k} {v:.3e}"
                                            for k, v in r["ref"].items())
                  + f"; kernel decisions differing from it "
                  f"{r['ref_decisions']}", flush=True)
    print(f"sub_gate_seeds: {sum(r['passes'] for r in rows)} of {len(rows)} "
          f"seeds pass the gate", flush=True)


if __name__ == "__main__":
    main()
