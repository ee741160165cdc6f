#!/usr/bin/env python3
"""How far the float32 tau sweep sits from float64 on the headline's
fields: the port on the card, and the JAX package on the same fields on
the CPU.

``card`` runs the headline (16x16, beta = 8, nt = 160, U = 4, W = 16,
float32 fused engine, 2 + 3 pairs, ``chip_smoke.py``'s HEADLINE_UNEQ)
through ``run_simulation`` at n_stab = 5 and 2 and two seeds, and at seed
42 once more without unequal-time measurement (the tau sweep draws no
random numbers, so the chain must be the same).  On each run's final
fields it prints, per walker, the float32 tau sweep's largest |dG| from
the float64 one at the same n_stab over every tau, and that over the
walker's own max|G|:
- from the chain's walker states (K1 in every block-end triplet), from a
  float32 rebuild of the fields (K1), and from the same rebuild with
  Householder QR instead of K1;
- at n_stab = 5, seed 42, for two deliberate faults, the readings a wrong
  kernel gives: the triplet fed the previous block's suffix slot, and
  one slice's fields shifted (a kernel that reads the wrong row);
- the df32 headline's tau sweep on ``f32_view`` (1 + 1 pairs).
It also prints the equal-time observables of the float32 G and of a
float64 rebuild of the same fields.  The fields and readings go to an
.npz for the ``jax`` step.

``trace`` runs the headline's chain at seed 42 measured sweep by sweep
(the runs with 1, 2 and 3 measured pairs), at n_stab = 5 and 2, and
prints each measurement's observables from the float32 G and from a
float64 rebuild of the same fields.

``jax-example`` runs the JAX package's float32 examples/repulsive_spin
with phase 17's cut sweep counts at n_stab = 10 and 2 on the CPU.

``jax`` runs the JAX package's float32 and float64 tau sweeps (one walker
at a time, Householder QR in float32 on the CPU) on the walkers of that
.npz that the card read worst, and prints the same readings beside the
port's Householder reading of the same walker.

    python3 scripts/tau_f32_witness.py card [--out chiprun_out/tau_witness.npz]
    python3 scripts/tau_f32_witness.py trace
    JAX_PLATFORMS=cpu python3 scripts/tau_f32_witness.py jax \\
        [--npz chiprun_out/tau_witness.npz] [--walkers 2]
    JAX_PLATFORMS=cpu python3 scripts/tau_f32_witness.py jax-example
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

SETS = ((5, 42), (2, 42), (5, 7), (2, 7))     # (n_stab, seed)
TEXT = "[simulation]\nn_stab = {}\nseed = {}\n"
# --small: a CPU dry run of the card step at 4x4, nt = 20, W = 2
SMALL = ("[Lattice]\nL1 = 4\nL2 = 4\n[simulation]\nbeta = 2.0\nnt = 20\n"
         "[walkers]\nn_walkers = 2\n")


def _say(msg):
    print(f"tau_f32_witness: {msg}", flush=True)


def _states32(torch, params, fields, n_stab, dev):
    """float32 WalkerStates of the fields as a rebuild leaves them."""
    from dqmc_tpu_torch.engine.state import EngineConfig, WalkerState
    from dqmc_tpu_torch.engine.sweep import rebuild_stack_and_greens
    from chip_smoke import make_lattice_of
    from dqmc_tpu_torch.models import AttractiveHubbard
    model = AttractiveHubbard.from_params(params, make_lattice_of(params),
                                          dtype=torch.float32, device=dev)
    cfg = EngineConfig(nt=params.get_int("simulation", "nt"), n_stab=n_stab)
    stack, G, log_det = rebuild_stack_and_greens(model, cfg, fields)
    z = torch.zeros(fields.shape[0], dtype=torch.float32, device=dev)
    return model, cfg, WalkerState(
        fields=fields, G=G, stack=stack, log_det_M=log_det, gens=[],
        acc_sum=z, sign=z + 1.0, err_max=z, err_sum=z, err_count=z)


def _reading(torch, ref, model, cfg, states):
    """(gap_w, gmax_w, self-check_w) of a float32 tau sweep against the
    cached float64 chunks ``ref``."""
    from chip_smoke import tau_gap
    from dqmc_tpu_torch.engine.uneqtime import sweep_unequal_time
    measure, rec = tau_gap(torch, iter(ref))
    _, err = sweep_unequal_time(model, cfg, states, measure_fn=measure)
    assert rec.taus == cfg.nt + 1
    return rec.gap_w.numpy(), rec.gmax_w.numpy(), err.double().cpu().numpy()


def _show(tag, label, r):
    gap, gmax, err = r
    rel = gap / gmax
    w = int(rel.argmax())
    _say(f"{tag} {label}: max |dG| {gap.max():.4e}, max gap/max|G| per "
         f"walker {rel.max():.4e} (walker {w}: {gap[w]:.4e} of "
         f"{gmax[w]:.4e}), median {sorted(rel)[len(rel) // 2]:.4e}, "
         f"self-check max {err.max():.4e}, self-check/max|G| max "
         f"{(err / gmax).max():.4e}")


def _observables(torch, lat, G):
    from dqmc_tpu_torch.measure.manager import MeasurementManager
    m = MeasurementManager(lat, n_walkers=G.shape[0], out_dir=None,
                           device=G.device)
    m.add_defaults()
    return {n: float(v.mean()) for (k, n), v in m.increments(G).items()
            if k == "scalar"}


def card(out: Path, small: bool = False) -> None:
    import numpy as np
    import torch
    from chip_smoke import (HEADLINE_DF32, HEADLINE_UNEQ, f64_states,
                            make_lattice_of)
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.engine import uneqtime
    from dqmc_tpu_torch.engine.df_sweep import f32_view
    from dqmc_tpu_torch.engine.uneqtime import iter_unequal_time
    from dqmc_tpu_torch.ops.linalg import set_f32_orthogonalization
    from dqmc_tpu_torch.run import run_simulation
    dev = "cpu" if small else "cuda"
    if not (small or torch.cuda.is_available()):
        sys.exit("card: needs a CUDA card")
    if not small:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=60)
        _say(smi.stdout.strip())
        _cuda.build()
        _cuda.lib()
    cut = SMALL if small else ""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    saved = {}
    runs = [(n, s, HEADLINE_UNEQ + TEXT.format(n, s) + cut)
            for n, s in SETS]
    runs.append((5, 42, HEADLINE_DF32 + "[simulation]\nisMeasureUnequalTime"
                 " = true\nmeasure_spin = true\nmeasure_charge = true\n"
                 + cut))
    for n_stab, seed, text in runs:
        df = "dtype = df32" in text
        tag = f"{'df32' if df else 'float32'} n_stab={n_stab} seed={seed}"
        params = Parameters.from_string(text)
        sums = {}
        for tau in ((True, False) if seed == 42 and not df else (True,)):
            p = Parameters.from_string(
                text + ("" if tau else "[simulation]\n"
                        "isMeasureUnequalTime = false\n"))
            sums[tau] = s = run_simulation(p, out_dir=None, device=dev,
                                           verbose=False)
            _say(f"{tag} tau={'on' if tau else 'off'}: "
                 + ", ".join(f"{k} {v:.5f}" for k, v in s.observables.items())
                 + f", engine self-check max "
                 f"{float(s.states.err_max.max()):.4e}, err_uneq_max "
                 f"{s.err_uneq_max:.4e}, acceptance {s.acc_rate:.4f}")
        if False in sums:
            a, b = sums[True].states, sums[False].states
            _say(f"{tag}: with and without the tau sweep: fields equal "
                 f"{bool(torch.equal(a.fields, b.fields))}, max |dG| "
                 f"{float((a.G - b.G).abs().max()):.4e}, observables equal "
                 f"{sums[True].observables == sums[False].observables}")
        states = sums[True].states
        fields = states.fields
        model64, cfg64, st64 = f64_states(torch, params, fields, n_stab,
                                          device=dev)
        G64 = st64.G
        lat = make_lattice_of(params)
        G32 = states.G.double()
        _say(f"{tag}: equal-time G of the chain against a float64 rebuild "
             f"of its fields: max |dG| {float((G32 - G64).abs().max()):.4e}"
             f", max|G64| per walker "
             f"{[round(float(x), 2) for x in G64.abs().flatten(1).amax(1)]}")
        _say(f"{tag}: observables of the chain's G "
             f"{_observables(torch, lat, G32)}; of the float64 rebuild "
             f"{_observables(torch, lat, G64)}")
        ref = list(iter_unequal_time(model64, cfg64, st64, tau_chunk=16))
        m32, cfg32, st32 = _states32(torch, params, fields, n_stab, dev)
        view = f32_view(states) if df else states
        readings = {"chain, K1": _reading(torch, ref, m32, cfg32, view),
                    "rebuilt, K1": _reading(torch, ref, m32, cfg32, st32)}
        set_f32_orthogonalization("householder")
        try:
            readings["rebuilt, Householder"] = _reading(torch, ref, m32,
                                                        cfg32, st32)
        finally:
            set_f32_orthogonalization("auto")
        if (n_stab, seed) == (5, 42) and not df:
            get = uneqtime.slot_get
            uneqtime.slot_get = lambda stack, i: get(stack, max(i - 1, 0))
            try:
                readings["fault: previous suffix slot"] = _reading(
                    torch, ref, m32, cfg32, states)
            finally:
                uneqtime.slot_get = get
            f, k = fields.clone(), cfg32.nt // 2 - 3
            f[:, k] = (f[:, k] + 1) % 4         # four-valued HS fields
            readings[f"fault: slice {k}'s fields shifted"] = _reading(
                torch, ref, m32, cfg32, dataclasses.replace(states, fields=f))
        for label, r in readings.items():
            _show(tag, label, r)
            key = f"{'df32_' if df else ''}{n_stab}_{seed}"
            for name, x in zip(("gap", "gmax", "err"), r):
                saved[f"{key}/{label}/{name}"] = x
        if not df:
            saved[f"{n_stab}_{seed}/fields"] = fields.to(torch.int8).cpu()\
                .numpy()
        del ref
    saved["shape"] = np.array([params.get_int("Lattice", "L1"),
                               params.get_float("simulation", "beta"),
                               params.get_int("simulation", "nt")])
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **saved)
    _say(f"wrote {out}")


def trace(small: bool = False) -> None:
    """The headline's float32 chain (seed 42, without unequal-time
    measurement, which leaves the chain as it is) at n_stab = 5 and 2,
    measured sweep by sweep: the run with k = 1, 2, 3 measured pairs ends
    on the state its k-th measurement saw, so each measurement's
    observables from the float32 G are printed beside those of a float64
    rebuild of the same fields, with max|G|."""
    import torch
    from chip_smoke import HEADLINE_UNEQ, f64_states, make_lattice_of
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.config import Parameters
    from dqmc_tpu_torch.run import run_simulation
    dev = "cpu" if small else "cuda"
    if not small:
        _cuda.build()
        _cuda.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    for n_stab in (5, 2):
        for k in (1, 2, 3):
            text = (HEADLINE_UNEQ + TEXT.format(n_stab, 42)
                    + f"isMeasureUnequalTime = false\nn_sweeps = {k}\n"
                    + (SMALL if small else ""))
            params = Parameters.from_string(text)
            s = run_simulation(params, out_dir=None, device=dev,
                               verbose=False)
            G64 = f64_states(torch, params, s.states.fields, n_stab,
                             device=dev)[2].G
            lat = make_lattice_of(params)
            o32 = _observables(torch, lat, s.states.G.double())
            o64 = _observables(torch, lat, G64)
            _say(f"trace n_stab={n_stab} measurement {k}: swave "
                 f"{o32['swave']:.5f} (float64 rebuild {o64['swave']:.5f}),"
                 f" doubleOcc {o32['doubleOcc']:.5f} "
                 f"({o64['doubleOcc']:.5f}), max|G64| "
                 f"{float(G64.abs().max()):.4e}, max |G32 - G64| "
                 f"{float((s.states.G.double() - G64).abs().max()):.4e}; "
                 f"the run's mean over {k}: swave "
                 f"{s.observables['swave']:.5f}, engine self-check max "
                 f"{float(s.states.err_max.max()):.4e}")


def jax_witness(npz: Path, walkers: int) -> None:
    import numpy as np
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from dqmc_tpu.engine.state import EngineConfig, WalkerState
    from dqmc_tpu.engine.sweep import rebuild_stack_and_greens
    from dqmc_tpu.engine.uneqtime import sweep_unequal_time
    from dqmc_tpu.lattice import square_lattice
    from dqmc_tpu.models import AttractiveHubbard
    d = np.load(npz)
    L, beta, nt = d["shape"]
    L, nt = int(L), int(nt)
    models = {dt: AttractiveHubbard.build(square_lattice(L, L), U=4.0,
                                          t=1.0, mu=0.0, beta=float(beta),
                                          nt=nt, dtype=dt)
              for dt in (jnp.float64, jnp.float32)}
    for n_stab, seed in SETS:
        key = f"{n_stab}_{seed}"
        if f"{key}/fields" not in d:
            continue
        fields = d[f"{key}/fields"]
        gap_k1, gmax = d[f"{key}/chain, K1/gap"], d[f"{key}/chain, K1/gmax"]
        hh = d[f"{key}/rebuilt, Householder/gap"]
        cfg = EngineConfig(nt=nt, n_stab=n_stab)
        for w in np.argsort(-gap_k1 / gmax)[:walkers]:
            out = {}
            for dt, m in models.items():
                f = jnp.asarray(fields[w], jnp.int32)
                stack, G, log_det = rebuild_stack_and_greens(m, cfg, f)
                z = jnp.zeros((), G.dtype)
                st = WalkerState(fields=f, G=G, stack=stack,
                                 log_det_M=log_det, key=jax.random.PRNGKey(0),
                                 acc_sum=z, sign=z + 1.0, err_max=z,
                                 err_sum=z, err_count=z)
                ys, err = jax.jit(lambda s, m=m: sweep_unequal_time(m, cfg,
                                                                    s))(st)
                out[dt] = ([np.asarray(x, np.float64) for x in ys],
                           float(err))
                del ys
            ref, _ = out[jnp.float64]
            got, err32 = out[jnp.float32]
            gap = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
            gm = max(float(np.abs(b).max()) for b in ref)
            _say(f"float32 n_stab={n_stab} seed={seed} walker {w}: JAX "
                 f"float32 (Householder) against JAX float64: max |dG| "
                 f"{gap:.4e} of max|G| {gm:.4e} ({gap / gm:.4e}), "
                 f"self-check {err32:.4e}; the port on the card: "
                 f"Householder {hh[w]:.4e} ({hh[w] / gmax[w]:.4e}), K1 "
                 f"{gap_k1[w]:.4e} ({gap_k1[w] / gmax[w]:.4e}), max|G| "
                 f"{gmax[w]:.4e}")


def jax_example(n_stabs) -> None:
    """The JAX package's float32 run of examples/repulsive_spin (6x6,
    beta = 4, nt = 40, tau spin set) with chip_smoke.py's cut sweep counts
    (20 + 2x5 pairs), on the CPU, at each n_stab: its self-check (the tau
    sweep's folded in) and each walker's mean sign per bin."""
    import tempfile
    import h5py
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from chip_smoke import REPULSIVE_SPIN_CUT
    from dqmc_tpu.config import Parameters
    from dqmc_tpu.run import run_simulation
    for n_stab in n_stabs:
        p = Parameters(str(REPO / "examples" / "repulsive_spin" /
                           "parameters.in"))
        for key, val in dict(REPULSIVE_SPIN_CUT, n_stab=n_stab,
                             dtype="float32").items():
            p.set("simulation", key, val)
        with tempfile.TemporaryDirectory() as tmp:
            s = run_simulation(p, out_dir=tmp, verbose=False)
            signs = []
            for w in range(p.get_int("walkers", "n_walkers")):
                with h5py.File(os.path.join(tmp, f"data_{w}.h5"), "r") as f:
                    signs.append([float(np.ravel(f[b]["scalar/sign"])[0])
                                  for b in sorted(f) if b.startswith("bin_")])
        _say(f"JAX float32 examples/repulsive_spin n_stab={n_stab} "
             f"({REPULSIVE_SPIN_CUT}): self-check max "
             f"{s.max_precision_error:.4e} (thermalization "
             f"{s.therm_max_precision_error:.4e}), mean sign per walker "
             f"and bin {signs}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("step", choices=("card", "trace", "jax",
                                     "jax-example"))
    ap.add_argument("--out", "--npz", dest="npz", type=Path,
                    default=REPO / "chiprun_out" / "tau_witness.npz")
    ap.add_argument("--walkers", type=int, default=2)
    ap.add_argument("--small", action="store_true",
                    help="card step on the CPU at 4x4, nt = 20, W = 2")
    o = ap.parse_args()
    if o.step == "card":
        card(o.npz, o.small)
    elif o.step == "trace":
        trace(o.small)
    elif o.step == "jax-example":
        jax_example((10, 2))
    else:
        jax_witness(o.npz, o.walkers)


if __name__ == "__main__":
    main()
