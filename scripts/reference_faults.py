#!/usr/bin/env python3
"""The faults of the JAX package (the port's reference) that the port's
checkpoint/resume, spool sink and checkerboard kinetics do not copy,
measured on the CPU with the JAX package itself.

    python3 scripts/reference_faults.py checkerboard   # ~1 minute
    python3 scripts/reference_faults.py bins           # ~1 minute
    python3 scripts/reference_faults.py tempering      # ~2 minutes
    python3 scripts/reference_faults.py distributed    # ~1 minute

``checkerboard`` (6x6, beta = 2, nt = 16, n_stab = 4, U = 4, mu = -0.1,
float64 unless named; on a 4x4 torus the four bond groups commute and
hide every one of these):

1. ``models/kinetic.py``'s right products apply P^T where B = diag(V) P:
   its apply_B_right against X diag(V) P and X diag(V) P^T;
2. what that does to a chain: the per-slice engine's self-check after two
   sweep pairs with the checkerboard model, the dense model, and the dense
   engine fed the checkerboard operator (expK = P), then the tau sweep's;
3. the multiword tiers rebuild G from the dense expK: the tf32 / df32 G of
   a checkerboard chain's fields against that chain's float64 G;
4. the df32 engine's block products come from the dense expK
   (df_aux_build): its self-check with float32 wraps through P, against
   df32 products built from P;
5. the repulsive model ignores ``checkerboard = true``.

``bins`` kills a run (SIGKILL, in a subprocess) in a bin's ingest and
resumes it with the same parameters (4x4, 4 bins): the spool sink with
checkpoint_every = 1 killed in the 3rd bin, and the h5 sink with
checkpoint_every = 2 killed in the 4th; it prints the bins each file
holds after the kill and after the resume.

``tempering`` runs the JAX package's parallel-tempering driver (2x2,
nt = 8, four betas, float64, 4 bins of 3 sweeps, an attempt every 2
sweeps, checkpoint_every = 1) straight, and again stopped after bin 1 and
resumed, recording every checkpoint's metadata and every exchange
attempt's key: where the resumed run's attempts draw their coins, how
many attempts each run makes, whether any checkpoint is taken during the
thermalization, and whether the resumed chain ends where the straight one
does.

``distributed`` runs the JAX package's driver in two processes on the
CPU (jax.distributed over 127.0.0.1, [distributed] num_processes = 2,
n_walkers = 8, 4x4, 2 bins, both processes writing into one directory):
each process's exit code and last error line, and the bin files in the
directory, against the 8 files data_0 .. data_7 a run of 8 walkers owns
(run.py:343-349 hands the manager the global n_walkers with a
per-process rank_offset; run.py:582 fetches accumulators that span the
other process's devices).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

L, BETA, NT, N_STAB, U, MU = 6, 2.0, 16, 4, 4.0, -0.1


def _jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def operator(lat, t, mu, dtau):
    """The dense checkerboard operator e^{dtau mu} G_3 G_2 G_1 G_0 (each
    group's exponential by scipy's expm; group 0 acts first)."""
    import numpy as np
    import scipy.linalg
    from dqmc_tpu.models.kinetic import build_checkerboard
    perms, masks, _, _ = build_checkerboard(lat, t, dtau)
    ns = lat.n_sites
    P = np.exp(dtau * mu) * np.eye(ns)
    for g in range(4):
        Kg = np.zeros((ns, ns))
        for i in range(ns):
            j = int(perms[g][i])
            if masks[g][i] and j > i:
                Kg[i, j] = Kg[j, i] = -t
        P = scipy.linalg.expm(-dtau * Kg) @ P
    return P


def checkerboard() -> None:
    jax = _jax()
    import jax.numpy as jnp
    import numpy as np
    from dqmc_tpu.config import Parameters
    from dqmc_tpu.engine import EngineConfig, init_state, sweep_pair
    from dqmc_tpu.engine.df_sweep import (_aux_from_np, df_aux_build,
                                          df_sweep_pair, init_state_df)
    from dqmc_tpu.engine.parity import measurement_greens_fn
    from dqmc_tpu.engine.uneqtime import sweep_unequal_time
    from dqmc_tpu.lattice import square_lattice
    from dqmc_tpu.models import AttractiveHubbard, RepulsiveHubbard
    from dqmc_tpu.models import kinetic
    from dqmc_tpu.ops import df32, tf32
    dtau = BETA / NT
    lat = square_lattice(L, L)
    P = operator(lat, 1.0, MU, dtau)
    Pi = np.linalg.inv(P)
    build = dict(U=U, t=1.0, mu=MU, beta=BETA, nt=NT)
    cb = AttractiveHubbard.build(lat, checkerboard=True, **build)
    dense = AttractiveHubbard.build(lat, **build)
    withP = dataclasses.replace(dense, expK=jnp.asarray(P),
                                invexpK=jnp.asarray(Pi))
    say = lambda m: print(f"reference_faults checkerboard: {m}", flush=True)
    say(f"{L}x{L}: max|P - P^T| {np.abs(P - P.T).max():.3e}, max|P - "
        f"expm(-dtau K)| {np.abs(P - np.asarray(dense.expK)).max():.3e}")
    # 1. the right products
    rng = np.random.default_rng(0)
    X = rng.standard_normal((1, L * L, L * L))
    f = rng.integers(0, 4, L * L)
    ev = np.asarray(cb.expV_diag(jnp.asarray(f)))[0]
    right = np.asarray(kinetic.apply_B_right(cb, jnp.asarray(f),
                                             jnp.asarray(X)))[0]
    left = np.asarray(kinetic.apply_B_left(cb, jnp.asarray(f),
                                           jnp.asarray(X)))[0]
    say(f"1. apply_B_right against X diag(V) P: "
        f"{np.abs(right - X[0] * ev @ P).max():.3e}; against X diag(V) "
        f"P^T: {np.abs(right - X[0] * ev @ P.T).max():.3e}; apply_B_left "
        f"against diag(V) P X: "
        f"{np.abs(left - ev[:, None] * (P @ X[0])).max():.3e}")
    # 2. the chain's self-check, then the tau sweep's
    cfg = EngineConfig(nt=NT, n_stab=N_STAB)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    chains = {}
    for name, m in (("checkerboard model", cb), ("dense model", dense),
                    ("dense engine with expK = P", withP)):
        st = jax.vmap(lambda k: init_state(m, cfg, k))(keys)
        for _ in range(2):
            st = jax.vmap(lambda s: sweep_pair(m, cfg, s))(st)
        _, err = jax.vmap(lambda s: sweep_unequal_time(m, cfg, s))(st)
        chains[name] = st
        say(f"2. {name}: float64 self-check after 2 pairs "
            f"{float(jnp.max(st.err_max)):.3e}, tau sweep self-check "
            f"{float(jnp.max(err)):.3e}")
    # 3. the tiers on the checkerboard chain's fields
    st = chains["dense engine with expK = P"]
    for nm in (tf32, df32):
        for name, m in (("checkerboard model", cb),
                        ("dense engine with expK = P", withP)):
            G = measurement_greens_fn(m, cfg, nm)(st)
            say(f"3. {nm.__name__.rsplit('.', 1)[-1]} tier of the {name} "
                f"on the checkerboard chain's fields: max|G_tier - G| "
                f"{float(jnp.max(jnp.abs(G - st.G))):.3e}")
    # 4. the df32 engine's products
    m32 = AttractiveHubbard.build(lat, dtype=jnp.float32, **build)
    m32P = dataclasses.replace(m32, expK=jnp.asarray(P, jnp.float32),
                               invexpK=jnp.asarray(Pi, jnp.float32))
    g64 = float(np.sqrt(0.5 * U * dtau))
    for name, aux in (("the dense expK (df_aux_build)",
                       df_aux_build(lat, **build)),
                      ("P", _aux_from_np(P, g64))):
        s = jax.vmap(lambda k: init_state_df(m32P, aux, cfg, k))(keys)
        for _ in range(3):
            s = jax.vmap(lambda x: df_sweep_pair(m32P, aux, cfg, x))(s)
        say(f"4. df32 engine, float32 wraps through P, df32 products from "
            f"{name}: self-check over 3 pairs "
            f"{float(jnp.max(s.err_max)):.3e}")
    # 5. the repulsive model and the key
    p = Parameters.from_string(
        f"[Lattice]\nL1 = {L}\nL2 = {L}\n[hubbard]\nmodel = repulsive\n"
        f"U = {U}\nt = 1.0\nmu = 0.0\ncheckerboard = true\n[simulation]\n"
        f"beta = {BETA}\nnt = {NT}\n")
    m = RepulsiveHubbard.from_params(p, lat)
    dense0 = AttractiveHubbard.build(lat, U=U, t=1.0, mu=0.0, beta=BETA,
                                     nt=NT)
    same = np.allclose(np.asarray(m.expK), np.asarray(dense0.expK))
    say(f"5. RepulsiveHubbard.from_params with checkerboard = true: "
        f"checkerboard attribute {getattr(m, 'checkerboard', None)!r}, "
        f"expK is the dense expm: {bool(same)}")


STAGE = r'''
import os, signal, sys
sys.path.insert(0, sys.argv[4])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from dqmc_tpu.config import Parameters
from dqmc_tpu.measure import manager as mm
from dqmc_tpu.run import run_simulation
kill = int(sys.argv[2])
if kill:
    real, calls = mm.MeasurementManager.ingest_bin, []
    def ingest(self, *a, **k):
        calls.append(1)
        if len(calls) == kill:
            os.kill(os.getpid(), signal.SIGKILL)
        return real(self, *a, **k)
    mm.MeasurementManager.ingest_bin = ingest
run_simulation(Parameters.from_string(open(sys.argv[1]).read()),
               out_dir=sys.argv[3], verbose=False)
'''

BINS_PARAMS = """
[Lattice]
L1 = 4
L2 = 4
[hubbard]
U = 4.0
t = 1.0
mu = -0.1
[simulation]
beta = 2.0
nt = 8
n_therms = 2
n_sweeps = 1
n_bins = 4
n_stab = 2
seed = 21
dtype = float64
checkpoint_every = {every}
[io]
sink = {sink}
"""


def bins() -> None:
    import h5py
    from dqmc_tpu.io.checkpoint import peek_meta
    from dqmc_tpu.io.spool import read_spool

    def run(d, every, sink, kill):
        cfg, stage = d / "parameters.in", d / "stage.py"
        cfg.write_text(BINS_PARAMS.format(every=every, sink=sink))
        stage.write_text(STAGE)
        r = subprocess.run([sys.executable, str(stage), str(cfg), str(kill),
                            str(d / "results"), str(REPO)],
                           capture_output=True, text=True)
        last = [l for l in r.stderr.splitlines() if "Error" in l][-1:]
        return r.returncode, last

    def state(d):
        res = d / "results"
        out = {"files": sorted(os.listdir(res))}
        if (res / "data_0.h5").exists():
            with h5py.File(res / "data_0.h5") as f:
                out["h5 bins"] = sorted(int(k[4:]) for k in f
                                        if k.startswith("bin_"))
        if (res / "data_0.spool").exists():
            out["spool bytes"] = os.path.getsize(res / "data_0.spool")
            try:
                out["spool bins"] = sorted({b for _, b, _ in
                                            read_spool(res / "data_0.spool")})
            except ValueError as e:
                out["spool bins"] = f"unreadable ({e})"
        if (res / "checkpoint.npz").exists():
            out["checkpoint at bin"] = peek_meta(res / "checkpoint.npz")["bin"]
        return out

    for title, every, sink, kill in (
            ("spool sink, checkpoint_every = 1, killed in the 3rd bin", 1,
             "spool", 3),
            ("h5 sink, checkpoint_every = 2, killed in the 4th bin", 2, "h5",
             4)):
        with tempfile.TemporaryDirectory() as tmp:
            d = Path(tmp)
            rc = run(d, every, sink, kill)
            print(f"reference_faults bins: {title}: exit {rc[0]}; after the "
                  f"kill {state(d)}", flush=True)
            rc = run(d, every, sink, 0)
            print(f"reference_faults bins:   resumed with the same "
                  f"parameters: exit {rc[0]} {rc[1]}; after {state(d)}",
                  flush=True)


PT_PARAMS = """
[Lattice]
L1 = 2
L2 = 2
[hubbard]
U = 4.0
t = 1.0
mu = -0.1
[simulation]
beta = 2.0
nt = 8
n_therms = 6
n_sweeps = 3
n_bins = {n_bins}
n_stab = 4
seed = 5
checkpoint_every = 1
dtype = float64
[ParallelTempering]
enabled = true
sweep_steps = 2
betas = 2.0, 1.6, 1.3, 1.0
"""


def tempering() -> None:
    jax = _jax()
    import numpy as np
    from dqmc_tpu.config import Parameters
    from dqmc_tpu.io import checkpoint as ck
    from dqmc_tpu.parallel import tempering as pt
    saves, keys = [], []
    real_save, real_ex = ck.save_checkpoint, pt.replica_exchange

    def save(path, states, meta):
        saves.append(dict(meta))
        return real_save(path, states, meta)

    def exchange(models, cfg, states, attempt, key, **kw):
        keys.append((int(attempt), tuple(np.asarray(
            jax.random.key_data(key) if hasattr(jax.random, "key_data")
            else key).tolist())))
        return real_ex(models, cfg, states, attempt, key, **kw)

    def run(d, n_bins):
        saves.clear()
        keys.clear()
        s = pt.run_parallel_tempering(
            Parameters.from_string(PT_PARAMS.format(n_bins=n_bins)),
            out_dir=str(d), verbose=False)
        path = os.path.join(d, "checkpoint.npz")
        with np.load(path) as z:
            leaves = {k: z[k] for k in z.files if k != "__meta__"}
        return s, list(saves), list(keys), ck.peek_meta(path), leaves

    ck.save_checkpoint, pt.replica_exchange = save, exchange
    try:
        with tempfile.TemporaryDirectory() as tmp:
            straight = run(os.path.join(tmp, "a"), 4)
            first = run(os.path.join(tmp, "b"), 1)
            resumed = run(os.path.join(tmp, "b"), 4)
    finally:
        ck.save_checkpoint, pt.replica_exchange = real_save, real_ex
    (sa, a_saves, a_keys, a_meta, a_leaves) = straight
    print(f"reference_faults tempering: straight run: checkpoints "
          f"{[(m['bin'], m['therm_done']) for m in a_saves]} (bin, "
          f"therm_done) -- the first after all 6 thermalization pairs; "
          f"attempts {[k[0] for k in a_keys]}, final attempt "
          f"{a_meta['attempt']}, accepted {a_meta['accepted']}", flush=True)
    print(f"reference_faults tempering: stopped after bin 1: attempts "
          f"{[k[0] for k in first[2]]}; resumed to 4 bins: attempts "
          f"{[k[0] for k in resumed[2]]}, final attempt "
          f"{resumed[3]['attempt']}, accepted {resumed[3]['accepted']}",
          flush=True)
    redrawn = [k for k in resumed[2] if k[1] in {x[1] for x in a_keys[:2]}]
    print(f"reference_faults tempering: the resumed run's first attempt "
          f"({resumed[2][0][0]}) draws the key of the straight run's attempt "
          f"{[x[0] for x in a_keys if x[1] == resumed[2][0][1]]} "
          f"(redrawn coins: {len(redrawn)})", flush=True)
    same = sum(np.array_equal(v, resumed[4][k]) for k, v in a_leaves.items())
    print(f"reference_faults tempering: the final checkpoints' state "
          f"leaves equal in {same} of {len(a_leaves)}; exchange rate "
          f"straight {sa.exchange_rate:.4f}, stopped and resumed "
          f"{resumed[0].exchange_rate:.4f}", flush=True)


DIST = r'''
import sys
sys.path.insert(0, sys.argv[3])
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
from dqmc_tpu.config import Parameters
from dqmc_tpu.run import run_simulation
params = Parameters.from_string(open(sys.argv[1]).read())
params.set("distributed", "process_id", sys.argv[2])
run_simulation(params, out_dir=sys.argv[4], verbose=False)
'''


def distributed() -> None:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    text = BINS_PARAMS.format(every=0, sink="h5").replace(
        "n_bins = 4", "n_bins = 2") + (
        f"[walkers]\nn_walkers = 8\n[distributed]\nnum_processes = 2\n"
        f"coordinator_address = 127.0.0.1:{port}\n")
    with tempfile.TemporaryDirectory() as tmp:
        pfile = Path(tmp) / "parameters.in"
        pfile.write_text(text)
        out = Path(tmp) / "results"
        procs = [subprocess.Popen(
            [sys.executable, "-c", DIST, str(pfile), str(r), str(REPO),
             str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(2)]
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                _, err = p.communicate()
            last = [x for x in err.strip().splitlines() if x.strip()]
            where = [x.strip() for x in last if "dqmc_tpu/" in x
                     and x.strip().startswith("File")]
            print(f"reference_faults distributed: process {r} exit code "
                  f"{p.returncode}, last error line: "
                  f"{last[-1] if last else '(none)'}; raised under "
                  f"{where[-1] if where else '(no frame of dqmc_tpu)'}",
                  flush=True)
        files = sorted(f.name for f in out.glob("data_*")) \
            if out.exists() else []
        print(f"reference_faults distributed: bin files {files} (a run of "
              f"8 walkers owns data_0 .. data_7)", flush=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else ""
    if mode not in ("checkerboard", "bins", "tempering", "distributed"):
        sys.exit(__doc__)
    {"checkerboard": checkerboard, "bins": bins, "tempering": tempering,
     "distributed": distributed}[mode]()
