"""dqmc_tpu_torch's parallel tempering (dqmc_tpu_torch/parallel/) held
against the JAX package's (dqmc_tpu/parallel/) on the CPU at 2x2, nt = 8,
four replicas, float64 unless stated.

One test, so that the collected count stays where the full xdist run
survives (ROADMAP "Test-suite constraints").  It holds, in order:

- partner_indices against JAX's for R in (2, 4, 6, 8), attempts 1-4;
- the stacked model, built by the port and carried from JAX's
  stack_models, leaf by leaf against JAX's stacked leaves;
- one stacked per-slice sweep pair (use_pallas: #3's twin with a distinct
  (g, alpha) per walker) on JAX's streams against jax.vmap(sweep_pair)
  over JAX's stacked models: fields and acceptance exactly, G and log|det|
  to 1e-10;
- replica_exchange on the JAX states with JAX's uniforms, in float64 and
  with f64 actions on a float32 chain: S_self and S_cross to 1e-10, the
  same decisions, fields and signs, and G and log-dets to 1e-10 (float64)
  or 1e-6 (the float32 cast of the float64 rebuild);
- replica_exchange_df: df_global_action against JAX's on the same inputs
  to 1e-10, the df actions of rebuilt log-dets within 2e-5 of the float64
  ones (det_power times the 1e-5 at which test_torch_df_engine.py holds
  the df log-det, whose last digits come from a float32 QR's diagonal),
  and its decisions and fields equal to a float64 replica set's on the
  same fields and uniforms;
- the stacked tf32 tier: each replica's G within 1e-9 of max|G| of its own
  float64 rebuild;
- run_parallel_tempering on the CPU (the repulsive model, tau measurement
  and the spool sink): R bin sets, and a run stopped in thermalization
  and again in the measurement, resumed each time, equal to a straight
  one in fields, G, every generator, the exchange generator, attempt and
  accepted, bit for bit, and in its bins;
- the refusals: odd R, checkerboard kinetics, engine = fused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu.engine import EngineConfig, init_state
from dqmc_tpu.engine.df_sweep import df_aux_build, df_global_action
from dqmc_tpu.engine.sweep import rebuild_stack_and_greens
from dqmc_tpu.engine.sweep import sweep_pair as jax_sweep_pair
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard
from dqmc_tpu.parallel import replica_exchange as jax_exchange
from dqmc_tpu.parallel import stack_models as jax_stack
from dqmc_tpu.parallel.tempering import _cast_floats
from dqmc_tpu.parallel.tempering import partner_indices as jax_partners
from dqmc_tpu_torch.config import Parameters
from dqmc_tpu_torch.engine import sweep as tsweep
from dqmc_tpu_torch.engine.df_sweep import df_global_action as t_df_action
from dqmc_tpu_torch.engine.df_sweep import stack_aux
from dqmc_tpu_torch.engine.parity import measurement_greens_fn_stacked
from dqmc_tpu_torch.engine.state import EngineConfig as TEngineConfig
from dqmc_tpu_torch.lattice import square_lattice as t_square_lattice
from dqmc_tpu_torch.models import AttractiveHubbard as TAttractiveHubbard
from dqmc_tpu_torch.ops import tf32
from dqmc_tpu_torch.parallel import tempering as ttemp
from dqmc_tpu_torch.parallel.walkers import PER_BETA, stack_models
from torch_port_util import (  # noqa: F401
    jax_per_slice_streams,
    release_jax_programs,
    to_np,
    torch_df_aux,
    torch_model,
    torch_states)

torch.set_num_threads(1)

BETAS = (2.0, 1.6, 1.3, 1.0)
L, NT, N_STAB, U, MU = 2, 8, 3, 4.0, -0.1     # ragged: blocks 3, 3, 2
R = len(BETAS)


def _jax_models(dtype):
    lat = square_lattice(L, L)
    return jax_stack([AttractiveHubbard.build(lat, U=U, t=1.0, mu=MU, beta=b,
                                              nt=NT, dtype=dtype)
                      for b in BETAS])


def _check_partners():
    for world in (2, 4, 6, 8):
        for attempt in range(1, 5):
            np.testing.assert_array_equal(
                to_np(ttemp.partner_indices(world, attempt)),
                np.asarray(jax_partners(world, attempt)))


def _check_stacked_leaves(jm):
    lat = t_square_lattice(L, L)
    built = stack_models([TAttractiveHubbard.build(lat, U=U, t=1.0, mu=MU,
                                                   beta=b, nt=NT)
                          for b in BETAS])
    carried = torch_model(jm)
    for f in PER_BETA + ("eta", "gamma"):
        want = np.asarray(getattr(jm, f))
        for tm in (built, carried):
            got = to_np(getattr(tm, f))
            if f in ("eta", "gamma"):        # shared, not stacked
                got = np.broadcast_to(got, want.shape)
            np.testing.assert_allclose(got, want, rtol=1e-15, atol=0,
                                       err_msg=f)
    assert built.n_replicas == carried.n_replicas == R
    return carried


def _check_sweep(jm, tm, cfg, tcfg, states):
    fwd, keys = jax_per_slice_streams(states.key, NT, jm.n_sites,
                                      jnp.float64, True)
    bwd, _ = jax_per_slice_streams(keys, NT, jm.n_sites, jnp.float64, False)
    want = jax.jit(jax.vmap(lambda m, s: jax_sweep_pair(m, cfg, s)))(
        jm, states)
    got = tsweep.sweep_pair(tm, tcfg, torch_states(states),
                            streams=(fwd, bwd))
    np.testing.assert_array_equal(to_np(got.fields), np.asarray(want.fields))
    np.testing.assert_allclose(to_np(got.acc_sum), np.asarray(want.acc_sum),
                               atol=1e-12)
    np.testing.assert_allclose(to_np(got.G), np.asarray(want.G), atol=1e-10)
    np.testing.assert_allclose(to_np(got.log_det_M),
                               np.asarray(want.log_det_M), atol=1e-10)
    acc = to_np(got.acc_sum) / 2.0
    assert ((acc > 0.05) & (acc < 0.95)).all()    # every chain moved
    return want


def _jax_actions(jm, cfg, states, attempt, f64_actions=False):
    """JAX's S_self and S_cross, as its replica_exchange computes them."""
    partner = jax_partners(R, attempt)
    fields_p = jnp.take(states.fields, partner, axis=0)
    action = jax.vmap(lambda m, f, ld: m.global_action(f, ld))
    rebuild = jax.vmap(lambda m, f: rebuild_stack_and_greens(m, cfg, f))
    if f64_actions:
        jm = _cast_floats(jm, jnp.float64)
        S_self = action(jm, states.fields, rebuild(jm, states.fields)[2])
    else:
        S_self = action(jm, states.fields, states.log_det_M)
    return S_self, action(jm, fields_p, rebuild(jm, fields_p)[2])


def _check_exchange(jm, tm, cfg, tcfg, js, ts, f64_actions, seen):
    """Two attempts (both pairing parities) in both packages from the same
    states, JAX's uniforms fed to the port."""
    g_tol = 1e-10 if js.G.dtype == jnp.float64 else 1e-6
    for attempt in (1, 2):
        key = jax.random.PRNGKey(40 + attempt)
        u = jax.random.uniform(key, (R,), dtype=jnp.float64)
        S_self, S_cross = _jax_actions(jm, cfg, js, attempt, f64_actions)
        got = ttemp.exchange_actions(tm, tcfg, ts,
                                     ttemp.partner_indices(R, attempt),
                                     f64_actions)
        np.testing.assert_allclose(to_np(got[0]), np.asarray(S_self),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(to_np(got[1]), np.asarray(S_cross),
                                   rtol=0, atol=1e-10)
        js, acc_j = jax_exchange(jm, cfg, js, jnp.asarray(attempt), key,
                                 f64_actions=f64_actions)
        ts, acc_t = ttemp.replica_exchange(tm, tcfg, ts, attempt,
                                           torch.from_numpy(np.array(u)),
                                           f64_actions=f64_actions)
        np.testing.assert_array_equal(to_np(acc_t), np.asarray(acc_j))
        np.testing.assert_array_equal(to_np(ts.fields), np.asarray(js.fields))
        np.testing.assert_array_equal(to_np(ts.sign), np.asarray(js.sign))
        np.testing.assert_allclose(to_np(ts.G), np.asarray(js.G), atol=g_tol)
        np.testing.assert_allclose(to_np(ts.log_det_M),
                                   np.asarray(js.log_det_M), atol=g_tol)
        assert ts.G.dtype == (torch.float64 if g_tol < 1e-8
                              else torch.float32)
        seen.update(bool(a) for a in np.asarray(acc_j))


def _check_exchange_df(tm, tcfg, seen):
    """df32 walkers: df_global_action against JAX's on the same inputs to
    1e-10, the df actions of the partners' rebuilt log-dets within 2e-5
    of the float64 ones, and two attempts of replica_exchange_df with
    JAX's uniforms making the float64 replica set's decisions on the same
    fields (JAX's test_df_exchange_matches_f64_chain_decisions; JAX's
    jitted replica_exchange_df takes ~25 s to compile on the CPU)."""
    from dqmc_tpu_torch.engine.df_sweep import init_state_df, \
        rebuild_stack_df as t_rebuild_df
    from dqmc_tpu_torch.engine.state import WalkerState, make_generators
    lat = square_lattice(L, L)
    auxs = [df_aux_build(lat, U=U, t=1.0, mu=MU, beta=b, nt=NT)
            for b in BETAS]
    jaux = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *auxs)
    taux = stack_aux([torch_df_aux(a) for a in auxs])
    tm32 = stack_models([TAttractiveHubbard.build(
        t_square_lattice(L, L), U=U, t=1.0, mu=MU, beta=b, nt=NT,
        dtype=torch.float32) for b in BETAS])
    ts = init_state_df(tm32, taux, tcfg, make_generators(5, R, "cpu"))
    stack, G, ld = tsweep.rebuild_stack_and_greens(tm, tcfg, ts.fields)
    z = torch.zeros(R, dtype=torch.float64)
    t64 = WalkerState(fields=ts.fields, G=G, stack=stack, log_det_M=ld,
                      gens=[], acc_sum=z, sign=z + 1.0, err_max=z,
                      err_sum=z, err_count=z)
    act = jax.vmap(lambda a, f, ld: df_global_action(a, f, ld))
    for attempt in (1, 2):
        u = torch.from_numpy(np.array(jax.random.uniform(
            jax.random.PRNGKey(60 + attempt), (R,), dtype=jnp.float64)))
        np.testing.assert_allclose(
            to_np(t_df_action(taux, ts.fields, ts.log_det_M)),
            np.asarray(act(jaux, jnp.asarray(to_np(ts.fields)),
                           jnp.asarray(to_np(ts.log_det_M)))),
            rtol=0, atol=1e-10)
        fp = ts.fields[ttemp.partner_indices(R, attempt)]
        _, _, ld64 = tsweep.rebuild_stack_and_greens(tm, tcfg, fp)
        np.testing.assert_allclose(
            to_np(t_df_action(taux, fp, t_rebuild_df(taux, tcfg, fp)[2])),
            to_np(tm.global_action(fp, ld64)), rtol=0, atol=2e-5)
        t64, acc64 = ttemp.replica_exchange(tm, tcfg, t64, attempt, u)
        ts, acc_t = ttemp.replica_exchange_df(taux, tcfg, ts, attempt, u)
        np.testing.assert_array_equal(to_np(acc_t), to_np(acc64))
        np.testing.assert_array_equal(to_np(ts.fields), to_np(t64.fields))
        np.testing.assert_allclose(to_np(ts.G), to_np(t64.G), atol=1e-5)
        seen.update(bool(a) for a in to_np(acc64))


def _check_stacked_tier(tm, tcfg, ts):
    """Each replica's tf32 tier G against its own float64 rebuild."""
    fn = measurement_greens_fn_stacked(tm, tcfg, tf32)
    G = fn(ts)
    _, G64, _ = tsweep.rebuild_stack_and_greens(tm, tcfg, ts.fields)
    scale = G64.abs().amax(dim=(1, 2, 3))
    gap = (G - G64).abs().amax(dim=(1, 2, 3)) / scale
    assert G.shape == (R, 1, L * L, L * L) and (gap < 1e-9).all(), gap


_PT = f"""
[Lattice]
L1 = {L}
L2 = {L}
[hubbard]
model = repulsive
U = {U}
t = 1.0
mu = {MU}
[simulation]
beta = {BETAS[0]}
nt = {NT}
n_therms = 4
n_sweeps = 3
n_bins = 3
n_stab = {N_STAB}
symmetric = true
isMeasureUnequalTime = true
checkpoint_every = 1
seed = 7
[io]
sink = spool
[ParallelTempering]
enabled = true
sweep_steps = 2
betas = {', '.join(map(str, BETAS))}
"""


class _Stop(Exception):
    pass


def _run(path, stop_at=None, text=_PT):
    from dqmc_tpu_torch.run import run_simulation
    real, calls = ttemp.sweep_pair, []

    def counted(*a, **k):
        calls.append(1)
        if len(calls) == stop_at:
            raise _Stop
        return real(*a, **k)
    ttemp.sweep_pair = counted
    try:
        return run_simulation(Parameters.from_string(text), out_dir=str(path),
                              verbose=False, device="cpu")
    except _Stop:
        return None
    finally:
        ttemp.sweep_pair = real


def _check_driver(tmp_path):
    from dqmc_tpu_torch.io.checkpoint import peek_meta
    from dqmc_tpu_torch.io.spool import read_bins
    straight = _run(tmp_path / "straight")
    assert straight.exchange_rate > 0.0 and straight.n_walkers == R
    assert {"density", "sign"} <= set(straight.observables)
    # stopped in thermalization pair 4 (checkpoint after pair 3), resumed
    # and stopped in measured sweep 5 (checkpoint after bin 0, past the
    # attempt before sweep 4), resumed
    assert _run(tmp_path / "resumed", stop_at=4) is None
    assert not peek_meta(tmp_path / "resumed" / "checkpoint.npz")[
        "therm_done"]
    assert _run(tmp_path / "resumed", stop_at=6) is None
    assert peek_meta(tmp_path / "resumed" / "checkpoint.npz")["bin"] == 1
    resumed = _run(tmp_path / "resumed")
    a, b = straight.states, resumed.states
    assert torch.equal(a.fields, b.fields) and torch.equal(a.G, b.G)
    assert torch.equal(a.sign, b.sign)
    assert all(torch.equal(x.get_state(), y.get_state())
               for x, y in zip(a.gens, b.gens))
    ma, mb = (peek_meta(tmp_path / d / "checkpoint.npz")
              for d in ("straight", "resumed"))
    for k in ("bin", "attempt", "accepted", "exchange_gen"):
        assert ma[k] == mb[k], k
    assert ma["attempt"] == 4 and ma["bin"] == 3
    for r in range(R):
        A = read_bins(tmp_path / "straight" / f"data_{r}.spool")
        B = read_bins(tmp_path / "resumed" / f"data_{r}.spool")
        assert sorted(A) == sorted(B) == [0, 1, 2]
        for bn in A:
            for group, vals in A[bn].items():
                for name, x in vals.items():
                    np.testing.assert_allclose(B[bn][group][name], x,
                                               rtol=1e-12, atol=1e-12)


def _check_refusals(tmp_path):
    for extra, err, match in (
            ("[ParallelTempering]\nbetas = 2.0, 1.5, 1.0\n", ValueError,
             "even"),
            ("[hubbard]\ncheckerboard = true\n", NotImplementedError,
             "checkerboard"),
            ("[simulation]\nengine = fused\n", NotImplementedError,
             "ROADMAP")):
        with pytest.raises(err, match=match):
            _run(tmp_path / "refused", text=_PT + extra)


def test_parallel_tempering_matches_jax(tmp_path):
    _check_partners()
    jm = _jax_models(jnp.float64)
    tm = _check_stacked_leaves(jm)
    cfg = EngineConfig(nt=NT, n_stab=N_STAB, use_pallas=True)
    tcfg = TEngineConfig(nt=NT, n_stab=N_STAB, use_pallas=True)
    keys = jax.random.split(jax.random.PRNGKey(3), R)
    states = jax.vmap(lambda m, k: init_state(m, cfg, k))(jm, keys)
    js = _check_sweep(jm, tm, cfg, tcfg, states)
    seen = set()
    _check_exchange(jm, tm, cfg, tcfg, js, torch_states(js), False, seen)
    jm32 = _jax_models(jnp.float32)
    s32 = jax.vmap(lambda m, k: init_state(m, cfg, k))(jm32, keys)
    _check_exchange(jm32, torch_model(jm32), cfg, tcfg, s32,
                    torch_states(s32), True, seen)
    _check_exchange_df(tm, tcfg, seen)
    assert seen == {True, False}       # both outcomes were exercised
    _check_stacked_tier(tm, tcfg, torch_states(js))
    _check_driver(tmp_path)
    _check_refusals(tmp_path)
