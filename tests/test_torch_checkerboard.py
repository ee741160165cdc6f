"""dqmc_tpu_torch's checkerboard kinetics (models/kinetic.py) against brute
force and the JAX package on the CPU, float64.

On a 4x4 torus the four bond groups commute, so the checkerboard operator
P = e^{dtau mu} G_3 G_2 G_1 G_0 equals the dense expm to ~2e-16 and is
symmetric; the lattice here is 6x2, where the x groups do not commute.
There the JAX package's right products apply P^T instead of P (ROADMAP.md
section 3, "Faults of the reference"), so the port's sweeps are held
against the JAX package's dense engine whose expK is the brute-force P:
that is the JAX package's own engine running the checkerboard chain.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from dqmc_tpu.engine import EngineConfig, init_state
from dqmc_tpu.engine.sweep import sweep_pair as jax_sweep_pair
from dqmc_tpu.engine.uneqtime import sweep_unequal_time as jsweep_uneq
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard
from dqmc_tpu.models import kinetic as jkin
from dqmc_tpu_torch.config import Parameters
from dqmc_tpu_torch.engine import sweep as tsweep
from dqmc_tpu_torch.engine.state import EngineConfig as TEngineConfig
from dqmc_tpu_torch.engine.uneqtime import sweep_unequal_time
from dqmc_tpu_torch.lattice import square_lattice as tsquare_lattice
from dqmc_tpu_torch.models import AttractiveHubbard as TAttractive
from dqmc_tpu_torch.models import RepulsiveHubbard as TRepulsive
from dqmc_tpu_torch.models import kinetic as tkin
from dqmc_tpu_torch.run import run_simulation, use_fused_engine
from torch_port_util import (  # noqa: F401
    jax_per_slice_streams,
    release_jax_programs,
    to_np,
    torch_states)

torch.set_num_threads(1)

BETA, NT, N_STAB, MU, W = 2.0, 8, 3, -0.1, 2


def brute_operator(lat, t, mu, dtau):
    """e^{dtau mu} G_3 G_2 G_1 G_0, each group's exponential by expm of its
    bond matrix (group 0 acts first, as _apply_groups applies them)."""
    perms, masks, _, _ = tkin.build_checkerboard(lat, t, dtau)
    ns = lat.n_sites
    P = np.exp(dtau * mu) * np.eye(ns)
    for g in range(4):
        Kg = np.zeros((ns, ns))
        for i in range(ns):
            j = perms[g][i]
            if masks[g][i] and j > i:
                Kg[i, j] = Kg[j, i] = -t
        P = scipy.linalg.expm(-dtau * Kg) @ P
    return P


def test_checkerboard_matches_brute_force_and_jax():
    rng = np.random.default_rng(5)
    dtau = BETA / NT
    X = rng.standard_normal((W, 1, 16, 16))
    f = rng.integers(0, 4, (W, 16))
    for L1, L2 in ((6, 2), (4, 4)):
        lat = tsquare_lattice(L1, L2)
        tm = TAttractive.build(lat, U=4.0, t=1.0, mu=MU, beta=BETA, nt=NT,
                               checkerboard=True)
        jm = AttractiveHubbard.build(square_lattice(L1, L2), U=4.0, t=1.0,
                                     mu=MU, beta=BETA, nt=NT,
                                     checkerboard=True)
        ns = lat.n_sites
        P = brute_operator(lat, 1.0, MU, dtau)
        sym = np.abs(P - P.T).max()
        assert (sym > 1e-2) if L1 == 6 else (sym < 1e-14)
        eye = torch.eye(ns, dtype=torch.float64)
        # the operator and its inverse against brute force (the JAX
        # package's test_operator_matches_brute_force)
        np.testing.assert_allclose(
            to_np(tkin._kin_left(tm, eye, inv=False)), P, atol=1e-13)
        np.testing.assert_allclose(
            to_np(tkin._kin_left(tm, eye, inv=True)) @ P, np.eye(ns),
            atol=1e-13)
        # the four B products against the dense B of the operator, and
        # against the JAX package's (its left products everywhere, its
        # right ones where P is symmetric; on 6x2 its right products are
        # X B' with B' = diag(V) P^T)
        Xs, fs = X[:, :, :ns, :ns], f[:, :ns]
        ev = to_np(tm.expV_diag(torch.as_tensor(fs)))        # (W, 1, ns)
        B, Bi = ev[..., :, None] * P, np.linalg.inv(P) / ev[..., None, :]
        Bt, Bti = ev[..., :, None] * P.T, np.linalg.inv(P.T) / ev[..., None, :]
        want = dict(apply_B_left=B @ Xs, apply_B_right=Xs @ B,
                    apply_invB_left=Bi @ Xs, apply_invB_right=Xs @ Bi)
        jax_right = dict(apply_B_right=Xs @ Bt, apply_invB_right=Xs @ Bti)
        for name, w in want.items():
            got = to_np(getattr(tkin, name)(tm, torch.as_tensor(fs),
                                            torch.as_tensor(Xs)))
            np.testing.assert_allclose(got, w, atol=1e-12, err_msg=name)
            jgot = np.stack([np.asarray(getattr(jkin, name)(
                jm, jnp.asarray(fs[i]), jnp.asarray(Xs[i])))
                for i in range(W)])
            if L1 == 4 or name not in jax_right:
                np.testing.assert_allclose(got, jgot, atol=1e-12,
                                           err_msg=name)
            else:
                np.testing.assert_allclose(jgot, jax_right[name],
                                           atol=1e-12, err_msg=name)
                assert np.abs(jgot - got).max() > 1e-3
    # the engines that build dense products refuse it (the build's own
    # refusals: test_torch_model.py::test_checkerboard_raises); the fused
    # engine does not take it
    text = ("[Lattice]\nL1 = 6\nL2 = 2\n[hubbard]\nU = 4.0\nt = 1.0\n"
            "mu = -0.1\ncheckerboard = true\n[simulation]\nbeta = 2.0\n"
            "nt = 8\nn_therms = 1\nn_sweeps = 1\nn_bins = 1\nn_stab = 4\n")
    for key, value, match in (("dtype", "df32", "df32 engine"),
                              ("measure_precision", "tf32",
                               "measurement tiers")):
        params = Parameters.from_string(text)
        params.set("simulation", key, value)
        with pytest.raises(NotImplementedError, match=match):
            run_simulation(params, out_dir=None, verbose=False, device="cpu")
    params = Parameters.from_string(text)
    assert not use_fused_engine(params, tm, torch.device("cuda"),
                                torch.float32)
    # the repulsive model inherits the checkerboard build
    rm = TRepulsive.from_params(params, tsquare_lattice(6, 2))
    assert rm.checkerboard and torch.equal(rm.cb_perm, TAttractive.from_params(
        params, tsquare_lattice(6, 2)).cb_perm)

    # one per-slice sweep pair (the #3 path, shared order) and one tau
    # sweep on 6x2, against the JAX package's dense engine with expK = P
    # on the same streams: the test_torch_sweep / test_torch_uneqtime
    # tolerances
    jlat = square_lattice(6, 2)
    dense = AttractiveHubbard.build(jlat, U=4.0, t=1.0, mu=MU, beta=BETA,
                                    nt=NT, dtype=jnp.float64)
    P = brute_operator(tsquare_lattice(6, 2), 1.0, MU, BETA / NT)
    jm = dataclasses.replace(dense, expK=jnp.asarray(P),
                             invexpK=jnp.asarray(np.linalg.inv(P)))
    tm = TAttractive.build(tsquare_lattice(6, 2), U=4.0, t=1.0, mu=MU,
                           beta=BETA, nt=NT, checkerboard=True)
    cfg = EngineConfig(nt=NT, n_stab=N_STAB, use_pallas=True)
    keys = jax.random.split(jax.random.PRNGKey(11), W)
    states = jax.vmap(lambda k: init_state(jm, cfg, k))(keys)
    fwd, keys = jax_per_slice_streams(states.key, NT, 12, jnp.float64, True)
    bwd, _ = jax_per_slice_streams(keys, NT, 12, jnp.float64, False)
    want = jax.jit(jax.vmap(lambda s: jax_sweep_pair(jm, cfg, s)))(states)
    tcfg = TEngineConfig(nt=NT, n_stab=N_STAB, use_pallas=True)
    got = tsweep.sweep_pair(tm, tcfg, torch_states(states),
                            streams=(fwd, bwd))
    np.testing.assert_array_equal(to_np(got.fields), np.asarray(want.fields))
    np.testing.assert_allclose(to_np(got.acc_sum), np.asarray(want.acc_sum),
                               atol=1e-12)
    np.testing.assert_allclose(to_np(got.G), np.asarray(want.G), atol=1e-9)
    np.testing.assert_allclose(to_np(got.log_det_M),
                               np.asarray(want.log_det_M), atol=1e-9)
    assert float(got.err_max.max()) < 1e-9
    acc = to_np(got.acc_sum) / 2.0
    assert ((acc > 0.05) & (acc < 0.95)).all()
    # the rebuild of the port's checkerboard chain from its fields
    stack, G, _ = tsweep.rebuild_stack_and_greens(tm, tcfg, got.fields)
    np.testing.assert_allclose(to_np(G), to_np(got.G), atol=1e-9)
    # the tau sweep with the half-warp (warp is invertible: the raw triplet
    # agrees when the warped one does)
    wt, werr = jax.vmap(lambda s: jsweep_uneq(jm, cfg, s, warp=True))(want)
    tt, terr = sweep_unequal_time(tm, tcfg, torch_states(want), warp=True)
    for name in ("Gtt", "Gt0", "G0t"):
        np.testing.assert_allclose(to_np(getattr(tt, name)),
                                   np.asarray(getattr(wt, name)), atol=1e-9,
                                   err_msg=name)
    np.testing.assert_allclose(to_np(terr), np.asarray(werr), atol=1e-9)
    assert float(terr.max()) < 1e-9
