"""dqmc_tpu_torch's fused sweep, stack rebuild and free-fermion limit, held
against dqmc_tpu on the CPU at float64.

JAX walker states are carried into the port with walker_state_from_numpy,
and the port's sweeps consume the random streams JAX's sweep_fused draws
from the same keys, so both packages run the same Markov chain: the
Metropolis decisions (hence the fields) must agree exactly, G and
log|det| to 1e-9 (naive propagation between stabilizations amplifies the
reordered rounding of two implementations), the rebuild to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu.engine import EngineConfig, init_state
from dqmc_tpu.engine.fused import sweep_pair_fused
from dqmc_tpu.engine.sweep import rebuild_stack_and_greens
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard, RepulsiveHubbard
from dqmc_tpu_torch.engine import fused as tfused
from dqmc_tpu_torch.engine import sweep as tsweep
from dqmc_tpu_torch.engine.state import EngineConfig as TEngineConfig
from dqmc_tpu_torch.engine.state import make_generators
from dqmc_tpu_torch.models import AttractiveHubbard as TAttractiveHubbard
from torch_port_util import (  # noqa: F401
    jax_sweep_streams,
    release_jax_programs,
    to_np,
    torch_model,
    torch_states)

torch.set_num_threads(1)


def _setup(W=2, L=4, beta=4.0, nt=12, n_stab=3, seed=0, U=4.0,
           repulsive_mu=None, **cfg_kw):
    """``repulsive_mu``: None for the attractive model, else the repulsive
    model's chemical potential."""
    lat = square_lattice(L, L)
    if repulsive_mu is None:
        model = AttractiveHubbard.build(lat, U=U, t=1.0, mu=-0.1, beta=beta,
                                        nt=nt, dtype=jnp.float64)
    else:
        model = RepulsiveHubbard.build(lat, U=U, t=1.0, mu=repulsive_mu,
                                       beta=beta, nt=nt, dtype=jnp.float64)
    cfg = EngineConfig(nt=nt, n_stab=n_stab, **cfg_kw)
    keys = jax.random.split(jax.random.PRNGKey(seed), W)
    states = jax.vmap(lambda k: init_state(model, cfg, k))(keys)
    return model, cfg, states


def _run_both(nt, n_stab, seed, n_pairs=2, **kw):
    """n_pairs fused sweep pairs in both packages from one JAX state."""
    model, cfg, states = _setup(nt=nt, n_stab=n_stab, seed=seed, **kw)
    tmodel = torch_model(model)
    tcfg = TEngineConfig(nt=nt, n_stab=n_stab, fused_update=cfg.fused_update,
                         submatrix_rank=cfg.submatrix_rank)
    tstates = torch_states(states)
    keys = states.key
    out = []
    for _ in range(n_pairs):
        fwd, keys = jax_sweep_streams(keys, nt, model.n_sites, jnp.float64)
        bwd, keys = jax_sweep_streams(keys, nt, model.n_sites, jnp.float64)
        states = sweep_pair_fused(model, cfg, states, interpret=True)
        tstates = tfused.sweep_pair_fused(tmodel, tcfg, tstates,
                                          streams=(fwd, bwd))
        out.append((states, tstates))
    return out


@pytest.fixture(scope="module")
def pairs():
    return _run_both(nt=12, n_stab=3, seed=0)


@pytest.fixture(scope="module")
def ragged_pairs():
    return _run_both(nt=10, n_stab=3, seed=4, n_pairs=1)


def _slot_gap(jstack, tstack):
    """Largest per-slot relative gap of the stack's slot products
    L diag(d) R, an invariant of the factorization (the factors themselves
    may differ by the QR's sign conventions)."""
    jm = np.asarray(jstack.L) @ (np.asarray(jstack.d)[..., :, None]
                                 * np.asarray(jstack.R))
    tm = to_np(tstack.L @ (tstack.d[..., :, None] * tstack.R))
    scale = np.abs(jm).max(axis=(-2, -1), keepdims=True)
    return (np.abs(tm - jm) / scale).max()


def _assert_same_chain(js, ts):
    np.testing.assert_array_equal(to_np(ts.fields), np.asarray(js.fields))
    np.testing.assert_allclose(to_np(ts.G), np.asarray(js.G), atol=1e-9)
    np.testing.assert_allclose(to_np(ts.log_det_M),
                               np.asarray(js.log_det_M), atol=1e-9)
    np.testing.assert_allclose(to_np(ts.acc_sum), np.asarray(js.acc_sum),
                               atol=1e-12)


@pytest.mark.parametrize("pair", [0, 1])
def test_sweep_pair_fused_matches_jax(pairs, pair):
    _assert_same_chain(*pairs[pair])


def test_sweep_pair_fused_stack_matches_jax(pairs):
    js, ts = pairs[-1]
    assert _slot_gap(js.stack, ts.stack) < 1e-9
    # the self-check error is rounding noise of the naive propagation (4e-8
    # here), different in two implementations: both stay at that level
    assert float(np.max(np.asarray(js.err_max))) < 1e-6
    assert float(ts.err_max.max()) < 1e-6


def test_sweep_fused_ragged_matches_jax(ragged_pairs):
    """nt % n_stab != 0: the short tail block runs last forward, first
    backward, in both packages."""
    _assert_same_chain(*ragged_pairs[0])


@pytest.mark.parametrize("mu,seed", [(0.0, 1), (-0.6, 2)])
def test_sweep_pair_fused_two_flavors_matches_jax(mu, seed):
    """The 2-flavor fused sweep (ragged: nt = 10, n_stab = 3) follows the
    JAX package's chain: fields and signs identical, both flavors' G to
    1e-9; half filling keeps every sign at +1."""
    (js, ts), = _run_both(nt=10, n_stab=3, seed=seed, n_pairs=1,
                          repulsive_mu=mu, beta=3.0)
    _assert_same_chain(js, ts)
    np.testing.assert_array_equal(to_np(ts.sign), np.asarray(js.sign))
    assert _slot_gap(js.stack, ts.stack) < 1e-9
    assert tuple(ts.G.shape) == (2, 2, 16, 16)
    if mu == 0.0:
        assert (to_np(ts.sign) == 1.0).all()


@pytest.mark.parametrize("rank", [0, 8])
def test_sweep_pair_fused_submatrix_matches_jax(rank):
    """fused_update = submatrix at the default rank (32 -> 16 at ns = 16)
    and at submatrix_rank = 8."""
    (js, ts), = _run_both(nt=12, n_stab=3, seed=3, n_pairs=1,
                          fused_update="submatrix", submatrix_rank=rank)
    _assert_same_chain(js, ts)
    assert _slot_gap(js.stack, ts.stack) < 1e-9


def test_rebuild_stack_and_greens_matches_jax():
    model, cfg, states = _setup(nt=10, n_stab=3, seed=6)
    fields = np.array(states.fields)
    stack, G, log_det = jax.vmap(
        lambda f: rebuild_stack_and_greens(model, cfg, f))(
            jnp.asarray(fields))
    tstack, tG, tlog = tsweep.rebuild_stack_and_greens(
        torch_model(model), TEngineConfig(nt=10, n_stab=3),
        torch.as_tensor(fields))
    np.testing.assert_allclose(to_np(tG), np.asarray(G), atol=1e-12)
    np.testing.assert_allclose(to_np(tlog), np.asarray(log_det), atol=1e-12)
    assert tstack.L.shape == stack.L.shape
    assert _slot_gap(stack, tstack) < 1e-12


def test_slot_get_set_round_trip(pairs):
    _, ts = pairs[0]
    before = ts.stack.L[..., 1, :, :].clone()
    F = tsweep.slot_get(ts.stack, 2)
    stack = tsweep.slot_set(ts.stack, 1, F)
    for a, b in zip(tsweep.slot_get(stack, 1), F):
        assert torch.equal(a, b)
    for a, b in zip(tsweep.slot_get(stack, 3), tsweep.slot_get(ts.stack, 3)):
        assert torch.equal(a, b)
    assert torch.equal(ts.stack.L[..., 1, :, :], before)  # input not written


def test_free_fermion_oracle():
    """U = 0: G = (I + e^{-beta K})^{-1} exactly, before and after a sweep
    pair (no field couples), and the density is 2 (1 - tr G / ns)."""
    lat = square_lattice(4, 4)
    beta, nt = 4.0, 12
    model = TAttractiveHubbard.build(lat, U=0.0, t=1.0, mu=-0.3, beta=beta,
                                     nt=nt)
    cfg = TEngineConfig(nt=nt, n_stab=4)
    states = tsweep.init_state(model, cfg, make_generators(3, 2, "cpu"))
    from dqmc_tpu_torch.models.attractive_hubbard import build_kinetic_matrix
    K = build_kinetic_matrix(lat, 1.0, -0.3)
    w, v = np.linalg.eigh(K)
    G_exact = (v / (1.0 + np.exp(-beta * w))) @ v.T
    np.testing.assert_allclose(to_np(states.G[:, 0]),
                               np.broadcast_to(G_exact, (2, 16, 16)),
                               atol=1e-10)
    states = tfused.sweep_pair_fused(model, cfg, states)
    np.testing.assert_allclose(to_np(states.G[:, 0]),
                               np.broadcast_to(G_exact, (2, 16, 16)),
                               atol=1e-10)
    dens = 2.0 * (1.0 - np.trace(G_exact) / 16)
    from dqmc_tpu_torch.measure.context import make_context
    from dqmc_tpu_torch.measure.observables import density
    got = to_np(density(states.G, make_context(lat)))
    np.testing.assert_allclose(got, dens, atol=1e-10)


def test_sweep_draws_streams_from_generators():
    """Without explicit streams the sweep draws them from the walker
    generators: reproducible from the seed, and the chain stays sane."""
    lat = square_lattice(4, 4)
    model = TAttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1, beta=2.0,
                                     nt=8)
    cfg = TEngineConfig(nt=8, n_stab=4)
    runs = []
    for _ in range(2):
        s = tsweep.init_state(model, cfg, make_generators(7, 2, "cpu"))
        for _ in range(2):
            s = tfused.sweep_pair_fused(model, cfg, s)
        runs.append(s)
    np.testing.assert_array_equal(to_np(runs[0].fields),
                                  to_np(runs[1].fields))
    # naive-propagation drift at dtau = 0.25 over 4 slices, f64 (the JAX
    # fused test bounds the same quantity by 1e-6 at dtau = 0.2, n_stab = 5)
    assert float(runs[0].err_max.max()) < 1e-6
    acc = to_np(runs[0].acc_sum) / 4.0
    assert ((acc > 0.1) & (acc < 0.95)).all()
