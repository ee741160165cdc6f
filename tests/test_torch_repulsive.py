"""dqmc_tpu_torch's repulsive (2-flavor, sign-tracking) Hubbard model and
its per-slice sweeps, held against dqmc_tpu on the CPU at float64.

The model's matrices and update math agree to 1e-14 (the same scipy expm in
host f64); the rebuilt stack and G to 1e-10.  The per-slice sweep pair
consumes the streams JAX's sweep splits from each walker's key, so both
packages run the same Markov chain: fields and signs must agree exactly, G
and log|det| to 1e-10 at half filling and to 1e-9 doped, for the scan,
delayed and submatrix schemes (plain torch ops, as the JAX package runs
them outside any Pallas kernel) and for the ``use_pallas`` dispatch (the
twin of kernel #4 against the JAX 2-flavor Pallas kernel in interpret
mode).  At mu = 0 the model is sign-free; doped (U = 6, mu = -0.8) a sign
flip must be seen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu import hsfield as jhs
from dqmc_tpu.engine import EngineConfig, init_state
from dqmc_tpu.engine.sweep import rebuild_stack_and_greens
from dqmc_tpu.engine.sweep import sweep_pair as jax_sweep_pair
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import RepulsiveHubbard
from dqmc_tpu_torch.engine import sweep as tsweep
from dqmc_tpu_torch.engine.state import EngineConfig as TEngineConfig
from dqmc_tpu_torch.engine.state import make_generators
from dqmc_tpu_torch.models import MODEL_REGISTRY
from dqmc_tpu_torch.models import RepulsiveHubbard as TRepulsiveHubbard
from torch_port_util import (  # noqa: F401
    jax_per_slice_streams,
    release_jax_programs,
    to_np,
    torch_model,
    torch_states)

torch.set_num_threads(1)

NT, N_STAB, W = 8, 3, 3          # ragged: blocks of 3, 3 and 2 slices
CONFIGS = {
    "pallas": dict(use_pallas=True),
    "delayed": dict(delay_rank=5),
    "submatrix": dict(submatrix_rank=8),
    "scan": dict(),
}
FILLINGS = {"half": dict(U=4.0, mu=0.0, beta=2.0, seed=11, pairs=1),
            "doped": dict(U=6.0, mu=-0.8, beta=4.0, seed=8, pairs=1)}


def _model(U=4.0, mu=0.0, beta=2.0, nt=NT):
    return RepulsiveHubbard.build(square_lattice(4, 4), U=U, t=1.0, mu=mu,
                                  beta=beta, nt=nt, dtype=jnp.float64)


def test_registry_and_structure():
    assert set(MODEL_REGISTRY) == {"attractive", "repulsive"}
    assert MODEL_REGISTRY["repulsive"] is TRepulsiveHubbard
    tm = TRepulsiveHubbard.build(square_lattice(4, 4), U=4.0, t=1.0, mu=0.0,
                                 beta=2.0, nt=8)
    assert (tm.n_flavor, tm.det_power, float(tm.alpha)) == (2, 1, 0.0)
    assert isinstance(torch_model(_model()), TRepulsiveHubbard)


def test_model_matrices_match_jax():
    jm = _model(U=6.0, mu=-0.8)
    tm = TRepulsiveHubbard.build(square_lattice(4, 4), U=6.0, t=1.0, mu=-0.8,
                                 beta=2.0, nt=NT)
    for name in ("expK", "invexpK", "expK_half", "invexpK_half", "g",
                 "alpha", "eta", "gamma", "beta"):
        np.testing.assert_allclose(to_np(getattr(tm, name)),
                                   np.asarray(getattr(jm, name)),
                                   rtol=1e-14, atol=1e-14, err_msg=name)
    assert (tm.n_sites, tm.nt, tm.n_flavor, tm.det_power) == \
        (jm.n_sites, jm.nt, jm.n_flavor, jm.det_power)


def test_update_math_matches_jax(rng):
    jm = _model(U=6.0, mu=-0.8)
    tm = torch_model(jm)
    fields = rng.integers(0, 4, (3, 16))
    want = jax.vmap(jm.expV_diag)(jnp.asarray(fields))
    np.testing.assert_allclose(to_np(tm.expV_diag(torch.as_tensor(fields))),
                               np.asarray(want), rtol=1e-14)
    old = rng.integers(0, 4, 32)
    new = np.asarray(jhs.PROPOSAL)[old, rng.integers(0, 3, 32)]
    jf = jax.vmap(jm.update_factors)(jnp.asarray(old), jnp.asarray(new))
    tf = tm.update_factors(torch.as_tensor(old), torch.as_tensor(new))
    for a, b in zip(jf, tf):
        np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=1e-14)
    G_ii = rng.random((32, 2))
    jr = jax.vmap(jm.det_ratio)(jnp.asarray(G_ii), jf[2])
    tr = tm.det_ratio(torch.as_tensor(G_ii), tf[2])
    np.testing.assert_allclose(to_np(tr), np.asarray(jr), rtol=1e-14)
    fields = rng.integers(0, 4, (NT, 16))
    log_det = rng.standard_normal(2)
    np.testing.assert_allclose(
        float(tm.global_action(torch.as_tensor(fields),
                               torch.as_tensor(log_det))),
        float(jm.global_action(jnp.asarray(fields), jnp.asarray(log_det))),
        rtol=1e-14)


def _walkers(model, seed):
    cfg = EngineConfig(nt=NT, n_stab=N_STAB)
    keys = jax.random.split(jax.random.PRNGKey(seed), W)
    return jax.vmap(lambda k: init_state(model, cfg, k))(keys)


def _slot_gap(jstack, tstack):
    jm = np.asarray(jstack.L) @ (np.asarray(jstack.d)[..., :, None]
                                 * np.asarray(jstack.R))
    tm = to_np(tstack.L @ (tstack.d[..., :, None] * tstack.R))
    scale = np.abs(jm).max(axis=(-2, -1), keepdims=True)
    return (np.abs(tm - jm) / scale).max()


def test_rebuild_stack_and_greens_matches_jax():
    model = _model(U=6.0, mu=-0.8)
    cfg = EngineConfig(nt=NT, n_stab=N_STAB)
    fields = np.array(_walkers(model, 6).fields)
    stack, G, log_det = jax.vmap(
        lambda f: rebuild_stack_and_greens(model, cfg, f))(
            jnp.asarray(fields))
    tstack, tG, tlog = tsweep.rebuild_stack_and_greens(
        torch_model(model), TEngineConfig(nt=NT, n_stab=N_STAB),
        torch.as_tensor(fields))
    assert tuple(tG.shape) == (W, 2, 16, 16) == G.shape
    assert tstack.L.shape == stack.L.shape
    np.testing.assert_allclose(to_np(tG), np.asarray(G), atol=1e-10)
    np.testing.assert_allclose(to_np(tlog), np.asarray(log_det), atol=1e-10)
    assert _slot_gap(stack, tstack) < 1e-10


def test_init_state_two_flavors():
    tm = TRepulsiveHubbard.build(square_lattice(4, 4), U=4.0, t=1.0, mu=0.0,
                                 beta=2.0, nt=NT)
    s = tsweep.init_state(tm, TEngineConfig(nt=NT, n_stab=N_STAB),
                          make_generators(3, 2, "cpu"))
    assert tuple(s.G.shape) == (2, 2, 16, 16)
    assert tuple(s.stack.d.shape) == (2, 2, 5, 16)
    assert tuple(s.log_det_M.shape) == (2, 2)
    assert torch.equal(s.sign, torch.ones(2, dtype=torch.float64))
    assert not torch.allclose(s.G[:, 0], s.G[:, 1])   # opposite couplings


@pytest.fixture(scope="module", params=[
    (f, c) for f in FILLINGS for c in CONFIGS],
    ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """Sweep pairs in both packages from the same JAX walkers."""
    filling, config = request.param
    kw = dict(FILLINGS[filling])
    seed, n_pairs = kw.pop("seed"), kw.pop("pairs")
    extra = CONFIGS[config]
    model = _model(**kw)
    states = _walkers(model, seed)
    cfg = EngineConfig(nt=NT, n_stab=N_STAB, **extra)
    tcfg = TEngineConfig(nt=NT, n_stab=N_STAB, **extra)
    tmodel, tstates = torch_model(model), torch_states(states)
    step = jax.jit(jax.vmap(lambda s: jax_sweep_pair(model, cfg, s)))
    for _ in range(n_pairs):
        ns = model.n_sites
        fwd, keys = jax_per_slice_streams(states.key, NT, ns, jnp.float64,
                                          True)
        bwd, _ = jax_per_slice_streams(keys, NT, ns, jnp.float64, False)
        states = step(states)
        tstates = tsweep.sweep_pair(tmodel, tcfg, tstates,
                                    streams=(fwd, bwd))
    return filling, states, tstates


def test_sweep_pair_matches_jax(pair):
    filling, js, ts = pair
    tol = 1e-10 if filling == "half" else 1e-9
    np.testing.assert_array_equal(to_np(ts.fields), np.asarray(js.fields))
    np.testing.assert_array_equal(to_np(ts.sign), np.asarray(js.sign))
    np.testing.assert_allclose(to_np(ts.acc_sum), np.asarray(js.acc_sum),
                               atol=1e-12)
    np.testing.assert_allclose(to_np(ts.G), np.asarray(js.G), atol=tol)
    np.testing.assert_allclose(to_np(ts.log_det_M),
                               np.asarray(js.log_det_M), atol=tol)
    assert _slot_gap(js.stack, ts.stack) < tol


def test_sweep_pair_sign(pair):
    """Half filling is sign-free; the doped walkers see a flip."""
    filling, js, ts = pair
    sign = to_np(ts.sign)
    assert set(np.unique(sign)) <= {-1.0, 1.0}
    if filling == "half":
        assert (sign == 1.0).all()
    else:
        assert (sign == -1.0).any(), "no sign flip in the doped chain: reseed"


def test_site_update_fn_refuses_other_models():
    import dataclasses
    tm = dataclasses.replace(torch_model(_model()), det_power=2)
    with pytest.raises(NotImplementedError, match="det_power"):
        tsweep.site_update_fn(tm, TEngineConfig(nt=NT, n_stab=N_STAB))
