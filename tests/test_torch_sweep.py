"""dqmc_tpu_torch's per-slice engine (engine/sweep.py: sweep, sweep_pair)
held against the JAX package's vmapped sweep_pair on the CPU at float64,
for each site update: use_pallas (#3 with a shared order), use_pallas with
submatrix_rank (#5), delay_rank (per-walker order, a rank that does not
divide ns) and the rank-1 scan.  The JAX side runs its Pallas kernels in
interpret mode; the port runs its plain twins.

The port's sweeps consume the streams JAX's sweep splits from each
walker's key, so both packages run the same Markov chain: fields,
acceptance and sign must agree exactly; G and log|det| to 1e-9 (naive
propagation between stabilizations amplifies the reordered rounding of
two implementations, as in test_torch_slice.py).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu.engine import EngineConfig, init_state
from dqmc_tpu.engine.fused import supports_fused as jax_supports_fused
from dqmc_tpu.engine.sweep import sweep as jax_sweep
from dqmc_tpu.engine.sweep import sweep_pair as jax_sweep_pair
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard
from dqmc_tpu_torch.config import Parameters
from dqmc_tpu_torch.engine import sweep as tsweep
from dqmc_tpu_torch.engine.state import EngineConfig as TEngineConfig
from dqmc_tpu_torch.engine.state import make_generators
from dqmc_tpu_torch.models import AttractiveHubbard as TAttractiveHubbard
from dqmc_tpu_torch.run import make_engine_config, use_fused_engine
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
    "pallas_submatrix": dict(use_pallas=True, submatrix_rank=4),
    "delayed": dict(delay_rank=5),
    "scan": dict(),
}


def _setup(seed, U=4.0):
    model = AttractiveHubbard.build(square_lattice(4, 4), U=U, t=1.0,
                                    mu=-0.1, beta=2.0, nt=NT,
                                    dtype=jnp.float64)
    cfg = EngineConfig(nt=NT, n_stab=N_STAB)
    keys = jax.random.split(jax.random.PRNGKey(seed), W)
    states = jax.vmap(lambda k: init_state(model, cfg, k))(keys)
    return model, states


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """One sweep pair in both packages from the same JAX walkers."""
    extra = CONFIGS[request.param]
    model, states = _setup(seed=11)
    cfg = EngineConfig(nt=NT, n_stab=N_STAB, **extra)
    ns = model.n_sites
    fwd, keys = jax_per_slice_streams(states.key, NT, ns, jnp.float64, True)
    bwd, _ = jax_per_slice_streams(keys, NT, ns, jnp.float64, False)
    want = jax.jit(jax.vmap(lambda s: jax_sweep_pair(model, cfg, s)))(states)
    got = tsweep.sweep_pair(torch_model(model),
                            TEngineConfig(nt=NT, n_stab=N_STAB, **extra),
                            torch_states(states), streams=(fwd, bwd))
    return want, got


def _slot_gap(jstack, tstack):
    jm = np.asarray(jstack.L) @ (np.asarray(jstack.d)[..., :, None]
                                 * np.asarray(jstack.R))
    tm = to_np(tstack.L @ (tstack.d[..., :, None] * tstack.R))
    scale = np.abs(jm).max(axis=(-2, -1), keepdims=True)
    return (np.abs(tm - jm) / scale).max()


def test_sweep_pair_matches_jax(pair):
    js, ts = pair
    np.testing.assert_array_equal(to_np(ts.fields), np.asarray(js.fields))
    np.testing.assert_array_equal(to_np(ts.sign), np.asarray(js.sign))
    np.testing.assert_allclose(to_np(ts.acc_sum), np.asarray(js.acc_sum),
                               atol=1e-12)
    np.testing.assert_allclose(to_np(ts.G), np.asarray(js.G), atol=1e-9)
    np.testing.assert_allclose(to_np(ts.log_det_M),
                               np.asarray(js.log_det_M), atol=1e-9)
    assert _slot_gap(js.stack, ts.stack) < 1e-9
    acc = to_np(ts.acc_sum) / 2.0
    assert ((acc > 0.05) & (acc < 0.95)).all()   # the chain moved


def test_sweep_without_update_matches_jax():
    """update=False: propagation and stabilization only, a forward then a
    backward sweep; fields and acceptance stay as they were."""
    model, states = _setup(seed=12)
    cfg = EngineConfig(nt=NT, n_stab=N_STAB)
    fn = jax.jit(jax.vmap(lambda s: jax_sweep(
        model, cfg, jax_sweep(model, cfg, s, forward=True, update=False),
        forward=False, update=False)))
    want = fn(states)
    tm, tcfg = torch_model(model), TEngineConfig(nt=NT, n_stab=N_STAB)
    got = tsweep.sweep(tm, tcfg, torch_states(states), forward=True,
                       update=False)
    got = tsweep.sweep(tm, tcfg, got, forward=False, update=False)
    np.testing.assert_array_equal(to_np(got.fields), np.asarray(states.fields))
    np.testing.assert_array_equal(to_np(got.acc_sum), 0.0)
    np.testing.assert_allclose(to_np(got.G), np.asarray(want.G), atol=1e-9)
    np.testing.assert_allclose(to_np(got.log_det_M),
                               np.asarray(want.log_det_M), atol=1e-9)
    assert _slot_gap(want.stack, got.stack) < 1e-9


@pytest.mark.parametrize("extra", [dict(delay_rank=4),
                                   dict(submatrix_rank=8)])
def test_free_fermion_oracle_per_slice_engine(extra):
    """U = 0: G = (I + e^{-beta K})^{-1} exactly, before and after a sweep
    pair of the per-slice engine (no field couples), and the density is
    2 (1 - tr G / ns)."""
    from dqmc_tpu_torch.measure.context import make_context
    from dqmc_tpu_torch.measure.observables import density
    from dqmc_tpu_torch.models.attractive_hubbard import build_kinetic_matrix
    lat = square_lattice(4, 4)
    beta, nt = 4.0, 12
    model = TAttractiveHubbard.build(lat, U=0.0, t=1.0, mu=-0.3, beta=beta,
                                     nt=nt)
    cfg = TEngineConfig(nt=nt, n_stab=5, **extra)
    states = tsweep.init_state(model, cfg, make_generators(3, 2, "cpu"))
    states = tsweep.sweep_pair(model, cfg, states)
    w, v = np.linalg.eigh(build_kinetic_matrix(lat, 1.0, -0.3))
    G_exact = (v / (1.0 + np.exp(-beta * w))) @ v.T
    np.testing.assert_allclose(to_np(states.G[:, 0]),
                               np.broadcast_to(G_exact, (2, 16, 16)),
                               atol=1e-10)
    got = to_np(density(states.G, make_context(lat)))
    np.testing.assert_allclose(got, 2.0 * (1.0 - np.trace(G_exact) / 16),
                               atol=1e-10)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L", [6, 16, 32])
def test_engine_auto_follows_jax_rule(device, dtype, L):
    """engine = auto takes the fused engine exactly when the JAX driver
    would (supports_fused, an accelerator, float32); the device is only
    named here, nothing runs on it."""
    ns = L * L
    tdt = getattr(torch, dtype)
    for nfl, power, update in ((1, 2, "delayed"), (1, 2, "submatrix"),
                               (2, 1, "delayed"), (2, 1, "submatrix")):
        model = types.SimpleNamespace(n_sites=ns, n_flavor=nfl,
                                      det_power=power, checkerboard=False,
                                      expK=torch.zeros(1, dtype=tdt),
                                      device=torch.device("cpu"))
        want = (jax_supports_fused(model, EngineConfig(
            nt=8, n_stab=4, fused_update=update))
            and device == "cuda" and dtype == "float32")
        params = Parameters.from_string("[simulation]\nengine = auto\n")
        tcfg = TEngineConfig(nt=8, n_stab=4, fused_update=update)
        assert use_fused_engine(params, model, torch.device(device), tdt,
                                tcfg) == want
    for kind, forced in (("fused", True), ("slice", False)):
        params.set("simulation", "engine", kind)
        assert use_fused_engine(params, model, torch.device(device),
                                tdt) is forced


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("site_update,want", [
    ("pallas", dict(use_pallas=True)),
    ("scan", dict()),
    ("delayed", dict(delay_rank=8)),
    ("submatrix", dict(submatrix_rank=8, use_pallas="cuda")),
])
def test_make_engine_config(device, site_update, want):
    params = Parameters.from_string(
        f"[simulation]\nnt = 8\nsite_update = {site_update}\n"
        f"delay_rank = 8\n")
    cfg = make_engine_config(params, torch.device(device), n_stab=4)
    if want.get("use_pallas") == "cuda":
        want = dict(want, use_pallas=device == "cuda")
    assert cfg == TEngineConfig(nt=8, n_stab=4, **want)
    default = make_engine_config(Parameters.from_string(
        "[simulation]\nnt = 8\n"), torch.device(device), n_stab=4)
    assert default.use_pallas == (device == "cuda")


def test_fused_sweep_refuses_the_submatrix_scheme():
    """fused_update = submatrix is single-flavor only (as in the JAX
    package): for the 2-flavor model the fused sweep raises instead of
    running the delayed scheme under its name; for one flavor it runs."""
    from dqmc_tpu_torch.engine.fused import sweep_fused
    from dqmc_tpu_torch.models import RepulsiveHubbard as TRepulsiveHubbard
    kw = dict(U=4.0, t=1.0, mu=0.0, beta=1.0, nt=4)
    cfg = TEngineConfig(nt=4, n_stab=2, fused_update="submatrix")
    model = TRepulsiveHubbard.build(square_lattice(2, 2), **kw)
    states = tsweep.init_state(model, cfg, make_generators(1, 1, "cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sweep_fused(model, cfg, states)
    model = TAttractiveHubbard.build(square_lattice(2, 2), **kw)
    states = tsweep.init_state(model, cfg, make_generators(1, 1, "cpu"))
    assert sweep_fused(model, cfg, states).fields.shape == (1, 4, 4)
