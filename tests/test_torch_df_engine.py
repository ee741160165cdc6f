"""dqmc_tpu_torch's multiword stabilization chain, df32 engine and
measurement tier (ops/df_linalg.py, engine/df_sweep.py, engine/parity.py,
the run.py keys) held against the JAX package on the CPU.

- to_ldr, mat_mul_ldr and inv_one_plus_ldr_dag on the blocks of a beta=4
  fixed-field chain: factors and G to 1e-12 relative (the
  float32 seed of the refined solve comes from two LAPACKs, and the
  refinement converges to the tier's floor, not to bits);
- rebuild_stack_df and one df_sweep_pair from the same walkers on the
  streams JAX's sweep draws (jax_per_slice_streams), 4x4, nt=8, W=2, one
  and two flavors: identical fields, acceptance and signs, G_df to 1e-10;
- measurement_greens_fn, df32 and tf32, on shared fields: 1e-12;
- run_simulation on the CPU: a float64 run with measure_precision = tf32
  gives the observables of the same-seed engine-precision run to 1e-9 (the
  chain is identical, only the measured G changes), and dtype = df32 runs
  with G_df at the float64 rebuild's grade.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu import hsfield
from dqmc_tpu.engine import EngineConfig
from dqmc_tpu.engine import df_sweep as jds
from dqmc_tpu.engine import parity as jpar
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard, RepulsiveHubbard
from dqmc_tpu.ops import df32 as jdf
from dqmc_tpu.ops import df_linalg as jdl
from dqmc_tpu.ops import tf32 as jtf
from dqmc_tpu_torch.config import Parameters
from dqmc_tpu_torch.engine import df_sweep as tds
from dqmc_tpu_torch.engine import parity as tpar
from dqmc_tpu_torch.engine.state import EngineConfig as TEngineConfig
from dqmc_tpu_torch.ops import df32 as tdf
from dqmc_tpu_torch.ops import df_linalg as tdl
from dqmc_tpu_torch.ops import tf32 as ttf
from torch_port_util import (  # noqa: F401
    computed_once,
    jax_per_slice_streams,
    release_jax_programs,
    to_np,
    torch_df_aux,
    torch_df_states,
    torch_ldr_df,
    torch_model,
    torch_mw)

torch.set_num_threads(1)

NMS = {"df32": (jdf, tdf), "tf32": (jtf, ttf)}
KW = dict(t=1.0, beta=4.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# ----------------------------------------------------------------------
# the LDR chain
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain(request, tmp_path_factory):
    """Both packages' df32 LDR chain over the blocks of one beta=4 field
    configuration (4x4, nt=16, two blocks of 8), from the same multiword
    block products (the tf32 chain is held through the tier below)."""
    nm = "df32"
    jm, tm = NMS[nm]

    def jax_chain():
        model = AttractiveHubbard.build(square_lattice(4, 4), U=4.0,
                                        mu=-0.1, nt=16, dtype=jnp.float64,
                                        **KW)
        fields = np.random.default_rng(2).integers(0, 4, (16, 16))
        expK = jm.from_f64(model.expK)
        blocks = []
        for l0 in (0, 8):
            B = jm.df(jnp.eye(16, dtype=jnp.float32))
            for l in range(l0, l0 + 8):
                B = jm.matmul(jpar._slice_B(model, expK,
                                            jnp.asarray(fields[l]), jm), B)
            blocks.append(jdl.transpose(B))
        j1 = jdl.to_ldr(blocks[1], nm=jm)
        j2 = jdl.mat_mul_ldr(blocks[0], j1, nm=jm)
        eye = jm.df(jnp.eye(16, dtype=jnp.float32))
        jG = jdl.inv_one_plus_ldr_dag(jdl.to_ldr(eye, nm=jm), j2, nm=jm)
        return blocks, j1, j2, jG

    blocks, j1, j2, jG = computed_once(request, tmp_path_factory,
                                       "df_engine_chain", jax_chain)
    tb = [torch_mw(b) for b in blocks]
    t1 = tdl.to_ldr(tb[1], nm=tm)
    t2 = tdl.mat_mul_ldr(tb[0], torch_ldr_df(j1), nm=tm)
    teye = tm.df(torch.eye(16))
    tG = tdl.inv_one_plus_ldr_dag(tdl.to_ldr(teye, nm=tm), t2, nm=tm)
    return nm, (j1, j2, jG), (t1, t2, tG)


def _hold_ldr(nm, jF, tF):
    jm, tm = NMS[nm]
    np.testing.assert_array_equal(np.asarray(jF.e), to_np(tF.e))
    for a, b in ((jF.L, tF.L), (jF.d, tF.d), (jF.R, tF.R)):
        assert _rel(tm.to_f64(b), jm.to_f64(a)) < 1e-12


def test_to_ldr_matches_jax(chain):
    nm, (j1, _, _), (t1, _, _) = chain
    _hold_ldr(nm, j1, t1)


def test_mat_mul_ldr_matches_jax(chain):
    nm, (_, j2, _), (_, t2, _) = chain
    _hold_ldr(nm, j2, t2)


def test_inv_one_plus_ldr_dag_matches_jax(chain):
    nm, (_, _, (jG, jld)), (_, _, (tG, tld)) = chain
    jm, tm = NMS[nm]
    assert _rel(tm.to_f64(tG), jm.to_f64(jG)) < 1e-12
    # log|det| is a first-order-corrected float32-QR quantity: on this
    # chain JAX's reads 2.4e-8 and the port's 6e-9 relative off the exact
    # value (mpmath, 40 digits)
    assert abs(float(tld) - float(jld)) < 1e-7 * abs(float(jld))


# ----------------------------------------------------------------------
# the df32 engine
# ----------------------------------------------------------------------

NT, N_STAB, W = 8, 4, 2


def _jax_df_states(t, keys):
    """JAX df walker states carrying the port's (keys: the chain keys)."""
    j = lambda x: jnp.asarray(to_np(x))  # noqa: E731
    jmw = lambda x: jdf.DF(j(x.hi), j(x.lo))  # noqa: E731
    return jds.DFWalkerState(
        fields=j(t.fields).astype(jnp.int32), G=j(t.G), G_df=jmw(t.G_df),
        stack=jdl.LDRdf(jmw(t.stack.L), jmw(t.stack.d), jmw(t.stack.R),
                        j(t.stack.e)),
        log_det_M=j(t.log_det_M), key=keys, acc_sum=j(t.acc_sum),
        sign=j(t.sign), err_max=j(t.err_max), err_sum=j(t.err_sum),
        err_count=j(t.err_count))


def _walker(states, w):
    return jax.tree.map(lambda x: x[w], states)


def _stacked(states):
    return jax.tree.map(lambda *x: jnp.stack(x), *states)


@pytest.fixture(scope="module", params=[1, 2], ids=["1flavor", "2flavor"])
def engine(request, tmp_path_factory):
    """Walkers from per-walker keys, each package's sweep pair from the
    same state on the streams JAX's sweep draws, and the port's rebuild of
    the initial fields.  One flavor starts from JAX's init_state_df (and
    holds the port's rebuild to it); two flavors draw the same fields
    (hsfield.init_fields on init_state_df's key split) and start both
    packages from the port's rebuild, which is held to the native float64
    rebuild instead (one JAX compile fewer).  JAX runs each walker through
    its own jitted functions and the results are stacked: the same bits as
    a vmap over the walkers in every compared field, traced without the
    batching rules; and the JAX results are computed once per run
    (computed_once), not once per xdist worker that takes one of these
    tests."""
    nfl = request.param
    cls = AttractiveHubbard if nfl == 1 else RepulsiveHubbard
    kw = dict(U=4.0, mu=-0.1 if nfl == 1 else 0.0, t=1.0, beta=2.0, nt=NT)
    lat = square_lattice(4, 4)
    m32 = cls.build(lat, dtype=jnp.float32, **kw)
    aux = jds.df_aux_build(lat, n_flavor=nfl, **kw)
    cfg = EngineConfig(nt=NT, n_stab=N_STAB)
    keys = jax.random.split(jax.random.PRNGKey(3), W)
    taux = tds.df_aux_build(lat, n_flavor=nfl, **kw)
    tcfg = TEngineConfig(nt=NT, n_stab=N_STAB)
    if nfl == 1:
        init = computed_once(request, tmp_path_factory, "df_engine_init",
                             lambda: _stacked([jds.init_state_df(
                                 m32, aux, cfg, k) for k in keys]))
        tinit = torch_df_states(init)
        rebuilt = tds.rebuild_stack_df(taux, tcfg, tinit.fields)
    else:
        split = jax.vmap(jax.random.split)(keys)
        fields = jax.vmap(lambda k: hsfield.init_fields(k, NT, 16))(
            split[:, 0])
        tfields = torch.from_numpy(np.array(fields)).to(torch.int64)
        rebuilt = stack, G_df, log_det = tds.rebuild_stack_df(taux, tcfg,
                                                              tfields)
        z = torch.zeros(W)
        tinit = tds.DFWalkerState(
            fields=tfields, G=G_df.hi, G_df=G_df, stack=stack,
            log_det_M=log_det, gens=[], acc_sum=z, sign=z + 1.0, err_max=z,
            err_sum=z, err_count=z)
        init = _jax_df_states(tinit, split[:, 1])
    fwd, k2 = jax_per_slice_streams(init.key, NT, 16, jnp.float32, True)
    bwd, _ = jax_per_slice_streams(k2, NT, 16, jnp.float32, False)
    want = computed_once(request, tmp_path_factory, f"df_engine_{nfl}",
                         lambda: _stacked([jds.df_sweep_pair(
                             m32, aux, cfg, _walker(init, w))
                             for w in range(W)]))
    got = tds.df_sweep_pair(torch_model(m32), taux, tcfg, tinit,
                            streams=(fwd, bwd))
    return aux, taux, init, rebuilt, want, got


def test_df_aux_matches_jax(engine):
    """The host-side float64 build and its split into pairs: bit for bit."""
    aux, taux = engine[:2]
    for a, b in zip(torch_df_aux(aux), taux):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(to_np(x), to_np(y))


def test_rebuild_stack_df_matches_jax(engine):
    """The df stack, G_df and log|det| of JAX's initial fields: G_df to
    1e-10 (both rebuilds seed their solves with float32 QRs of two
    LAPACKs), every stack slot's scale exponents identical.  Two flavors:
    G_df of both against the native float64 rebuild, 1e-10."""
    _, _, init, (stack, G_df, log_det), _, _ = engine
    if G_df.hi.shape[1] == 2:
        from dqmc_tpu_torch.engine.sweep import rebuild_stack_and_greens
        from dqmc_tpu_torch.models import RepulsiveHubbard as TRepulsive
        m64 = TRepulsive.build(square_lattice(4, 4), U=4.0, mu=0.0, t=1.0,
                               beta=2.0, nt=NT)
        _, G64, ld64 = rebuild_stack_and_greens(
            m64, TEngineConfig(nt=NT, n_stab=N_STAB),
            torch.from_numpy(np.array(init.fields)).to(torch.int64))
        assert _rel(tdf.to_f64(G_df), G64) < 1e-10
        np.testing.assert_allclose(to_np(log_det), to_np(ld64), atol=1e-5)
        return
    assert _rel(tdf.to_f64(G_df), jdf.to_f64(init.G_df)) < 1e-10
    np.testing.assert_array_equal(np.asarray(init.stack.e), to_np(stack.e))
    for a, b in ((init.stack.L, stack.L), (init.stack.R, stack.R)):
        assert _rel(tdf.to_f64(b), jdf.to_f64(a)) < 1e-10
    np.testing.assert_allclose(to_np(log_det), np.asarray(init.log_det_M),
                               atol=1e-5)


def test_df_sweep_pair_matches_jax(engine):
    """Same walkers, same streams: identical fields, acceptance and signs;
    G_df to 1e-10; the float32 working G is G_df's hi word in both."""
    *_, want, got = engine
    np.testing.assert_array_equal(to_np(got.fields), np.asarray(want.fields))
    np.testing.assert_array_equal(to_np(got.acc_sum),
                                  np.asarray(want.acc_sum))
    np.testing.assert_array_equal(to_np(got.sign), np.asarray(want.sign))
    assert _rel(tdf.to_f64(got.G_df), jdf.to_f64(want.G_df)) < 1e-10
    np.testing.assert_array_equal(to_np(got.G), to_np(got.G_df.hi))
    assert np.abs(to_np(got.G) - np.asarray(want.G)).max() < 1e-6
    # the self-check compares float32 propagation of two frameworks with
    # the df rebuild: its count, not its value, is shared
    np.testing.assert_array_equal(to_np(got.err_count),
                                  np.asarray(want.err_count))
    acc = to_np(got.acc_sum) / 2.0
    assert ((acc > 0.05) & (acc < 0.95)).all()           # the chain moved


# ----------------------------------------------------------------------
# the measurement tier
# ----------------------------------------------------------------------

@pytest.mark.parametrize("nm", list(NMS))
def test_measurement_greens_fn_matches_jax(nm):
    """The tier's half-warped G of two walkers' fields (4x4, beta=2, nt=8,
    engine n_stab=4: df32 folds two blocks, tf32 one at its doubled
    stride, each from an identity factor) against JAX's at 1e-12."""
    nt = 8
    jm, tm = NMS[nm]
    model = AttractiveHubbard.build(square_lattice(4, 4), U=4.0, mu=-0.1,
                                    t=1.0, beta=2.0, nt=nt,
                                    dtype=jnp.float64)
    fields = np.random.default_rng(4).integers(0, 4, (2, nt, 16))
    jfn = jpar.measurement_greens_fn(model, EngineConfig(nt=nt, n_stab=4),
                                     jm, symmetric=True)
    want = np.asarray(jfn(type("S", (), {"fields": jnp.asarray(fields)})))
    tfn = tpar.measurement_greens_fn(torch_model(model),
                                     TEngineConfig(nt=nt, n_stab=4), tm,
                                     symmetric=True)
    assert tfn.n_stab == (8 if nm == "tf32" else 4)
    got = to_np(tfn(type("S", (), {"fields": torch.from_numpy(fields)})))
    assert got.shape == want.shape == (2, 1, 16, 16)
    assert _rel(got, want) < 1e-12


# ----------------------------------------------------------------------
# run_simulation
# ----------------------------------------------------------------------

_RUN = """
[Lattice]
L1 = 4
L2 = 4
[hubbard]
U = 4.0
t = 1.0
mu = -0.2
[simulation]
beta = 2.0
nt = 8
n_stab = 4
n_therms = 1
n_bins = 1
n_sweeps = 2
seed = 5
symmetric = true
"""


def test_measurement_tier_changes_only_the_measured_g():
    """A float64 run with measure_precision = tf32 follows the same chain
    as the engine-precision run of the same seed and measures the same
    observables to 1e-9: the float64 engine's G and the tier's agree to
    that grade at this size."""
    from dqmc_tpu_torch.run import run_simulation
    base = Parameters.from_string(_RUN + "dtype = float64\n")
    tier = Parameters.from_string(_RUN + "dtype = float64\n"
                                  "measure_precision = tf32\n")
    a = run_simulation(base, out_dir=None, verbose=False, device="cpu")
    b = run_simulation(tier, out_dir=None, verbose=False, device="cpu")
    np.testing.assert_array_equal(to_np(a.states.fields),
                                  to_np(b.states.fields))
    assert a.observables.keys() == b.observables.keys()
    for k in a.observables:
        assert abs(a.observables[k] - b.observables[k]) < 1e-9, k


def test_df32_run_and_tier_on_cpu():
    """dtype = df32 runs the df engine through run_simulation (with the
    df32 tier measuring): G_df of the final fields matches the float64
    rebuild to 1e-9, and every observable is finite."""
    from dqmc_tpu_torch.engine.sweep import rebuild_stack_and_greens
    from dqmc_tpu_torch.models import AttractiveHubbard as TAttractive
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters.from_string(_RUN + "dtype = df32\n"
                                    "measure_precision = df32\n")
    s = run_simulation(params, out_dir=None, verbose=False, device="cpu")
    assert isinstance(s.states, tds.DFWalkerState)
    m64 = TAttractive.from_params(params, square_lattice(4, 4))
    _, G64, _ = rebuild_stack_and_greens(m64, TEngineConfig(nt=8, n_stab=4),
                                         s.states.fields)
    assert np.abs(to_np(tdf.to_f64(s.states.G_df) - G64)).max() < 1e-9
    assert all(np.isfinite(v) for v in s.observables.values())
    assert 0.0 < s.acc_rate < 1.0


@pytest.mark.parametrize("value", ["float16", "df64"])
def test_unknown_dtype_raises(value):
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters.from_string(_RUN + f"dtype = {value}\n")
    with pytest.raises(ValueError, match="float32, float64 or df32"):
        run_simulation(params, out_dir=None, verbose=False, device="cpu")


def test_unknown_measure_precision_raises():
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters.from_string(_RUN + "measure_precision = f64\n")
    with pytest.raises(ValueError, match="engine, tf32 or df32"):
        run_simulation(params, out_dir=None, verbose=False, device="cpu")
