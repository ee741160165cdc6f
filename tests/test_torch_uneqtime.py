"""dqmc_tpu_torch's tau-resolved measurement against dqmc_tpu on the CPU.

On inputs made from a numpy seed at 4x4 with nt <= 16:
- ``ops/linalg.inv_triplet_dag``: float64 to 1e-12; float32 (K1's plain
  twin in cgs2 mode) to float32 rounding;
- ``engine/uneqtime.sweep_unequal_time`` after a backward rebuild: the
  float64 triplet at every tau and the self-check, to 1e-12, for a
  divisible and a ragged nt, with the half-warp off and on; the chunks of
  ``iter_unequal_time`` equal the full sweep;
- the six tau observables and their displacement reduction, one and two
  flavors, against the JAX manager's ``uneq_measure_fn`` (1e-12);
- the multiword tau tier (``engine/parity.measurement_uneq_fn``, df32 and
  tf32 with ``emit_greens``) against the JAX package's float64 tau sweep
  on the same fields, within the tier grade (1e-7, 1e-9);
- a repulsive run with the tau sets through ``run_simulation``: the JAX
  package's ``unequaltime/`` layout, read by ``python -m
  dqmc_tpu.analysis``; df32-engine and tf32-tier runs write the same
  names.
"""

import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import torch

from dqmc_tpu.config import Parameters
from dqmc_tpu.engine.state import EngineConfig as JConfig
from dqmc_tpu.engine.sweep import rebuild_stack_and_greens as jrebuild
from dqmc_tpu.engine.uneqtime import sweep_unequal_time as jsweep_uneq
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard, RepulsiveHubbard
from dqmc_tpu.ops import linalg as jlin
from dqmc_tpu_torch.engine.state import EngineConfig
from dqmc_tpu_torch.engine.uneqtime import (iter_unequal_time,
                                            sweep_unequal_time)
from dqmc_tpu_torch.ops import linalg as tlin
from torch_port_util import (  # noqa: F401
    release_jax_programs,
    shared_dir,
    to_np,
    torch_model,
    torch_states)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(seed, W, nt, ns):
    return np.random.default_rng(seed).integers(0, 4, (W, nt, ns))


def _states(model, nt, n_stab, fields):
    """JAX walker states holding what a backward rebuild of the fields
    (W, nt, ns) leaves (suffix stack, G(0, 0)), and the port's twin."""
    from dqmc_tpu.engine.state import WalkerState as JState
    cfg = JConfig(nt=nt, n_stab=n_stab)

    def one(f):
        stack, G, log_det = jrebuild(model, cfg, f)
        z = jnp.zeros((), G.dtype)
        return JState(fields=f, G=G, stack=stack, log_det_M=log_det,
                      key=jax.random.PRNGKey(0), acc_sum=z, sign=z + 1.0,
                      err_max=z, err_sum=z, err_count=z)

    js = jax.vmap(one)(jnp.asarray(fields, jnp.int32))
    return cfg, js, torch_states(js)


def test_inv_triplet_dag_matches_jax():
    """The shared-factorization triplet of a prefix B(tau, 0) (normal
    form) and a suffix B(beta, tau) (transpose form) folded from the
    model's propagators: float64 against JAX to 1e-12 (the two separate
    inverses too), float32 through K1's twin in cgs2 mode against the JAX
    float64 triplet to float32 rounding."""
    nt, n_stab, tau = 16, 4, 8
    model = AttractiveHubbard.build(square_lattice(4, 4), U=4.0, t=1.0,
                                    mu=-0.1, beta=4.0, nt=nt,
                                    dtype=jnp.float64)
    fields = _fields(3, 1, nt, 16)[0]
    Bs = [np.asarray(model.B_of(jnp.asarray(f))[0]) for f in fields]

    def fold(mats):
        F = jlin.identity_ldr(16)
        for i in range(0, len(mats), n_stab):
            P = np.eye(16)
            for B in mats[i:i + n_stab]:
                P = B @ P
            F = jlin.mat_mul_ldr(jnp.asarray(P), F)
        return F

    F1 = fold(Bs[:tau])
    F2t = fold([B.T for B in Bs[tau:][::-1]])
    want = jlin.inv_triplet_dag(F1, F2t)
    as_t = lambda F, dt: tlin.LDR(*(torch.as_tensor(np.array(x), dtype=dt)
                                    for x in F))   # noqa: E731
    got = tlin.inv_triplet_dag(as_t(F1, torch.float64),
                               as_t(F2t, torch.float64))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-12,
                                   rtol=1e-12)
    np.testing.assert_allclose(
        to_np(tlin.inv_invldr_plus_ldr_dag(as_t(F1, torch.float64),
                                           as_t(F2t, torch.float64))),
        np.asarray(jlin.inv_invldr_plus_ldr_dag(F1, F2t)), atol=1e-12)
    tlin.set_f32_orthogonalization("cgs2")
    try:
        got32 = tlin.inv_triplet_dag(as_t(F1, torch.float32),
                                     as_t(F2t, torch.float32))
    finally:
        tlin.set_f32_orthogonalization("auto")
    for g, w in zip(got32[:3], want[:3]):
        w = np.asarray(w)
        assert np.abs(to_np(g) - w).max() < 1e-4 * max(1.0, np.abs(w).max())
    assert abs(float(got32[3]) - float(want[3])) < 1e-3 * abs(float(want[3]))


def test_sweep_unequal_time_matches_jax():
    """The float64 triplet at every tau and the per-walker self-check
    after a backward rebuild, against the JAX package's sweep on the same
    stack (1e-12): nt = 12 at n_stab = 4 without the half-warp, and the
    ragged nt = 10 at n_stab = 4 with it, for the attractive model (one
    flavor) and the repulsive one (two flavors).  The chunks of
    iter_unequal_time concatenate to the full sweep exactly.  U = 2 at
    beta = 2 keeps the naive propagation inside a block at ~1e-13 on
    random fields, so the two packages' summation orders stay below
    1e-12 (at U = 4, beta = 3 both chains' self-checks read ~5e-8 and
    they part at ~6e-10)."""
    lat = square_lattice(4, 4)
    for cls, nt, n_stab, warp in ((AttractiveHubbard, 12, 4, False),
                                  (AttractiveHubbard, 10, 4, True),
                                  (RepulsiveHubbard, 12, 4, False),
                                  (RepulsiveHubbard, 10, 4, True)):
        model = cls.build(lat, U=2.0, t=1.0, mu=-0.1, beta=2.0, nt=nt,
                          dtype=jnp.float64)
        nfl = model.n_flavor
        jcfg, js, states = _states(model, nt, n_stab,
                                   _fields(nt, 2, nt, 16))
        want, werr = jax.vmap(
            lambda s: jsweep_uneq(model, jcfg, s, warp=warp))(js)
        tm = torch_model(model)
        cfg = EngineConfig(nt=nt, n_stab=n_stab)
        got, err = sweep_unequal_time(tm, cfg, states, warp=warp)
        for f in ("Gtt", "Gt0", "G0t"):
            g, w = to_np(getattr(got, f)), np.asarray(getattr(want, f))
            assert g.shape == w.shape == (2, nt + 1, nfl, 16, 16)
            d = np.abs(g - w).max(axis=(0, 2, 3, 4))
            assert d.max() < 1e-12, f"{f}: tau {d.argmax()}: {d.max():.3e}"
        np.testing.assert_allclose(to_np(err), np.asarray(werr), atol=1e-12)
        assert float(err.max()) < 1e-8
        chunks = list(iter_unequal_time(tm, cfg, states, tau_chunk=3,
                                        warp=warp))
        assert [s for s, _ in chunks] == list(range(0, nt, 3))
        for i, f in enumerate(("Gtt", "Gt0", "G0t")):
            cat = torch.cat([c[i] for _, c in chunks], dim=1)
            assert torch.equal(cat, getattr(got, f))


def _bin_values(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_uneq_observables_match_jax(tmp_path):
    """The six tau observables, raw and through the manager's emit (one
    site_to_r_all reduction per block of taus), for one and two flavors,
    against the JAX package's observables and uneq_measure_fn per walker
    and tau (1e-12); currxxTau in float32 (index gathers) against JAX's
    float32 form (one-hot matmuls) to float32 rounding.  Two measurements
    (sign-weighted with two flavors) accumulated into one bin by each
    manager write the same values: scalars, equaltime/, unequaltime/ in
    the (a no + b) T + t layout and their binK_ transforms (1e-12), and
    the same err_uneq_max."""
    from dqmc_tpu.measure import observables as jobs
    from dqmc_tpu.measure.context import make_context as jctx
    from dqmc_tpu.measure.manager import MeasurementManager as JManager
    from dqmc_tpu_torch.measure import observables as tobs
    from dqmc_tpu_torch.measure.manager import MeasurementManager as TManager
    lat = square_lattice(4, 4)
    rng = np.random.default_rng(7)
    jc = jctx(lat, jnp.float64)
    names = ("green_tau", "doublon_tau", "spinzz_tau", "spinxx_tau",
             "density_tau", "currxx_tau")
    for nfl in (1, 2):
        W, k, ns = 2, 3, 16
        trip = [0.5 * np.eye(ns) + 0.2 * rng.standard_normal(
            (W, k, nfl, ns, ns)) for _ in range(3)]
        G00 = 0.5 * np.eye(ns) + 0.2 * rng.standard_normal((W, 1, nfl, ns,
                                                            ns))
        jin = [jnp.asarray(x) for x in trip] + [jnp.asarray(G00[:, 0])]
        tin = [torch.as_tensor(x) for x in trip] + [torch.as_tensor(G00)]
        per_wt = lambda f: jax.vmap(jax.vmap(  # noqa: E731
            f, in_axes=(0, 0, 0, None)))
        jm = JManager(lat, n_walkers=W, out_dir=None, dtype=jnp.float64,
                      measure_unequal=True)
        tm = TManager(lat, n_walkers=W, out_dir=None, measure_unequal=True)
        for m in (jm, tm):
            m.add_defaults()
            m.add_spin()
            m.add_charge()
        for name in names:
            want = per_wt(lambda a, b, c, d: getattr(jobs, name)(
                a, b, c, d, jc))(*jin)
            got = getattr(tobs, name)(*tin, tm.ctx)
            np.testing.assert_allclose(to_np(got), np.asarray(want),
                                       atol=1e-12, err_msg=name)
        want = per_wt(jm.uneq_measure_fn)(*jin)
        got = tm.uneq_measure_fn(*tin)
        assert set(got) == set(want) == {
            "greenTau", "doublonTau", "currxxTau", "spinzzTau",
            "spinxxTau", "densityTau"}
        for name in want:
            assert got[name].shape == (W, k, 4, 4, 1)
            np.testing.assert_allclose(to_np(got[name]),
                                       np.asarray(want[name]), atol=1e-12,
                                       err_msg=name)
        jc32 = jctx(lat, jnp.float32)
        want = np.asarray(per_wt(lambda a, b, c, d: jobs.currxx_tau(
            a, b, c, d, jc32))(*(x.astype(jnp.float32) for x in jin)))
        got = to_np(tobs.currxx_tau(*(x.float() for x in tin), tm.ctx))
        assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()
        _hold_bins(tmp_path / f"nfl{nfl}", rng, jin, tin, nfl == 2)


def _hold_bins(root, rng, jin, tin, signed):
    """One bin of two measurements through each manager: the JAX manager's
    fused accumulator (make_measured_iter) and the port's increments /
    accumulate / ingest_bin, written and read back.  On a 2x4 honeycomb
    (16 sites, two orbitals), so the (a n_orb + b) T + t flattening is
    held."""
    from collections import namedtuple
    from dqmc_tpu.lattice import honeycomb_lattice
    from dqmc_tpu.measure.manager import MeasurementManager as JManager
    from dqmc_tpu_torch.measure.manager import MeasurementManager as TManager
    W = tin[0].shape[0]
    lat = honeycomb_lattice(2, 4)
    St = namedtuple("St", "G sign")
    signs = [np.array([1.0, -1.0]), np.array([-1.0, -1.0])]
    errs = [np.array([2e-9, 7e-9]), np.array([5e-9, 1e-9])]
    # the second measurement: the first's Green's functions, shuffled and
    # perturbed
    ins = [(jin, tin)]
    more = [np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
            for x in jin]
    ins.append(([jnp.asarray(x) for x in more],
                [torch.as_tensor(x) for x in more[:3]]
                + [torch.as_tensor(more[3][:, None])]))
    dirs = {k: root / k for k in ("jax", "port")}
    for d in dirs.values():
        d.mkdir(parents=True)
    jm = JManager(lat, n_walkers=W, out_dir=str(dirs["jax"]),
                  dtype=jnp.float64, measure_unequal=True)
    tm = TManager(lat, n_walkers=W, out_dir=str(dirs["port"]),
                  measure_unequal=True)
    for m in (jm, tm):
        m.add_defaults()
        m.add_spin()
        m.add_charge()
    cur = {}
    per_wt = jax.vmap(jax.vmap(jm.uneq_measure_fn, in_axes=(0, 0, 0, None)))
    iter_fn, zero_acc = jm.make_measured_iter(
        lambda s: s, lambda s: cur["uneq"], signed=signed)
    jacc = tacc = None
    for (j, t), sg, err in zip(ins, signs, errs):
        sg = sg if signed else np.ones(W)
        st = St(G=j[3], sign=jnp.asarray(sg))
        cur["uneq"] = (per_wt(*j), jnp.asarray(err))
        jacc = zero_acc(st) if jacc is None else jacc
        _, jacc = iter_fn(st, jacc)
        tacc = {} if tacc is None else tacc
        tm.accumulate(tacc, tm.increments(
            t[3][:, 0], torch.as_tensor(sg) if signed else None,
            uneq=(tm.uneq_measure_fn(*t), torch.as_tensor(err))))
    assert jm.ingest_bin(jacc, 2) == tm.ingest_bin(tacc, 2) == 7e-9
    jm.close()
    tm.close()
    for w in range(W):
        want = _bin_values(dirs["jax"] / f"data_{w}.h5")
        got = _bin_values(dirs["port"] / f"data_{w}.h5")
        assert set(got) == set(want)
        assert ("bin_0/scalar/sign" in got) == signed
        assert any(n.startswith("binK_0/unequaltime/") for n in got)
        assert got["bin_0/unequaltime/greenTau"].shape == (2, 4, 4 * 3)
        for name, v in want.items():
            np.testing.assert_allclose(got[name], v, atol=1e-12,
                                       rtol=1e-12, err_msg=name)


def test_uneq_tier_matches_f64():
    """The port's tau tier (measurement_uneq_fn with emit_greens, the
    half-warp on) against the JAX package's float64 tau sweep at n_stab = 1
    on the same fields, at every tau: df32 at its default stride (the
    0.4 / dtau cap: 2 of the engine's 4, eight blocks in two triplet
    chunks) within 1e-7, tf32 at the engine's stride within 1e-9, one and
    two flavors; the emitted G is the warped G00 and the self-check stays
    at the tier's grade."""
    from dqmc_tpu.engine.sweep import half_warp
    from dqmc_tpu_torch.engine.parity import measurement_uneq_fn
    from dqmc_tpu_torch.engine.uneqtime import TauGreens
    from dqmc_tpu_torch.ops import df32, tf32
    lat = square_lattice(4, 4)
    nt = 16
    raw = lambda a, b, c, g00: TauGreens(a, b, c)  # noqa: E731
    for cls, tiers in ((AttractiveHubbard, ((df32, 1e-7, 2), (tf32, 1e-9, 4))),
                       (RepulsiveHubbard, ((tf32, 1e-9, 4),))):
        model = cls.build(lat, U=4.0, t=1.0, mu=-0.1, beta=2.0, nt=nt,
                          dtype=jnp.float64)
        jcfg, js, states = _states(model, nt, 1, _fields(5, 2, nt, 16))
        want, _ = jax.vmap(
            lambda s: jsweep_uneq(model, jcfg, s, warp=True))(js)
        G00w = np.asarray(jax.vmap(lambda G: half_warp(model, G))(js.G))
        for nm, tol, stride in tiers:
            fn = measurement_uneq_fn(torch_model(model),
                                     EngineConfig(nt=nt, n_stab=4), nm, raw,
                                     symmetric=True, emit_greens=True)
            assert fn.n_stab == stride
            ys, err, G = fn(states)
            for f in ("Gtt", "Gt0", "G0t"):
                d = np.abs(to_np(getattr(ys, f))
                           - np.asarray(getattr(want, f))).max(
                               axis=(0, 2, 3, 4))
                assert d.shape == (nt + 1,)
                assert d.max() < tol, f"{nm.__name__} {f}: tau " \
                    f"{d.argmax()}: {d.max():.3e}"
            assert np.abs(to_np(G) - G00w).max() < tol
            assert float(err.max()) < tol


_RUN = """
[Lattice]
L1 = 4
L2 = 4
[hubbard]
model = repulsive
U = 4.0
t = 1.0
mu = -0.3
[simulation]
beta = 2.0
nt = 8
n_therms = 1
n_sweeps = 1
n_bins = 2
n_stab = 4
symmetric = true
isMeasureUnequalTime = true
measure_spin = true
measure_charge = true
seed = 5
dtype = float64
[walkers]
n_walkers = 2
"""


def _layout(path):
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            out[name] = ((obj.shape, str(obj.dtype))
                         if isinstance(obj, h5py.Dataset) else "group")
        f.visititems(visit)
    return out


def test_cli_uneq_layout_matches_jax(request, tmp_path_factory, tmp_path):
    """A repulsive run with isMeasureUnequalTime, measure_spin and
    measure_charge through run_simulation writes the JAX package's bins:
    the same groups, datasets, shapes and dtypes, unequaltime/ and
    K/unequaltime/ included, which python -m dqmc_tpu.analysis reads.  A
    df32-engine run and a float32 run with the tf32 tau tier (one sweep
    each) write the same layout."""
    from dqmc_tpu_torch.config import Parameters as TParameters
    from dqmc_tpu_torch.run import run_simulation as trun

    def make(root):
        from dqmc_tpu.run import run_simulation
        run_simulation(Parameters.from_string(_RUN),
                       out_dir=str(root / "results"), verbose=False)

    jdir = shared_dir(request, tmp_path_factory, "uneq_jax_run", make)
    want = [_layout(jdir / f"results/data_{w}.h5") for w in range(2)]
    names = {n for n in want[0] if "unequaltime/" in n}
    assert {n.rsplit("/", 1)[1] for n in names} == {
        "greenTau", "doublonTau", "currxxTau", "spinzzTau", "spinxxTau",
        "densityTau"}
    # (L1, L2, n_orb^2 (nt + 1))
    assert want[0]["bin_0/unequaltime/currxxTau"][0] == (4, 4, 9)
    runs = (("", tmp_path / "f64"),
            ("dtype = df32\nn_bins = 1\n", tmp_path / "df32"),
            ("dtype = float32\nmeasure_precision = tf32\nn_bins = 1\n",
             tmp_path / "tf32"))
    for extra, out in runs:
        summary = trun(TParameters.from_string(_RUN + "[simulation]\n"
                                               + extra),
                       out_dir=str(out / "results"), verbose=False,
                       device="cpu")
        assert 0.0 < summary.err_uneq_max <= summary.max_precision_error
        for w in range(2):
            got = _layout(out / f"results/data_{w}.h5")
            if extra:
                got = {n: v for n, v in got.items() if n.endswith("_0")
                       or "_0/" in n}
                assert got == {n: v for n, v in want[w].items()
                               if n.endswith("_0") or "_0/" in n}, extra
            else:
                assert got == want[w]
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "dqmc_tpu.analysis", "-d",
                          "results"], cwd=tmp_path / "f64", env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "sign" in (tmp_path / "f64" / "scalarObservables.dat").read_text()
    for name in ("greenTau", "currxxTau", "spinzzTau", "densityTau"):
        assert (tmp_path / "f64" / name).is_dir(), name
