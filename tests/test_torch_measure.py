"""dqmc_tpu_torch's equal-time measurement against dqmc_tpu: the observables
and transforms on the same G at float64 (1e-12), and the HDF5 output of a
tiny ``python -m dqmc_tpu_torch --device cpu`` run against a tiny
``dqmc_tpu`` run of the same configuration (identical groups, datasets,
shapes and dtypes; readable by ``python -m dqmc_tpu.analysis``).  The same
for the repulsive model: the spin correlators, the sign-weighted increments
and the ``sign`` scalar against the JAX manager at 1e-12, and a doped 4x4
run with ``measure_spin`` whose bins match the JAX package's layout."""

import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu.config import Parameters
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.measure import observables as jobs
from dqmc_tpu.measure.context import make_context as jctx
from dqmc_tpu.measure.manager import MeasurementManager as JManager
from dqmc_tpu.measure.transforms import r_to_k as jr_to_k
from dqmc_tpu.measure.transforms import site_to_r as jsite_to_r
from dqmc_tpu_torch.measure import observables as tobs
from dqmc_tpu_torch.measure.context import make_context as tctx
from dqmc_tpu_torch.measure.manager import MeasurementManager as TManager
from dqmc_tpu_torch.measure.transforms import r_to_k, site_to_r, \
    site_to_r_batched
from torch_port_util import (  # noqa: F401
    release_jax_programs,
    shared_dir,
    to_np)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _greens(rng, W=3, ns=16):
    """Symmetric-ish random 'Green's functions' near 1/2 filling."""
    X = rng.standard_normal((W, 1, ns, ns)) * 0.1
    return 0.5 * np.eye(ns) + X


@pytest.mark.parametrize("name", ["density", "doubleOcc", "swave",
                                  "densityCorr"])
def test_observables_match_jax(rng, name):
    lat = square_lattice(4, 4)
    G = _greens(rng)
    jfn = {**jobs.SCALAR_OBSERVABLES, **jobs.EQUAL_TIME_OBSERVABLES}[name]
    tfn = {**tobs.SCALAR_OBSERVABLES, **tobs.EQUAL_TIME_OBSERVABLES}[name]
    jc = jctx(lat, jnp.float64)
    want = jax.vmap(lambda g: jfn(g, jc))(jnp.asarray(G))
    got = tfn(torch.as_tensor(G), tctx(lat))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-12)


@pytest.mark.parametrize("name", ["spinZZCorr", "spinXXCorr", "density",
                                  "doubleOcc", "densityCorr"])
def test_two_flavor_observables_match_jax(rng, name):
    lat = square_lattice(4, 4)
    G = 0.5 * np.eye(16) + rng.standard_normal((3, 2, 16, 16)) * 0.1
    jall = {**jobs.SCALAR_OBSERVABLES, **jobs.EQUAL_TIME_OBSERVABLES,
            **jobs.SPIN_OBSERVABLES}
    tall = {**tobs.SCALAR_OBSERVABLES, **tobs.EQUAL_TIME_OBSERVABLES,
            **tobs.SPIN_OBSERVABLES}
    jc = jctx(lat, jnp.float64)
    want = jax.vmap(lambda g: jall[name](g, jc))(jnp.asarray(G))
    got = tall[name](torch.as_tensor(G), tctx(lat))
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-12)


def test_spin_correlators_su2(rng):
    """For a spin-symmetric G the zz and xx correlators are equal."""
    G = torch.as_tensor(_greens(rng))
    c = tctx(square_lattice(4, 4))
    np.testing.assert_allclose(to_np(tobs.spin_zz_corr(G, c)),
                               to_np(tobs.spin_xx_corr(G, c)), atol=1e-14)
    G2 = G.expand(3, 2, 16, 16)
    np.testing.assert_allclose(to_np(tobs.spin_zz_corr(G2, c)),
                               to_np(tobs.spin_zz_corr(G, c)), atol=1e-14)


@pytest.mark.parametrize("signed", [True, False])
def test_increments_match_jax_manager(rng, signed):
    """One measurement of a walker batch through both managers: every
    value sign-weighted and a ``sign`` scalar when signed, neither when
    not."""
    lat = square_lattice(4, 4)
    G = 0.5 * np.eye(16) + rng.standard_normal((3, 2, 16, 16)) * 0.1
    signs = np.array([1.0, -1.0, 1.0])
    jm = JManager(lat, n_walkers=3, out_dir=None, dtype=jnp.float64)
    tm = TManager(lat, n_walkers=3, out_dir=None)
    for m in (jm, tm):
        m.add_defaults()
        m.add_spin()
    jm._build_eq()
    want = jm._measure_eq_vmapped(
        jnp.asarray(G), jnp.asarray(signs if signed else np.ones(3)))
    if not signed:
        want.pop(("scalar", "sign"))
    got = tm.increments(torch.as_tensor(G),
                        torch.as_tensor(signs) if signed else None)
    assert set(got) == set(want)
    assert (("scalar", "sign") in got) == signed
    for key in want:
        np.testing.assert_allclose(to_np(got[key]), np.asarray(want[key]),
                                   atol=1e-12, err_msg=str(key))
    acc = {}
    for _ in range(2):
        tm.accumulate(acc, got)
    assert set(acc) == set(got)
    for key in want:
        np.testing.assert_allclose(to_np(acc[key]),
                                   2.0 * np.asarray(want[key]), atol=1e-12,
                                   err_msg=str(key))


@pytest.mark.parametrize("L1,L2", [(4, 4), (6, 4)])
def test_transforms_match_jax(rng, L1, L2):
    lat = square_lattice(L1, L2)
    ns = lat.n_sites
    chi = rng.standard_normal((ns, ns))
    jc, tc = jctx(lat, jnp.float64), tctx(lat)
    want_r = np.asarray(jsite_to_r(jnp.asarray(chi), jc))
    got_r = to_np(site_to_r(torch.as_tensor(chi), tc))
    np.testing.assert_allclose(got_r, want_r, atol=1e-12)
    batched = to_np(site_to_r_batched(torch.as_tensor(chi[None]), tc))[0]
    np.testing.assert_allclose(batched, want_r, atol=1e-12)
    want_k = np.asarray(jr_to_k(jnp.asarray(want_r), jc))
    np.testing.assert_allclose(r_to_k(got_r, tc), want_k, atol=1e-12)


_PARAMS = """
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
n_sweeps = 2
n_bins = 2
n_stab = 4
symmetric = true
isMeasureUnequalTime = false
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


def _both_runs(request, tmp_path_factory, key, params):
    """The JAX package's run_simulation and the port's CLI on the same
    parameters, once per test run (shared_dir): (JAX dir, port dir, the
    CLI's stdout)."""
    def make(root):
        from dqmc_tpu.run import run_simulation
        run_simulation(Parameters.from_string(params),
                       out_dir=str(root / "jax" / "results"), verbose=False)
        tdir = root / "torch"
        tdir.mkdir(exist_ok=True)
        (tdir / "parameters.in").write_text(params)
        env = dict(os.environ, PYTHONPATH=REPO)
        res = subprocess.run([sys.executable, "-m", "dqmc_tpu_torch",
                              "--device", "cpu"], cwd=tdir, env=env,
                             capture_output=True, text=True, timeout=600)
        assert res.returncode == 0, res.stderr
        (root / "stdout.txt").write_text(res.stdout)
    root = shared_dir(request, tmp_path_factory, key, make)
    return root / "jax", root / "torch", (root / "stdout.txt").read_text()


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    return _both_runs(request, tmp_path_factory, "measure_runs", _PARAMS)


def test_cli_output_layout_matches_jax(runs):
    jdir, tdir, stdout = runs
    for w in range(2):
        name = f"results/data_{w}.h5"
        assert _layout(tdir / name) == _layout(jdir / name)
    assert (tdir / "results/info").read_text() == \
        (jdir / "results/info").read_text()
    assert "Average acceptance rate" in stdout


def test_cli_output_values(runs):
    _, tdir, _ = runs
    with h5py.File(tdir / "results/data_0.h5", "r") as f:
        dens = [f[f"bin_{b}/scalar/density"][0] for b in range(2)]
        corr = f["bin_0/equaltime/densityCorr"][...]
    assert all(0.5 < d < 1.5 for d in dens)
    assert np.isfinite(corr).all()


@pytest.mark.parametrize("site_update", ["pallas", "scan", "delayed",
                                         "submatrix"])
def test_cli_slice_engine_layout_matches_jax(runs, tmp_path, site_update):
    """engine = slice with each site update writes the JAX package's HDF5
    layout (the JAX run above takes its per-slice engine on the CPU); one
    thermalization and one sweep per bin (the layout does not depend on
    the sweep counts; the per-slice twins are slow on the CPU)."""
    jdir = runs[0]
    params = Parameters.from_string(_PARAMS)
    for key, value in (("engine", "slice"), ("site_update", site_update),
                       ("delay_rank", 4), ("n_therms", 1), ("n_sweeps", 1)):
        params.set("simulation", key, value)
    (tmp_path / "parameters.in").write_text(params.dumps())
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "dqmc_tpu_torch",
                          "--device", "cpu"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "Engine: per slice" in res.stdout
    for w in range(2):
        name = f"results/data_{w}.h5"
        assert _layout(tmp_path / name) == _layout(jdir / name)


def test_analysis_reads_port_output(runs):
    _, tdir, _ = runs
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "dqmc_tpu.analysis", "-d",
                          "results"], cwd=tdir, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    text = (tdir / "scalarObservables.dat").read_text()
    for name in ("density", "doubleOcc", "swave"):
        assert name in text


_REPULSIVE = """
[Lattice]
L1 = 4
L2 = 4
[hubbard]
model = repulsive
U = 6.0
t = 1.0
mu = -0.8
[simulation]
beta = 4.0
nt = 12
n_therms = 2
n_sweeps = 2
n_bins = 2
n_stab = 4
measure_spin = true
isMeasureUnequalTime = false
seed = 5
dtype = float64
[walkers]
n_walkers = 2
"""


@pytest.fixture(scope="module")
def repulsive_runs(request, tmp_path_factory):
    return _both_runs(request, tmp_path_factory, "measure_repulsive_runs",
                      _REPULSIVE)


def test_repulsive_cli_output_layout_matches_jax(repulsive_runs):
    """A doped repulsive run writes the JAX package's bins: the sign
    scalar and the spin correlators beside the default set."""
    jdir, tdir, stdout = repulsive_runs
    for w in range(2):
        name = f"results/data_{w}.h5"
        layout = _layout(tdir / name)
        assert layout == _layout(jdir / name)
        for ds in ("bin_0/scalar/sign", "bin_1/equaltime/spinZZCorr",
                   "binK_0/equaltime/spinXXCorr"):
            assert ds in layout
    assert "2 flavors" in stdout


def test_repulsive_cli_output_values(repulsive_runs):
    _, tdir, _ = repulsive_runs
    with h5py.File(tdir / "results/data_0.h5", "r") as f:
        signs = [f[f"bin_{b}/scalar/sign"][0] for b in range(2)]
        zz = f["bin_0/equaltime/spinZZCorr"][...]
    # each bin averages two measurements of a sign of +-1
    assert all(s in (-1.0, 0.0, 1.0) for s in signs)
    assert np.isfinite(zz).all()


@pytest.mark.parametrize("engine,extra", [
    ("fused", ""), ("slice", "site_update = pallas\n"),
    ("slice", "site_update = submatrix\ndelay_rank = 4\n")])
def test_repulsive_run_simulation_engines(engine, extra):
    """run_simulation of the repulsive model at half filling on the CPU
    through the fused twins and the per-slice engine: finite observables,
    a sign of +1, density 1 by particle-hole symmetry."""
    from dqmc_tpu_torch.config import Parameters as TParameters
    from dqmc_tpu_torch.run import run_simulation
    params = TParameters.from_string(
        _REPULSIVE + f"[simulation]\nengine = {engine}\n{extra}"
        "[hubbard]\nU = 4.0\nmu = 0.0\n")
    summary = run_simulation(params, out_dir=None, verbose=False,
                             device="cpu")
    obs = summary.observables
    assert obs["sign"] == 1.0
    assert abs(obs["density"] - 1.0) < 1e-8
    assert {"doubleOcc", "swave"} <= set(obs)
    assert 0.0 < summary.acc_rate < 1.0
    # naive propagation over 4 slices of dtau = 1/3 at float64
    assert summary.max_precision_error < 1e-5


def test_analysis_reweights_port_output(repulsive_runs):
    _, tdir, _ = repulsive_runs
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "dqmc_tpu.analysis", "-d",
                          "results"], cwd=tdir, env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    text = (tdir / "scalarObservables.dat").read_text()
    for name in ("density", "doubleOcc", "sign"):
        assert name in text
