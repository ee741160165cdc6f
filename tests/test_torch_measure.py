"""dqmc_tpu_torch's equal-time measurement against dqmc_tpu: the observables
and transforms on the same G at float64 (1e-12), and the HDF5 output of a
tiny ``python -m dqmc_tpu_torch --device cpu`` run against a tiny
``dqmc_tpu`` run of the same configuration (identical groups, datasets,
shapes and dtypes; readable by ``python -m dqmc_tpu.analysis``)."""

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
from dqmc_tpu.measure.transforms import r_to_k as jr_to_k
from dqmc_tpu.measure.transforms import site_to_r as jsite_to_r
from dqmc_tpu_torch.measure import observables as tobs
from dqmc_tpu_torch.measure.context import make_context as tctx
from dqmc_tpu_torch.measure.transforms import r_to_k, site_to_r, \
    site_to_r_batched
from torch_port_util import to_np

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dqmc_tpu.run import run_simulation
    jdir = tmp_path_factory.mktemp("jax_run")
    run_simulation(Parameters.from_string(_PARAMS),
                   out_dir=str(jdir / "results"), verbose=False)
    tdir = tmp_path_factory.mktemp("torch_run")
    (tdir / "parameters.in").write_text(_PARAMS)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-m", "dqmc_tpu_torch",
                          "--device", "cpu"], cwd=tdir, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    return jdir, tdir, res.stdout


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
