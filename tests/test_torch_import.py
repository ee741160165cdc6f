"""dqmc_tpu_torch imports without a CUDA toolchain and never imports jax
or anything of the JAX package dqmc_tpu;
configurations outside the ported slice raise instead of being ignored;
a CUDA request without a CUDA device raises instead of falling back."""

import os
import subprocess
import sys

import pytest
import torch

from dqmc_tpu.config import Parameters

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import dqmc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(dqmc_tpu_torch.__path__,
                                               'dqmc_tpu_torch.')
         if not m.name.endswith('__main__')]
for name in names:
    importlib.import_module(name)
assert 'jax' not in sys.modules, 'jax was imported'
assert 'triton' not in sys.modules, 'triton was imported'
reached = [m for m in sys.modules
           if m == 'dqmc_tpu' or m.startswith('dqmc_tpu.')]
assert not reached, f'the JAX package was imported: {reached}'
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 15


_BASE = """
[Lattice]
L1 = 4
L2 = 4
[hubbard]
U = 4.0
t = 1.0
mu = 0.0
[simulation]
beta = 2.0
nt = 8
n_therms = 1
n_sweeps = 1
n_bins = 1
n_stab = 4
"""


@pytest.mark.parametrize("section,key,value", [
    ("simulation", "wrap_precision", "default"),
    ("simulation", "matmul_precision", "default"),
])
def test_unported_configuration_raises(tmp_path, section, key, value):
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters.from_string(_BASE)
    params.set(section, key, value)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_simulation(params, out_dir=str(tmp_path / "results"),
                       verbose=False, device="cpu")


@pytest.mark.parametrize("section,key,value,match", [
    ("hubbard", "model", "extended", "attractive or repulsive"),
    ("simulation", "fused_update", "rank1", "delayed or submatrix"),
    ("simulation", "engine", "both", "auto, fused or slice"),
    ("simulation", "site_update", "fast", "pallas, scan"),
])
def test_unknown_choice_raises(tmp_path, section, key, value, match):
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters.from_string(_BASE)
    params.set(section, key, value)
    with pytest.raises(ValueError, match=match):
        run_simulation(params, out_dir=None, verbose=False, device="cpu")


def test_forced_fused_engine_refuses_two_flavor_submatrix():
    """engine = fused lets what the fused engine does not support raise;
    engine = auto falls to the per-slice engine."""
    from dqmc_tpu_torch.run import run_simulation
    params = Parameters.from_string(_BASE)
    params.set("hubbard", "model", "repulsive")
    params.set("simulation", "fused_update", "submatrix")
    params.set("simulation", "engine", "fused")
    with pytest.raises(NotImplementedError, match="fused sweep"):
        run_simulation(params, out_dir=None, verbose=False, device="cpu")
    params.set("simulation", "engine", "auto")
    summary = run_simulation(params, out_dir=None, verbose=False,
                             device="cpu")
    assert summary.observables["sign"] == 1.0


def test_cuda_request_without_cuda_raises(tmp_path, monkeypatch):
    from dqmc_tpu_torch.run import run_simulation
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_simulation(Parameters.from_string(_BASE),
                       out_dir=str(tmp_path / "results"), verbose=False,
                       device="cuda")


@pytest.mark.parametrize("kernel", ["cgs2_qr", "fused_wrap", "fused_sites",
                                    "fused_sites_2f", "fused_sites_sub",
                                    "delayed_sites_2f", "df_qr_panel",
                                    "tf_qr_panel"])
def test_kernel_wrappers_raise_on_cpu_tensors(kernel):
    """A kernel wrapper launches its kernel or raises: it never runs the
    plain twin, and a refused call counts no launch."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.engine import fused
    from dqmc_tpu_torch.ops import df32, df_qr_kernel, kernels, qr_kernel, \
        tf32
    W, n = 2, 32
    G = torch.zeros((W, n, n))
    G2 = torch.zeros((W, 2, n, n))
    v = torch.zeros((W, n))
    v2 = torch.zeros((W, 2, n))
    order = torch.zeros((1, n), dtype=torch.int32)
    calls = {
        "fused_sites_2f": lambda: fused.site_loop_cuda(
            G2, v.clone(), order, v, v2, v, 0, 32, torch.ones(W)),
        "fused_sites_sub": lambda: fused.site_loop_sub_cuda(
            G, v.clone(), order, v, v, v, 0, 32),
        "delayed_sites_2f": lambda: kernels.check_cuda_slice(
            G2, order[0], v, v2, v, "delayed", 32),
        "cgs2_qr": lambda: qr_kernel._cgs2_qr_cuda(G, True),
        "df_qr_panel": lambda: df_qr_kernel.panel_cuda(
            df32.zeros((W, 32, n)), 2),
        "tf_qr_panel": lambda: df_qr_kernel.panel_cuda(
            tf32.zeros((W, 32, n)), 3),
        "fused_wrap": lambda: fused.wrap_gemm_cuda(G, G, rv=v),
        "fused_sites": lambda: fused.site_loop_cuda(
            G, v.clone(), torch.zeros((1, n), dtype=torch.int32), v, v, v,
            0, 32),
    }
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        calls[kernel]()
    assert _cuda.LAUNCHES == before


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """The build is deferred to first use and reports a missing toolkit."""
    from dqmc_tpu_torch import _cuda
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _cuda.build()


def test_kernel_sources_are_listed():
    from dqmc_tpu_torch import _cuda
    names = [p.name for p in _cuda.sources()]
    assert names == ["cgs2_qr.cu", "fused_block.cu", "mw_qr_panel.cu",
                     "site_update.cu", "submatrix_update.cu"]
    assert _cuda.library_path().parent == _cuda.BUILD_DIR
    assert sorted(p.name for p in _cuda.CSRC.glob("*.cuh")) == [
        "rank_k_flush.cuh", "site_loop.cuh", "submatrix_decide.cuh"]
    assert set(_cuda.LAUNCHES) == {
        "cgs2_qr", "fused_wrap", "fused_sites", "fused_sites_2f",
        "fused_sites_sub", "delayed_slice", "delayed_slice_2f",
        "rank1_sites", "submatrix_group", "submatrix_flush", "df_qr_panel",
        "tf_qr_panel"}
    # every C entry point has both float types' signatures declared
    assert {"dqmc_site_loop_2f", "dqmc_site_loop_sub",
            "dqmc_delayed_slice_2f", "dqmc_submatrix_slice",
            "dqmc_submatrix_group"} <= set(_cuda._SIGNATURES)
    # the multiword panels are float32 only and build without contraction
    assert set(_cuda._FLOAT32_SIGNATURES) == {"dqmc_df_qr_panel",
                                              "dqmc_tf_qr_panel"}
    assert "--fmad=false" in _cuda.nvcc_flags(_cuda.CSRC / "mw_qr_panel.cu")
    assert "--fmad=false" not in _cuda.nvcc_flags(_cuda.CSRC / "cgs2_qr.cu")
