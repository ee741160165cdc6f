"""dqmc_tpu_torch's multiword QR (ops/df_qr.py, ops/df_qr_kernel.py,
ops/tf_qr_kernel.py) held against the JAX package's on the CPU.

The panel kernels' plain twin (the CPU path of kernels #7 and #8) against
JAX's Pallas panel kernels run in interpret mode, the hybrid QRs against
JAX's, and the plain multiword CGS2 against JAX's df_qr: every word bit for
bit (the digit extraction, the exact class sums and the multiword
recombination follow the TPU kernels' order), plus tests/test_df_qr_kernel.py's
backward-error pin.  The kernels themselves are held to the twin on the
card (tests/test_torch_cuda.py, chip_smoke.py phase 14).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu.ops import df32 as jdf
from dqmc_tpu.ops import df_qr as jdq
from dqmc_tpu.ops import df_qr_kernel as jdk
from dqmc_tpu.ops import tf32 as jtf
from dqmc_tpu.ops import tf_qr_kernel as jtk
from dqmc_tpu_torch import _cuda
from dqmc_tpu_torch.ops import df32 as tdf
from dqmc_tpu_torch.ops import df_qr as tdq
from dqmc_tpu_torch.ops import df_qr_kernel as tdk
from dqmc_tpu_torch.ops import tf32 as ttf
from dqmc_tpu_torch.ops import tf_qr_kernel as ttk
from torch_port_util import (  # noqa: F401
    mw_equal,
    release_jax_programs,
    to_np)

torch.set_num_threads(1)

NMS = {"df32": (jdf, tdf), "tf32": (jtf, ttf)}


def _graded(seed, shape, span):
    """float64 values with columns (last axis) graded over e^+-span."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) * np.exp(
        np.linspace(span, -span, shape[-1]))


def _both(nm, x):
    jm, tm = NMS[nm]
    return jm.from_f64(jnp.asarray(x)), tm.from_f64(torch.from_numpy(x))


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("nm", list(NMS))
def test_panel_twin_matches_jax_kernel(nm, n):
    """Twin vs _panel_cgs2_impl(..., interpret=True) at (2, 32, n): Q and
    the compacted R rows bit for bit."""
    x = np.random.default_rng(3).standard_normal((2, 32, n)) * np.exp(
        np.random.default_rng(4).uniform(-3, 3, (2, 32, 1)))
    jp, tp = _both(nm, x)
    if nm == "df32":
        out = jdk._panel_cgs2_impl(jp.hi, jp.lo, interpret=True)
        want_q, want_r = out[:2], tuple(r[..., ::8] for r in out[2:])
        Q, R = tdk.panel_plain(tp, tdf)
    else:
        out = jtk._panel_cgs2_impl(jp.hi, jp.mi, jp.lo, interpret=True)
        want_q, want_r = out[:3], tuple(r[..., ::16] for r in out[3:])
        Q, R = tdk.panel_plain(tp, ttf)
    assert mw_equal(want_q, Q)
    assert mw_equal(want_r, R)


@pytest.mark.parametrize("nm", list(NMS))
def test_hybrid_matches_jax(nm):
    """df_qr_hybrid (rolled) / tf_qr_hybrid (unrolled) at (2, 64, 64) on
    the CPU, the panels through the twin: bit for bit against JAX's."""
    ja, ta = _both(nm, _graded(7, (2, 64, 64), 6.0))
    if nm == "df32":
        want, got = jdk.df_qr_hybrid(ja), tdk.df_qr_hybrid(ta)
    else:
        want, got = jtk.tf_qr_hybrid(ja), ttk.tf_qr_hybrid(ta)
    assert mw_equal(want[0], got[0])
    assert mw_equal(want[1], got[1])


@pytest.mark.parametrize("n,span", [(32, 4.0), (64, 6.0)])
def test_hybrid_matches_oracle(n, span):
    """tests/test_df_qr_kernel.py's pin on the port's df hybrid: columnwise
    backward error < 5e-13 on graded matrices, Q orthonormal to 5e-12, R
    exactly upper triangular."""
    A64 = _graded(5, (2, n, n), span)
    Q, R = tdk.df_qr_hybrid(tdf.from_f64(torch.from_numpy(A64)))
    Q64, R64 = to_np(tdf.to_f64(Q)), to_np(tdf.to_f64(R))
    colnorm = np.abs(A64).max(axis=-2, keepdims=True)
    back = (np.abs(Q64 @ R64 - A64).max(axis=-2, keepdims=True)
            / colnorm).max()
    assert back < 5e-13
    assert np.abs(Q64.swapaxes(-1, -2) @ Q64 - np.eye(n)).max() < 5e-12
    assert np.abs(np.tril(R64, -1)).max() == 0.0


@pytest.mark.parametrize("nm", list(NMS))
def test_plain_qr_matches_jax(nm):
    """The plain multiword CGS2 (the CPU path, and beyond the kernels'
    gate) at (2, 16, 16), one full-width panel: bit for bit in df32.  JAX
    compiles the column loop's body (lax.fori_loop), and XLA:CPU rounds the
    lowest tf32 word of that compiled body differently from JAX's own op-by-
    op arithmetic (which the port matches bit for bit, as with the panels):
    in tf32 the port agrees to 2^-64 of each column's magnitude."""
    jm, tm = NMS[nm]
    ja, ta = _both(nm, _graded(9, (2, 16, 16), 3.0))
    got = tdq.df_qr(ta, nm=tm)
    compiled = jdq.df_qr(ja, nm=jm)
    if nm == "df32":
        assert mw_equal(compiled[0], got[0])
        assert mw_equal(compiled[1], got[1])
        return
    for w, g in zip(compiled, got):
        w64, g64 = np.asarray(jm.to_f64(w)), to_np(tm.to_f64(g))
        scale = np.abs(w64).max(axis=-2, keepdims=True)
        assert (np.abs(w64 - g64) / scale).max() <= 2.0 ** -64


@pytest.mark.parametrize("n", [16, 24, 32, 96, 512, 544])
@pytest.mark.parametrize("nm", list(NMS))
def test_kernel_gate_follows_jax(nm, n, monkeypatch):
    """The hybrid takes the panel path exactly for n % 32 == 0 and
    n <= 512 (JAX's gate); other shapes go to the plain df_qr."""
    seen = []
    monkeypatch.setattr(tdk, "panel_call", lambda P, *a: seen.append(
        P.hi.shape) or (_ for _ in ()).throw(StopIteration))
    monkeypatch.setattr(ttk, "panel_call", tdk.panel_call)
    monkeypatch.setattr(tdq, "df_qr", lambda A, nm=tdf: "plain")
    tm = NMS[nm][1]
    A = tm.zeros((1, n, n))
    hybrid = tdk.df_qr_hybrid if nm == "df32" else ttk.tf_qr_hybrid
    if n % 32 == 0 and n <= 512:
        with pytest.raises(StopIteration):
            hybrid(A)
        assert seen == [(1, 32, n)]
    else:
        assert hybrid(A) == "plain"
        assert not seen


@pytest.mark.parametrize("words", [2, 3])
def test_panel_kernel_wrapper_refuses_cpu_tensors(words):
    """The CUDA path launches the kernel or raises; a refused call counts
    no launch (the CPU path is the twin, taken by panel_call)."""
    tm = tdf if words == 2 else ttf
    before = dict(_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tdk.panel_cuda(tm.zeros((2, 32, 64)), words)
    with pytest.raises(ValueError, match="multiple of 32"):
        tdk.panel_cuda(tm.zeros((2, 32, 48)), words)
    assert _cuda.LAUNCHES == before
