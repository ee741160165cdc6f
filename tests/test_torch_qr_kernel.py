"""The CGS2 QR twin of dqmc_tpu_torch (the plain version of the CUDA kernel
K1, which runs on CPU tensors) against the JAX Pallas kernel in interpret
mode: the same factorization to 1e-12 at float64, and the JAX tests'
factorization-quality thresholds at float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu.ops.qr_kernel import _cgs2_qr_impl, cgs2_qr_inv
from dqmc_tpu_torch.ops import qr_kernel as tqr
from torch_port_util import (release_jax_programs, to_np)  # noqa: F401

torch.set_num_threads(1)


def _graded(rng, B, n, spread=12.0, dtype=np.float32):
    """tests/test_qr_kernel.py's column-graded, column-normalized inputs."""
    base = rng.standard_normal((B, n, n))
    grade = np.exp(rng.uniform(-spread / 2, spread / 2, (B, n)))
    M = base * grade[:, None, :]
    s = np.abs(M).max(axis=1)
    return (M / s[:, None, :]).astype(dtype)


@pytest.mark.parametrize("n", [64, 36])
def test_cgs2_twin_matches_jax_kernel_f64(rng, n):
    """(2, 64, 64) directly and n = 36 through the exact identity padding
    to 64: Q, R and R^{-1} agree with the Pallas kernel to 1e-12."""
    A = rng.standard_normal((2, n, n))
    if n % 32 == 0:
        want = _cgs2_qr_impl(jnp.asarray(A), interpret=True, with_inv=True)
    else:
        want = cgs2_qr_inv(jnp.asarray(A))
    got = tqr.cgs2_qr_inv(torch.as_tensor(A))
    for name, g, w in zip(("Q", "R", "Rinv"), got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=1e-12,
                                   err_msg=name)


@pytest.mark.parametrize("n", [64, 32, 96, 128])
def test_cgs2_twin_f32_quality(rng, n):
    """tests/test_qr_kernel.py's thresholds: orthogonality < 2e-4,
    reconstruction < 5e-6, R upper triangular with a non-negative
    diagonal."""
    A = _graded(rng, 4, n)
    Q, R = tqr.cgs2_qr(torch.as_tensor(A))
    Q, R = to_np(Q).astype(np.float64), to_np(R).astype(np.float64)
    assert np.abs(Q.swapaxes(-1, -2) @ Q - np.eye(n)).max() < 2e-4
    assert np.abs(Q @ R - A.astype(np.float64)).max() < 5e-6
    assert np.abs(np.tril(R, -1)).max() == 0.0
    assert (np.diagonal(R, axis1=-2, axis2=-1) >= 0).all()


@pytest.mark.parametrize("spread", [16.0, 4.0, 8.0, 12.0])
def test_cgs2_twin_d_ladder_matches_householder(rng, spread):
    """|diag R| (the LDR d-ladder) to columnwise relative accuracy."""
    A = _graded(rng, 2, 64, spread=spread)
    _, R = tqr.cgs2_qr(torch.as_tensor(A))
    R64 = np.linalg.qr(A.astype(np.float64))[1]
    d = np.abs(np.diagonal(to_np(R).astype(np.float64), axis1=-2, axis2=-1))
    d64 = np.abs(np.diagonal(R64, axis1=-2, axis2=-1))
    assert (np.abs(d - d64) / d64).max() < 1e-4


@pytest.mark.parametrize("n", [20, 36, 1, 5, 31, 33, 50, 70, 100])
def test_cgs2_padding_is_exact(rng, n):
    A = torch.as_tensor(rng.standard_normal((3, n, n)))
    Q, R, W = tqr.cgs2_qr_inv(A)
    eye = np.eye(n)
    np.testing.assert_allclose(to_np(Q @ R), to_np(A), atol=1e-13)
    np.testing.assert_allclose(to_np(Q.mT @ Q), np.broadcast_to(eye, Q.shape),
                               atol=1e-13)
    np.testing.assert_allclose(to_np(W @ R), np.broadcast_to(eye, Q.shape),
                               atol=1e-11)
    assert np.abs(np.tril(to_np(R), -1)).max() == 0.0


def test_cgs2_keeps_leading_axes(rng):
    A = torch.as_tensor(rng.standard_normal((2, 3, 32, 32)))
    Q, R = tqr.cgs2_qr(A)
    Qf, Rf = tqr.cgs2_qr(A.reshape(6, 32, 32))
    assert Q.shape == A.shape
    np.testing.assert_array_equal(to_np(Q).reshape(6, 32, 32), to_np(Qf))
    np.testing.assert_array_equal(to_np(R).reshape(6, 32, 32), to_np(Rf))


def test_cgs2_kernel_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError, match="multiple of 32"):
        tqr._cgs2_qr_cuda(torch.zeros((1, 40, 40)), False)
    with pytest.raises(ValueError, match="square"):
        tqr.cgs2_qr(torch.zeros((2, 4, 5)))


def test_cgs2_twin_padded_above_512(rng):
    """n = 520 pads to 544, past the old 512 limit (the kernel now takes
    n <= 1024 in float32): reconstruction, orthogonality, a non-negative
    diagonal, and R equal to Householder's after its sign fix."""
    n = 520
    A = rng.standard_normal((1, n, n))
    Q, R = tqr.cgs2_qr(torch.as_tensor(A))
    Q, R = to_np(Q), to_np(R)
    assert Q.shape == R.shape == (1, n, n)
    np.testing.assert_allclose(Q @ R, A, atol=1e-10)
    np.testing.assert_allclose(Q.swapaxes(-1, -2) @ Q, np.eye(n)[None],
                               atol=1e-10)
    assert np.abs(np.tril(R, -1)).max() == 0.0
    assert (np.diagonal(R, axis1=-2, axis2=-1) >= 0).all()
    Rh = np.linalg.qr(A[0])[1]
    Rh = np.sign(np.diagonal(Rh))[:, None] * Rh
    np.testing.assert_allclose(R[0], Rh, atol=1e-10)


@pytest.mark.parametrize("dtype,n,ok", [(torch.float32, 1024, True),
                                        (torch.float32, 1056, False),
                                        (torch.float64, 512, True),
                                        (torch.float64, 544, False),
                                        (torch.float32, 32, True),
                                        (torch.float32, 992, True),
                                        (torch.float32, 2048, False),
                                        (torch.float64, 32, True),
                                        (torch.float64, 480, True),
                                        (torch.float64, 1024, False)])
def test_cgs2_kernel_size_limit_by_dtype(dtype, n, ok):
    """The kernel stages a 32-row panel in shared memory: n <= 1024 in
    float32, n <= 512 in float64.  Sizes inside the limit pass the shape
    check and stop at the device check on a CPU tensor."""
    A = torch.zeros((1, n, n), dtype=dtype)
    with pytest.raises(ValueError,
                       match="takes CUDA tensors" if ok else "<= "):
        tqr._cgs2_qr_cuda(A, False)
