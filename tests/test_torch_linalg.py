"""dqmc_tpu_torch's LDR algebra against dqmc_tpu at float64, on graded
chain products built from the model's propagators.

Tolerances sit on the invariants -- the reconstructed product L d R, the
stabilized G and log|det| -- to 1e-12, never on Q's columns, whose signs are
a LAPACK convention."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard
from dqmc_tpu.ops import linalg as jlin
from dqmc_tpu_torch.ops import linalg as tlin
from torch_port_util import (release_jax_programs, to_np)  # noqa: F401

torch.set_num_threads(1)


def _propagators(seed, L=4, nt=24, beta=6.0):
    """nt slice propagators B_l = diag(exp(g eta)) expK (f64, numpy)."""
    rng = np.random.default_rng(seed)
    model = AttractiveHubbard.build(square_lattice(L, L), U=4.0, t=1.0,
                                    mu=-0.1, beta=beta, nt=nt,
                                    dtype=jnp.float64)
    fields = rng.integers(0, 4, (nt, L * L))
    return [np.asarray(model.B_of(jnp.asarray(f))[0]) for f in fields]


def _fold(ops, Bs, block=4):
    """Chain F = prod_l B_l folded every ``block`` slices through
    to_ldr / mat_mul_ldr (one package's ops)."""
    F = None
    for i in range(0, len(Bs), block):
        P = np.eye(Bs[0].shape[0])
        for B in Bs[i:i + block]:
            P = B @ P
        P = ops["asarray"](P)
        F = ops["to_ldr"](P) if F is None else ops["mat_mul_ldr"](P, F)
    return F


JOPS = dict(asarray=jnp.asarray, to_ldr=jlin.to_ldr,
            mat_mul_ldr=jlin.mat_mul_ldr)
TOPS = dict(asarray=torch.as_tensor, to_ldr=tlin.to_ldr,
            mat_mul_ldr=tlin.mat_mul_ldr)


def _rel_gap(a, b):
    a, b = to_np(a), to_np(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("seed", [0, 5, 6])
def test_to_ldr_matches_jax(seed):
    Bs = _propagators(seed)
    M = np.eye(16)
    for B in Bs[:8]:
        M = B @ M
    jF, tF = jlin.to_ldr(jnp.asarray(M)), tlin.to_ldr(torch.as_tensor(M))
    assert _rel_gap(tlin.ldr_matrix(tF), M) < 1e-12
    assert _rel_gap(tlin.ldr_matrix(tF), jlin.ldr_matrix(jF)) < 1e-12
    # d >= 0, R with a unit-modulus diagonal up to the column permutation
    assert (to_np(tF.d) >= 0).all()
    # this product is row-graded, where the presorted QR is normwise (not
    # columnwise) accurate: the d ladder agrees to 1e-12 of its top
    d = np.sort(np.asarray(jF.d))
    np.testing.assert_allclose(np.sort(to_np(tF.d)), d, rtol=1e-10,
                               atol=1e-12 * d.max())


@pytest.mark.parametrize("seed", [1, 2, 7, 8])
def test_mat_mul_ldr_chain_matches_jax(seed):
    Bs = _propagators(seed)
    jF, tF = _fold(JOPS, Bs), _fold(TOPS, Bs)
    assert _rel_gap(tlin.ldr_matrix(tF), jlin.ldr_matrix(jF)) < 1e-12
    # the d ladder spans many decades; its large end agrees relatively
    big = np.asarray(jF.d) > 1e-3
    np.testing.assert_allclose(np.sort(to_np(tF.d))[::-1][:big.sum()],
                               np.sort(np.asarray(jF.d))[::-1][:big.sum()],
                               rtol=1e-10)


@pytest.mark.parametrize("beta", [1.0, 6.0, 0.5, 3.0])
def test_inv_one_plus_ldr_dag_matches_jax(beta):
    Bs = _propagators(3, beta=beta)
    half = len(Bs) // 2
    # prefix in normal form, suffix in transpose form
    jF1, tF1 = _fold(JOPS, Bs[:half]), _fold(TOPS, Bs[:half])
    suffix_t = [B.T for B in Bs[half:][::-1]]
    jF2, tF2 = _fold(JOPS, suffix_t), _fold(TOPS, suffix_t)
    jG, jld = jlin.inv_one_plus_ldr_dag(jF1, jF2)
    tG, tld = tlin.inv_one_plus_ldr_dag(tF1, tF2)
    np.testing.assert_allclose(to_np(tG), np.asarray(jG), atol=1e-12)
    np.testing.assert_allclose(float(tld), float(jld), atol=1e-12)
    if beta > 1.0:
        return  # the dense inverse below is only accurate at small beta
    # G(tau) = (I + B(tau,0) B(beta,tau))^{-1} by dense inversion
    P1, P2 = np.eye(16), np.eye(16)
    for B in Bs[:half]:
        P1 = B @ P1
    for B in Bs[half:]:
        P2 = B @ P2
    np.testing.assert_allclose(to_np(tG),
                               np.linalg.inv(np.eye(16) + P1 @ P2),
                               atol=1e-12)


@pytest.mark.parametrize("n", [8, 1, 16, 36])
def test_identity_factors(n):
    F = tlin.identity_ldr(n)
    assert _rel_gap(tlin.ldr_matrix(F), np.eye(n)) == 0.0
    G, log_det = tlin.inv_one_plus_ldr_dag(F, F)
    np.testing.assert_allclose(to_np(G), 0.5 * np.eye(n), atol=1e-15)
    np.testing.assert_allclose(float(log_det), n * np.log(2.0), rtol=1e-14)


@pytest.mark.parametrize("n", [20, 8, 33])
def test_qr_solve_logdet_matches_jax(rng, n):
    A = rng.standard_normal((3, n, n)) + 4 * np.eye(n)
    B = rng.standard_normal((3, n, n))
    jX, jl = jax.vmap(jlin._qr_solve_logdet)(jnp.asarray(A), jnp.asarray(B))
    tX, tl = tlin._qr_solve_logdet(torch.as_tensor(A), torch.as_tensor(B))
    np.testing.assert_allclose(to_np(tX), np.asarray(jX), atol=1e-12)
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), atol=1e-12)


@pytest.mark.parametrize("mode", ["householder", "cgs2"])
def test_f32_orthogonalization_modes(mode, rng):
    """Both float32 backends (the CGS2 twin stands in for the kernel on the
    CPU) factor a graded fold and solve a stabilized system to f32
    accuracy."""
    Bs = _propagators(4, nt=8, beta=2.0)
    M = np.eye(16)
    for B in Bs:
        M = B @ M
    tlin.set_f32_orthogonalization(mode)
    try:
        F = tlin.to_ldr(torch.as_tensor(M, dtype=torch.float32))
        A = torch.as_tensor(rng.standard_normal((2, 16, 16)) + 4 * np.eye(16),
                            dtype=torch.float32)
        Y = torch.as_tensor(rng.standard_normal((2, 16, 4)),
                            dtype=torch.float32)
        X, logabs = tlin._qr_solve_logdet(A, Y)
    finally:
        tlin.set_f32_orthogonalization("auto")
    assert _rel_gap(tlin.ldr_matrix(F).double(), M) < 1e-5
    A64 = A.double().numpy()
    np.testing.assert_allclose(X.double().numpy(),
                               np.linalg.solve(A64, Y.double().numpy()),
                               atol=1e-5)
    np.testing.assert_allclose(logabs.double().numpy(),
                               np.linalg.slogdet(A64)[1], atol=1e-5)
    with pytest.raises(ValueError):
        tlin.set_f32_orthogonalization("cholqr2")
