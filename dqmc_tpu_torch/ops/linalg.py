"""Numerically stable LDR (UDT) matrix algebra for DQMC propagator products.

PyTorch counterpart of ``dqmc_tpu/ops/linalg.py`` (the reference's
``stablelinalg``).  A propagator product over many imaginary-time slices is
kept as ``F = L @ diag(d) @ R`` with orthogonal L, non-negative scales d and
a well-conditioned R.  Every function takes any leading batch axes.

- ``to_ldr`` pre-sorts columns by their max-abs scale (one ``argsort``)
  instead of greedy column pivoting, equilibrates, and runs a QR; the scales
  are re-attached in the log domain with a clamp at e^+-60 (f32) / e^+-600
  (f64).
- The engine stores suffix products in TRANSPOSE form and uses only the
  "dag" stabilized inverses, whose inputs stay column-graded and f32-safe
  (see the JAX module's notes); ``inv_triplet_dag`` gives the unequal-time
  triplet from one factorization of their shared middle matrix.

Orthogonalization backend for float32: the CGS2 kernel
(``ops/qr_kernel.py``) on a CUDA tensor, Householder ``torch.linalg.qr``
anywhere else ("auto"); ``set_f32_orthogonalization`` forces one of them.
float64 always uses Householder QR.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class LDR(NamedTuple):
    """F = L @ diag(d) @ R; L (..., n, n), d (..., n), R (..., n, n)."""

    L: torch.Tensor
    d: torch.Tensor
    R: torch.Tensor

    @property
    def n(self) -> int:
        return self.L.shape[-1]


def identity_ldr(n: int, dtype=torch.float64, device="cpu") -> LDR:
    eye = torch.eye(n, dtype=dtype, device=device)
    return LDR(eye, torch.ones((n,), dtype=dtype, device=device), eye)


def ldr_matrix(F: LDR) -> torch.Tensor:
    """Dense reconstruction L @ diag(d) @ R (tests/diagnostics)."""
    return F.L @ (F.d[..., :, None] * F.R)


def _log_clamp(dtype) -> float:
    # d is stored as exp(log_d); scales beyond the clamp contribute < eps to
    # every stabilized inverse, so only log|det| saturates
    return 60.0 if dtype == torch.float32 else 600.0


_F32_ORTH = "auto"


def set_f32_orthogonalization(method: str) -> None:
    """"auto" (CGS2 kernel on CUDA, Householder elsewhere), "cgs2" or
    "householder"."""
    global _F32_ORTH
    if method not in ("auto", "cgs2", "householder"):
        raise ValueError(f"unknown orthogonalization method: {method}")
    _F32_ORTH = method


def _f32_mode(A: torch.Tensor) -> str:
    if _F32_ORTH == "auto":
        return "cgs2" if A.device.type == "cuda" else "householder"
    return _F32_ORTH


def _qr(A: torch.Tensor):
    if A.dtype == torch.float32 and _f32_mode(A) == "cgs2":
        from dqmc_tpu_torch.ops.qr_kernel import cgs2_qr
        return cgs2_qr(A)
    return torch.linalg.qr(A)


def _take_cols(X: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(X, idx[..., None, :], dim=-1)


def to_ldr(M: torch.Tensor) -> LDR:
    """Factor M -> L diag(d) R via column-presorted QR (stablelinalg.cpp:
    35-55 semantics): d >= 0, R row-rescaled to a unit-modulus diagonal,
    column permutation folded back so L d R == M.

    Columns are pre-normalized by their max-abs scale s_j, so the QR sees an
    O(1) matrix; d_j = |Rn_jj| s_j and R_ij = (Rn_ij / |Rn_ii|)
    exp(log s_j - log s_i), whose exponent is <= 0 in the sorted upper
    triangle."""
    s = torch.amax(torch.abs(M), dim=-2)
    perm = torch.argsort(-s, dim=-1, stable=True)
    Mp = _take_cols(M, perm)
    sp = torch.take_along_dim(s, perm, dim=-1)
    sp_safe = torch.where(sp == 0, torch.ones_like(sp), sp)
    Q, Rn = _qr(Mp / sp_safe[..., None, :])
    diag = torch.abs(torch.diagonal(Rn, dim1=-2, dim2=-1))
    diag_safe = torch.where(diag == 0, torch.ones_like(diag), diag)
    clamp = _log_clamp(M.dtype)
    log_sp = torch.log(sp_safe)
    log_d = torch.clamp(torch.log(diag_safe) + log_sp, -clamp, clamp)
    d = torch.where((sp == 0) | (diag == 0), torch.zeros_like(sp),
                    torch.exp(log_d))
    ratio = torch.exp(torch.clamp(
        log_sp[..., None, :] - log_sp[..., :, None], max=0.0))
    Ru = (Rn / diag_safe[..., :, None]) * ratio
    inv_perm = torch.argsort(perm, dim=-1)
    return LDR(Q, d, _take_cols(Ru, inv_perm))


def mat_mul_ldr(M: torch.Tensor, F: LDR) -> LDR:
    """F' = M @ F (stablelinalg.cpp:69-79)."""
    Mp = (M @ F.L) * F.d[..., None, :]
    q = to_ldr(Mp)
    return LDR(q.L, q.d, q.R @ F.R)


def _split_scales(d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """d -> (d_large, d_small) = (max(d, 1), min(d, 1))."""
    one = torch.ones_like(d)
    return torch.maximum(d, one), torch.minimum(d, one)


def _qr_solve_logdet(A: torch.Tensor, B: torch.Tensor):
    """(A^{-1} B, log|det A|) for the well-conditioned M systems.

    float64: Householder QR + triangular solve.  float32 in cgs2 mode: the
    CGS2 kernel with in-kernel R^{-1}, X = R^{-1} (Q^T B) and
    log|det A| = sum log diag R.  float32 otherwise: LU solve + slogdet.
    A stable factorization is load-bearing here (gram/Cholesky forms were
    measured to lose the chain)."""
    if A.dtype == torch.float64:
        Q, R = torch.linalg.qr(A)
        X = torch.linalg.solve_triangular(R, Q.transpose(-1, -2) @ B,
                                          upper=True)
        logabs = torch.sum(torch.log(torch.abs(
            torch.diagonal(R, dim1=-2, dim2=-1))), dim=-1)
        return X, logabs
    if _f32_mode(A) == "cgs2":
        from dqmc_tpu_torch.ops.qr_kernel import cgs2_qr_inv
        Q, R, W = cgs2_qr_inv(A)
        X = W @ (Q.transpose(-1, -2) @ B)
        logabs = torch.sum(torch.log(torch.abs(
            torch.diagonal(R, dim1=-2, dim2=-1))), dim=-1)
        return X, logabs
    X = torch.linalg.solve(A, B)
    _, logabs = torch.linalg.slogdet(A)
    return X, logabs


def inv_one_plus_ldr_dag(F1: LDR, F2t: LDR) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """G = [I + B1 B2]^{-1} and log|det(I + B1 B2)|, with B1 = F1 (normal
    form) and B2 given by its transpose factorization F2t
    (B2 = R2^T d2 L2^T):

      M = D1l^{-1} (L1^T L2) D2l^{-1} + D1s (R1 R2^T) D2s
      G = L2 D2l^{-1} M^{-1} D1l^{-1} L1^T
      log|det| = sum log D1l + sum log D2l + log|det M|.
    """
    d1l, d1s = _split_scales(F1.d)
    d2l, d2s = _split_scales(F2t.d)
    L1T = F1.L.transpose(-1, -2)
    R2T = F2t.R.transpose(-1, -2)
    M = ((L1T @ F2t.L) / d1l[..., :, None] / d2l[..., None, :]
         + (d1s[..., :, None] * (F1.R @ R2T)) * d2s[..., None, :])
    Y = L1T / d1l[..., :, None]
    X, logabs = _qr_solve_logdet(M, Y)
    log_det = (torch.sum(torch.log(d1l), dim=-1)
               + torch.sum(torch.log(d2l), dim=-1) + logabs)
    G = (F2t.L / d2l[..., None, :]) @ X
    return G, log_det


def inv_invldr_plus_ldr_dag(F1: LDR, F2t: LDR) -> torch.Tensor:
    """G = [B1^{-1} + B2]^{-1} with B1 = F1 and B2 = F2t_matrix^T, on the
    same middle matrix M as inv_one_plus_ldr_dag:

      B1^{-1} + B2 = R1^{-1} D1s^{-1} M D2l L2^T
      G = L2 D2l^{-1} M^{-1} D1s R1.

    By [X^{-1} + Y]^{-1} = ([X^{-T} + Y^T]^{-1})^T the role-swapped call
    gives G0t = -inv_invldr_plus_ldr_dag(F2t, F1)^T.  Kept as the JAX
    package's API has it; the tau sweep takes all three from
    ``inv_triplet_dag``."""
    d1l, d1s = _split_scales(F1.d)
    d2l, d2s = _split_scales(F2t.d)
    L1T = F1.L.transpose(-1, -2)
    R2T = F2t.R.transpose(-1, -2)
    M = ((L1T @ F2t.L) / d1l[..., :, None] / d2l[..., None, :]
         + (d1s[..., :, None] * (F1.R @ R2T)) * d2s[..., None, :])
    Y = d1s[..., :, None] * F1.R
    X, _ = _qr_solve_logdet(M, Y)
    return (F2t.L / d2l[..., None, :]) @ X


def inv_triplet_dag(F1: LDR, F2t: LDR):
    """The unequal-time triplet from ONE factorization of the middle
    matrix, with B1 = F1 (normal form, B(tau, 0)) and B2 = F2t_matrix^T
    (transpose form, B(beta, tau)):

        Gtt = [I + B1 B2]^{-1}        (dqmc.cpp:264-280)
        Gt0 = [B1^{-1} + B2]^{-1}     (stablelinalg.cpp:160-190)
        G0t = -[B2^{-1} + B1]^{-1}

    Gtt and Gt0 share M and solve together with two stacked right-hand
    sides; the role-swapped G0t is a solve against M^T with the same
    factors (M = QR: M^T x = y => x = Q R^{-T} y).  float32 in cgs2 mode:
    K1 with its in-kernel W = R^{-1}, X = W (Q^T Y) and Xt = Q (W^T Y0t);
    otherwise Householder QR and two triangular solves.  Returns
    (Gtt, Gt0, G0t, log|det(I + B1 B2)|)."""
    d1l, d1s = _split_scales(F1.d)
    d2l, d2s = _split_scales(F2t.d)
    L1T = F1.L.transpose(-1, -2)
    R2T = F2t.R.transpose(-1, -2)
    M = ((L1T @ F2t.L) / d1l[..., :, None] / d2l[..., None, :]
         + (d1s[..., :, None] * (F1.R @ R2T)) * d2s[..., None, :])
    n = F1.n
    Y = torch.cat([L1T / d1l[..., :, None], d1s[..., :, None] * F1.R],
                  dim=-1)
    Y0t = d2s[..., :, None] * F2t.R
    if M.dtype == torch.float32 and _f32_mode(M) == "cgs2":
        from dqmc_tpu_torch.ops.qr_kernel import cgs2_qr_inv
        Q, R, Wi = cgs2_qr_inv(M)
        X = Wi @ (Q.transpose(-1, -2) @ Y)
        Xt = Q @ (Wi.transpose(-1, -2) @ Y0t)
    else:
        Q, R = torch.linalg.qr(M)
        X = torch.linalg.solve_triangular(R, Q.transpose(-1, -2) @ Y,
                                          upper=True)
        Xt = Q @ torch.linalg.solve_triangular(R.transpose(-1, -2), Y0t,
                                               upper=False)
    logabs = torch.sum(torch.log(torch.abs(
        torch.diagonal(R, dim1=-2, dim2=-1))), dim=-1)
    log_det = (torch.sum(torch.log(d1l), dim=-1)
               + torch.sum(torch.log(d2l), dim=-1) + logabs)
    W2 = F2t.L / d2l[..., None, :]
    Gtt = W2 @ X[..., :n]
    Gt0 = W2 @ X[..., n:]
    G0t = -((F1.L / d1l[..., None, :]) @ Xt).transpose(-1, -2)
    return Gtt, Gt0, G0t, log_det
