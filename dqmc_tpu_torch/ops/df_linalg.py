"""Stabilized LDR algebra at multiword (df32 or tf32) precision.

PyTorch counterpart of ``dqmc_tpu/ops/df_linalg.py``: the presorted-QR LDR
scheme of ``ops/linalg.py`` carried in multiword arithmetic, generic over
the numerics module ``nm``.  The factorization is the multiword CGS2
(``_qr``: the panel-kernel hybrids on CUDA within their gate, the plain
``ops/df_qr.df_qr`` elsewhere, as the JAX package's accelerator and CPU
modes); everything around it is multiword Ozaki matmuls and elementwise
algebra.  The scale ladder is stored exponent-split (a multiword mantissa
with hi in [1, 2) and an int32 power-of-two exponent per column), so no
dense intermediate carries it.

Solves against the equilibrated middle matrix use a float32 QR (K1,
``ops/qr_kernel.cgs2_qr``, on CUDA; Householder on the CPU) plus multiword
iterative refinement that keeps the best-residual iterate; the
unequal-time triplet (``inv_triplet_dag``) also solves against its
transpose with the same factors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dqmc_tpu_torch.ops import df32
from dqmc_tpu_torch.ops.df32 import DF, ldexp
from dqmc_tpu_torch.ops.df_qr import df_qr


class LDRdf(NamedTuple):
    """M = L diag(d 2^e) R at multiword precision; d's hi in [1, 2) (exactly
    0 for structurally dead columns), e an int32 exponent per column."""
    L: DF
    d: DF
    R: DF
    e: torch.Tensor


def _renorm_d(d, e: torch.Tensor, nm=df32):
    """Normalize the mantissa hi into [1, 2), folding the shift into e
    (exact power-of-two component scaling); zero mantissas pass through."""
    _, ex = torch.frexp(d.hi)
    sh = torch.where(d.hi > 0, ex - 1, torch.zeros_like(ex)).to(torch.int32)
    return nm.cmap(lambda c: ldexp(c, -sh), d), e + sh


def transpose(x):
    return type(x)(*(c.transpose(-1, -2) for c in x))


def _diag(x):
    return type(x)(*(torch.diagonal(c, dim1=-2, dim2=-1) for c in x))


def _bcast_row(v, shape):
    return type(v)(*(c[..., None, :].expand(shape) for c in v))


def _bcast_col(v, shape):
    return type(v)(*(c[..., :, None].expand(shape) for c in v))


def _take_cols(c, idx):
    return torch.take_along_dim(c, idx[..., None, :].expand(c.shape), dim=-1)


def _qr(M, nm=df32):
    if M.hi.device.type == "cuda":
        if nm is df32:
            from dqmc_tpu_torch.ops.df_qr_kernel import df_qr_hybrid
            return df_qr_hybrid(M)
        from dqmc_tpu_torch.ops.tf_qr_kernel import tf_qr_hybrid
        return tf_qr_hybrid(M)
    return df_qr(M, nm=nm)


def to_ldr(M, nm=df32) -> LDRdf:
    """Column-presorted multiword QR into L diag(d) R (stablelinalg.cpp:
    35-55 semantics): columns sorted by max-abs scale before the QR, d =
    |diag R| with the scales folded back, R row-rescaled to a unit-modulus
    diagonal, the permutation folded into R."""
    s = torch.amax(torch.abs(M.hi), dim=-2)
    perm = torch.argsort(-s, dim=-1, stable=True)
    Mp = nm.cmap(lambda c: _take_cols(c, perm), M)
    sp = torch.take_along_dim(s, perm, dim=-1)
    sp_safe = torch.where(sp == 0, torch.ones_like(sp), sp)
    inv_sp = nm.div(nm.df(torch.ones_like(sp)), nm.df(sp_safe))
    Mn = nm.mul(Mp, _bcast_row(inv_sp, Mp.hi.shape))
    Q, Rn = _qr(Mn, nm=nm)
    dn = _diag(Rn)
    sign = torch.where(dn.hi < 0, -1.0, 1.0)
    dabs = nm.cmap(lambda c: c * sign, dn)
    dabs_safe = nm.where(dabs.hi == 0, nm.df(torch.ones_like(dabs.hi)),
                         dabs)
    d = nm.mul(dabs_safe, nm.df(sp_safe))
    d = nm.where((sp == 0) | (dabs.hi == 0),
                 nm.df(torch.zeros_like(sp)), d)
    # R: rows rescaled by sign/|diag|, then un-equilibrated by sp_j / sp_i
    # on the upper triangle (the lower-triangle ratio can overflow float32
    # deep in a chain; it is zeroed explicitly)
    inv_d = nm.div(nm.df(sign), dabs_safe)
    R = nm.mul(Rn, _bcast_col(inv_d, Rn.hi.shape))
    n = Rn.hi.shape[-1]
    ar = torch.arange(n, device=M.hi.device)
    upper = ar[:, None] <= ar[None, :]
    ratio = nm.mul(_bcast_row(nm.df(sp_safe), R.hi.shape),
                   _bcast_col(inv_sp, R.hi.shape))
    ratio = nm.where(upper, ratio, nm.df(torch.zeros_like(ratio.hi)))
    R = nm.mul(R, ratio)
    inv_perm = torch.argsort(perm, dim=-1)
    R = nm.cmap(lambda c: _take_cols(c, inv_perm), R)
    L = nm.cmap(lambda c: c * sign[..., None, :], Q)
    d, e = _renorm_d(d, torch.zeros(d.hi.shape, dtype=torch.int32,
                                    device=M.hi.device), nm=nm)
    return LDRdf(L, d, R, e)


def mat_mul_ldr(B, F: LDRdf, nm=df32) -> LDRdf:
    """LDR of B @ F (the forward fold, stablelinalg.cpp:69-79) without
    materializing diag(d 2^e): the column scales of B L factor as
    (colmax|B L| d) 2^e and ride symbolically; the QR input is the
    colmax-equilibrated B L."""
    BL = nm.matmul(B, F.L)
    c = torch.amax(torch.abs(BL.hi), dim=-2)
    dead_in = (c == 0) | (F.d.hi == 0)
    cs = torch.where(dead_in, torch.ones_like(c), c)
    m = nm.mul(nm.df(cs), F.d)
    m, e = _renorm_d(m, F.e, nm=nm)
    m = nm.where(dead_in, nm.df(torch.ones_like(c)), m)
    e = torch.where(dead_in, torch.zeros_like(e), e)
    # descending-scale presort; the float32 key only orders columns
    t = e.float() + torch.log2(m.hi)
    t = torch.where(dead_in, -torch.inf, t)
    perm = torch.argsort(-t, dim=-1, stable=True)
    row_take = lambda v: torch.take_along_dim(v, perm, dim=-1)  # noqa: E731
    inv_c = nm.div(nm.df(torch.ones_like(cs)), nm.df(cs))
    Mn = nm.mul(BL, _bcast_row(inv_c, BL.hi.shape))
    Mn = nm.cmap(lambda v: _take_cols(v, perm), Mn)
    mp = nm.cmap(row_take, m)
    ep = row_take(e)
    deadp = row_take(dead_in)
    Q, Rn = _qr(Mn, nm=nm)
    dn = _diag(Rn)
    sign = torch.where(dn.hi < 0, -1.0, 1.0)
    dabs = nm.cmap(lambda cc: cc * sign, dn)
    dead = deadp | (dabs.hi == 0)
    dabs_safe = nm.where(dabs.hi == 0, nm.df(torch.ones_like(dabs.hi)),
                         dabs)
    d_new = nm.mul(dabs_safe, mp)
    d_new, e_new = _renorm_d(d_new, ep, nm=nm)
    d_new = nm.where(dead, nm.df(torch.zeros_like(d_new.hi)), d_new)
    e_new = torch.where(dead, torch.zeros_like(e_new), e_new)
    # R: rows rescaled by sign/|dn|, then un-equilibrated by (m_j / m_i)
    # 2^(e_j - e_i): a bounded multiword division and an exact ldexp
    inv_dn = nm.div(nm.df(sign), dabs_safe)
    R1 = nm.mul(Rn, _bcast_col(inv_dn, Rn.hi.shape))
    n = Rn.hi.shape[-1]
    ar = torch.arange(n, device=B.hi.device)
    upper = ar[:, None] <= ar[None, :]
    mr = nm.div(_bcast_row(mp, R1.hi.shape), _bcast_col(mp, R1.hi.shape))
    de = ep[..., None, :] - ep[..., :, None]
    ratio = nm.cmap(lambda cc: ldexp(cc, de), mr)
    ratio = nm.where(upper, ratio, nm.df(torch.zeros_like(ratio.hi)))
    R1 = nm.mul(R1, ratio)
    inv_perm = torch.argsort(perm, dim=-1)
    R1 = nm.cmap(lambda cc: _take_cols(cc, inv_perm), R1)
    L = nm.cmap(lambda cc: cc * sign[..., None, :], Q)
    R = nm.matmul(R1, F.R)
    return LDRdf(L, d_new, R, e_new)


_LN2 = 0.6931471805599453


def _split_scales(d, e: torch.Tensor, nm=df32):
    """Range-safe D_large / D_small split (stablelinalg.cpp:100):
    ``(inv_dl, ds, log_m, e_big)`` with inv_dl = 1 / max(d 2^e, 1) and
    ds = min(d 2^e, 1) linear multiwords, and log(D_large) summed exactly
    as sum(log_m) + ln2 sum(e_big).  A dead column (d = 0) goes small."""
    big = (e >= 0) & (d.hi > 0)
    one = nm.df(torch.ones_like(d.hi))
    ds = nm.where(big, one,
                  nm.cmap(lambda c: ldexp(c, torch.clamp(e, max=0)), d))
    d_safe = nm.where(big, d, one)
    inv_m = nm.div(one, d_safe)
    inv_dl = nm.where(
        big, nm.cmap(lambda c: ldexp(c, -torch.clamp(e, min=0)), inv_m),
        one)
    d64 = torch.where(big, nm.to_f64(d), torch.ones_like(d.hi.double()))
    log_m = torch.where(big, torch.log(d64), torch.zeros_like(d64))
    e_big = torch.where(big, e, torch.zeros_like(e))
    return inv_dl, ds, log_m, e_big


def _f32_qr(A: torch.Tensor):
    """K1 on CUDA (the JAX package's cgs2 mode on accelerators),
    Householder on the CPU."""
    if A.device.type == "cuda":
        from dqmc_tpu_torch.ops.qr_kernel import cgs2_qr
        return cgs2_qr(A)
    return torch.linalg.qr(A)


def _solve_refined(Mdf, Y, nm=df32, Yt=None):
    """X = M^{-1} Y and log|det M| via a float32 QR and multiword iterative
    refinement (3 steps for df32, 8 for tf32), returning the iterate with
    the smallest max|Y - M X| per system (the refinement amplifies the
    error once eps32 cond(M) >= 1; the best iterate bounds it at the seed).
    log|det M| = log|det R'| - log|det Q| with R' = Q^T M and Q^T Q = I + E
    in multiword (det Q is not 1 at float32 grade).

    ``Yt``: a second right-hand side solved against M^T with the same
    float32 factors (M^T x = y => x = Q R^{-T} y), refined against the
    multiword M^T -- the role-swapped solve of the unequal-time triplet.
    Returns (X, logabs, Xt) with it, (X, logabs) without."""
    n_ir = 3 if nm is df32 else 8
    Q, R = _f32_qr(Mdf.hi)
    QT32 = Q.transpose(-1, -2)

    def refine(M, rhs, solve):
        X = nm.df(solve(rhs.hi))
        best_X, best_n = X, None
        for k in range(n_ir + 1):
            r = nm.sub(rhs, nm.matmul(M, X))
            rn = torch.amax(torch.abs(r.hi), dim=(-2, -1), keepdim=True)
            if best_n is None:
                best_X, best_n = X, rn
            else:
                better = rn < best_n
                best_X = nm.cmap(lambda c, b: torch.where(better, c, b), X,
                                 best_X)
                best_n = torch.minimum(rn, best_n)
            if k < n_ir:
                X = nm.add(X, nm.df(solve(r.hi)))
        return best_X

    best_X = refine(Mdf, Y, lambda rhs32: torch.linalg.solve_triangular(
        R, QT32 @ rhs32, upper=True))
    Rref = nm.matmul(nm.df(QT32), Mdf)
    E_diag = _diag(nm.matmul(nm.df(QT32), nm.df(Q)))
    log_q = 0.5 * torch.sum(nm.to_f64(E_diag) - 1.0, dim=-1)
    logabs = torch.sum(torch.log(torch.abs(nm.to_f64(_diag(Rref)))),
                       dim=-1) - log_q
    if Yt is None:
        return best_X, logabs
    RT = R.transpose(-1, -2)
    Xt = refine(transpose(Mdf), Yt, lambda rhs32: Q @ (
        torch.linalg.solve_triangular(RT, rhs32, upper=False)))
    return best_X, logabs, Xt


def _middle_matrix(F1: LDRdf, F2t: LDRdf, nm=df32):
    """M = D1l^-1 (L1^T L2) D2l^-1 + D1s (R1 R2^T) D2s, range-safe, with
    the pieces every dag inverse assembles G from: the scale splits
    (d_small, 1 / d_large) of both factors and log(D1l D2l)."""
    inv_d1l, d1s, lm1, le1 = _split_scales(F1.d, F1.e, nm=nm)
    inv_d2l, d2s, lm2, le2 = _split_scales(F2t.d, F2t.e, nm=nm)
    L1T = transpose(F1.L)
    shape = L1T.hi.shape
    termA = nm.matmul(L1T, F2t.L)
    termA = nm.mul(termA, _bcast_col(inv_d1l, shape))
    termA = nm.mul(termA, _bcast_row(inv_d2l, shape))
    termB = nm.matmul(F1.R, transpose(F2t.R))
    termB = nm.mul(termB, _bcast_col(d1s, shape))
    termB = nm.mul(termB, _bcast_row(d2s, shape))
    M = nm.add(termA, termB)
    log_dl = (torch.sum(lm1, dim=-1) + torch.sum(lm2, dim=-1)
              + _LN2 * (torch.sum(le1, dim=-1)
                        + torch.sum(le2, dim=-1)).to(lm1.dtype))
    return M, L1T, (d1s, inv_d1l), (d2s, inv_d2l), log_dl


def inv_one_plus_ldr_dag(F1: LDRdf, F2t: LDRdf, nm=df32):
    """G = [I + F1 F2t^T]^{-1} and log|det|, multiword: the dag
    (transpose-suffix) formulation, G = (L2 / d2l) M^{-1} (L1^T / d1l)."""
    M, L1T, (_, inv_d1l), (_, inv_d2l), log_dl = _middle_matrix(F1, F2t,
                                                                 nm=nm)
    shape = L1T.hi.shape
    Y = nm.mul(L1T, _bcast_col(inv_d1l, shape))
    X, logabs = _solve_refined(M, Y, nm=nm)
    W2 = nm.mul(F2t.L, _bcast_row(inv_d2l, shape))
    return nm.matmul(W2, X), log_dl + logabs


def inv_triplet_dag(F1: LDRdf, F2t: LDRdf, nm=df32):
    """The unequal-time triplet at multiword grade (the twin of
    ``ops/linalg.inv_triplet_dag``), with B1 = F1 (normal form, B(tau, 0))
    and B2 = F2t_matrix^T (transpose form, B(beta, tau)):

        Gtt = [I + B1 B2]^{-1}         G = (L2/d2l) M^{-1} (L1^T/d1l)
        Gt0 = [B1^{-1} + B2]^{-1}      G = (L2/d2l) M^{-1} (D1s R1)
        G0t = -[B2^{-1} + B1]^{-1}     through M^T (the role swap)

    One float32 factorization of M serves all three: Gtt and Gt0 refine
    two stacked right-hand sides against M, G0t refines against M^T with
    the same factors.  Returns (Gtt, Gt0, G0t, log|det(I + B1 B2)|)."""
    M, L1T, (d1s, inv_d1l), (d2s, inv_d2l), log_dl = _middle_matrix(
        F1, F2t, nm=nm)
    shape = L1T.hi.shape
    n = shape[-1]
    Ytt = nm.mul(L1T, _bcast_col(inv_d1l, shape))
    Yt0 = nm.mul(F1.R, _bcast_col(d1s, shape))
    Y = nm.cmap(lambda a, b: torch.cat([a, b], dim=-1), Ytt, Yt0)
    Y0t = nm.mul(F2t.R, _bcast_col(d2s, shape))
    X, logabs, Xt = _solve_refined(M, Y, nm=nm, Yt=Y0t)
    W2 = nm.mul(F2t.L, _bcast_row(inv_d2l, shape))
    Gtt = nm.matmul(W2, nm.cmap(lambda c: c[..., :n], X))
    Gt0 = nm.matmul(W2, nm.cmap(lambda c: c[..., n:], X))
    W1 = nm.mul(F1.L, _bcast_row(inv_d1l, shape))
    G0t = transpose(nm.neg(nm.matmul(W1, Xt)))
    return Gtt, Gt0, G0t, log_dl + logabs
