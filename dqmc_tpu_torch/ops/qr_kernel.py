"""Batched CGS2 QR factorization: the CUDA kernel K1 and its plain twin.

PyTorch counterpart of ``dqmc_tpu/ops/qr_kernel.py``.  Classical
Gram-Schmidt with reorthogonalization is columnwise stable like Householder
("twice is enough") and is built from dot products.  The factorization runs
in 32-column panels: each panel gets two block projection passes against the
finished columns, then each of its columns two passes against the earlier
columns of the panel; R is accumulated from the coefficients of both passes
and its diagonal is the column norm (>= 0).  ``cgs2_qr_inv`` also returns
W = R^{-1}.

On a CUDA tensor :func:`_cgs2_qr_impl` launches the hand-written kernel in
``csrc/cgs2_qr.cu``; on a CPU tensor it runs :func:`cgs2_qr_plain`, the
same algorithm in plain torch ops.  Sizes that are not a multiple of the
panel are padded exactly with an identity block (see :func:`cgs2_qr`).
"""

from __future__ import annotations

import torch

from dqmc_tpu_torch import _cuda

_BLOCK = 32
_MAX_N = 512


def cgs2_qr_plain(A: torch.Tensor, with_inv: bool = False):
    """(Q, R[, R^{-1}]) of a flat batch A (B, n, n), n a multiple of 32, in
    plain torch ops: the kernel's algorithm step for step."""
    B, n, _ = A.shape
    QT = A.transpose(-1, -2).clone()           # rows = columns of A
    R = torch.zeros_like(A)
    for p0 in range(0, n, _BLOCK):
        P = QT[:, p0:p0 + _BLOCK, :].clone()
        if p0:
            Qd = QT[:, :p0, :]
            for _ in range(2):                 # classical block passes
                C = P @ Qd.transpose(-1, -2)   # (B, 32, p0)
                P = P - C @ Qd
                R[:, :p0, p0:p0 + _BLOCK] += C.transpose(-1, -2)
        for t in range(_BLOCK):
            y = P[:, t, :]
            prev = P[:, :t, :]
            coef = torch.zeros((B, t), dtype=A.dtype, device=A.device)
            for _ in range(2):
                c = torch.einsum("bsk,bk->bs", prev, y)
                y = y - torch.einsum("bs,bsk->bk", c, prev)
                coef = coef + c
            nrm = torch.sqrt(torch.sum(y * y, dim=-1))
            safe = torch.where(nrm == 0, torch.ones_like(nrm), nrm)
            P[:, t, :] = y / safe[:, None]
            R[:, p0:p0 + t, p0 + t] = coef
            R[:, p0 + t, p0 + t] = nrm
        QT[:, p0:p0 + _BLOCK, :] = P
    Q = QT.transpose(-1, -2)
    if not with_inv:
        return Q, R
    diag = torch.diagonal(R, dim1=-2, dim2=-1)
    R_safe = R + torch.diag_embed(torch.where(diag == 0,
                                              torch.ones_like(diag),
                                              torch.zeros_like(diag)))
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(B, n, n)
    W = torch.linalg.solve_triangular(R_safe, eye, upper=True)
    return Q, R, W


def _cgs2_qr_cuda(A: torch.Tensor, with_inv: bool):
    """Launch K1 on a flat CUDA batch A (B, n, n)."""
    B, n, _ = A.shape
    if n % _BLOCK or n > _MAX_N:
        raise ValueError(f"cgs2_qr kernel: n={n} must be a multiple of "
                         f"{_BLOCK} and <= {_MAX_N}")
    _cuda.check(A, "A", device=A.device, dtype=A.dtype, shape=(B, n, n))
    sfx = _cuda.suffix(A.dtype)
    at = A.transpose(-1, -2).contiguous()
    qt = torch.empty_like(at)
    r = torch.empty_like(at)
    rinv = torch.empty_like(at) if with_inv else None
    cbuf = torch.empty((B, _BLOCK, n), dtype=A.dtype, device=A.device)
    _cuda.launch("cgs2_qr", "dqmc_cgs2_qr" + sfx, A.device,
                 _cuda.ptr(at), _cuda.ptr(qt), _cuda.ptr(r), _cuda.ptr(rinv),
                 _cuda.ptr(cbuf), B, n, _cuda.stream(A.device))
    Q = qt.transpose(-1, -2)
    return (Q, r, rinv) if with_inv else (Q, r)


def _cgs2_qr_impl(A: torch.Tensor, with_inv: bool = False):
    """(Q, R[, R^{-1}]) for a flat batch A (B, n, n); n a multiple of 32.
    The kernel on a CUDA tensor, the plain twin on a CPU tensor."""
    if A.device.type == "cuda":
        return _cgs2_qr_cuda(A.contiguous(), with_inv)
    if A.device.type == "cpu":
        return cgs2_qr_plain(A, with_inv)
    raise ValueError(f"cgs2_qr: unsupported device {A.device}")


def padded_qr(A: torch.Tensor, with_inv: bool, impl=None):
    """Exact identity padding to a multiple of the panel:
    qr([[A,0],[0,I]]) = ([[Qa,0],[0,I]], [[Ra,0],[0,I]]) (and the padded
    R^{-1} is block diagonal), so the unpadded factors are read straight off
    the padded ones.  ``impl`` factors the flat padded batch (default: the
    kernel on CUDA, the twin on the CPU)."""
    n = A.shape[-1]
    if A.shape[-2] != n:
        raise ValueError("cgs2_qr: square matrices only")
    lead = A.shape[:-2]
    pad = (-n) % _BLOCK
    np_ = n + pad
    Ap = A.reshape((-1, n, n))
    if pad:
        Ap = torch.nn.functional.pad(Ap, (0, pad, 0, pad))
        idx = torch.arange(n, np_, device=A.device)
        Ap[:, idx, idx] = 1.0
    out = (impl or _cgs2_qr_impl)(Ap, with_inv)
    return tuple(x[:, :n, :n].reshape(lead + (n, n)) for x in out)


def cgs2_qr(A: torch.Tensor):
    """Batched (Q, R) of square matrices of any size (leading axes kept)."""
    return padded_qr(A, False)


def cgs2_qr_inv(A: torch.Tensor):
    """Batched (Q, R, R^{-1}): the stabilized solve becomes two products,
    X = R^{-1} (Q^T Y), with no triangular solve."""
    return padded_qr(A, True)
