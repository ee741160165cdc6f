"""Batched CGS2 QR factorization: the CUDA kernel K1 and its plain twin.

PyTorch counterpart of ``dqmc_tpu/ops/qr_kernel.py``.  Classical
Gram-Schmidt with reorthogonalization is columnwise stable like Householder
("twice is enough") and is built from dot products.  The factorization runs
in 32-column panels: each panel gets two block projection passes against the
finished columns, then each of its columns two passes against the earlier
columns of the panel; R is accumulated from the coefficients of both passes
and its diagonal is the column norm (>= 0).  ``cgs2_qr_inv`` also returns
W = R^{-1}, built blockwise per panel as the TPU kernel builds it (the
diagonal block's inverse, then one cross-panel product), associated as the
block column of R W = I.

On a CUDA tensor :func:`_cgs2_qr_impl` launches the hand-written kernel in
``csrc/cgs2_qr.cu``; on a CPU tensor it runs :func:`cgs2_qr_plain`, the
same algorithm in plain torch ops.  Sizes that are not a multiple of the
panel are padded exactly with an identity block (see :func:`cgs2_qr`).
"""

from __future__ import annotations

import torch

from dqmc_tpu_torch import _cuda

_BLOCK = 32
# the kernel stages a 32-row panel (32 n elements) in shared memory: at most
# a block's 232,448 bytes in float32 (csrc/cgs2_qr.cu launch_cgs2)
_MAX_N = {torch.float32: 1728, torch.float64: 512}


def diag_block_inverse(Rpp: torch.Tensor) -> torch.Tensor:
    """S = Rpp^{-1} of a batch of upper-triangular (B, 32, 32) diagonal
    blocks by back substitution, Rpp S = I, row by row from the last (a
    zero pivot divides by 1, as the kernel does)."""
    B, m, _ = Rpp.shape
    d = torch.diagonal(Rpp, dim1=-2, dim2=-1)
    safe = torch.where(d == 0, torch.ones_like(d), d)
    eye = torch.eye(m, dtype=Rpp.dtype, device=Rpp.device)
    S = torch.zeros_like(Rpp)
    for i in range(m - 1, -1, -1):
        acc = eye[i] - torch.einsum("bl,blj->bj", Rpp[:, i, i + 1:],
                                    S[:, i + 1:, :])
        S[:, i, :] = acc / safe[:, i, None]
    return S


def cgs2_qr_plain(A: torch.Tensor, with_inv: bool = False):
    """(Q, R[, R^{-1}]) of a flat batch A (B, n, n), n a multiple of 32, in
    plain torch ops: the kernel's algorithm step for step, R^{-1} blockwise
    (each panel's diagonal-block inverse S, then
    W[:p0, P] = -W[:p0, :p0] (R[:p0, P] S))."""
    B, n, _ = A.shape
    QT = A.transpose(-1, -2).clone()           # rows = columns of A
    R = torch.zeros_like(A)
    W = torch.zeros_like(A) if with_inv else None
    for p0 in range(0, n, _BLOCK):
        pan = slice(p0, p0 + _BLOCK)
        P = QT[:, pan, :].clone()
        if p0:
            Qd = QT[:, :p0, :]
            for _ in range(2):                 # classical block passes
                C = P @ Qd.transpose(-1, -2)   # (B, 32, p0)
                P = P - C @ Qd
                R[:, :p0, pan] += C.transpose(-1, -2)
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
        QT[:, pan, :] = P
        if with_inv:
            S = diag_block_inverse(R[:, pan, pan])
            W[:, pan, pan] = S
            if p0:
                X = R[:, :p0, pan] @ S
                W[:, :p0, pan] = -(W[:, :p0, :p0] @ X)
    Q = QT.transpose(-1, -2)
    return (Q, R, W) if with_inv else (Q, R)


def _cgs2_qr_cuda(A: torch.Tensor, with_inv: bool):
    """Launch K1 on a flat CUDA batch A (B, n, n): one C call, which issues
    the kernel's per-panel launches on the current stream."""
    B, n, _ = A.shape
    max_n = _MAX_N.get(A.dtype, 0)
    if n % _BLOCK or n > max_n:
        raise ValueError(f"cgs2_qr kernel: n={n} must be a multiple of "
                         f"{_BLOCK} and <= {max_n} for {A.dtype} (ROADMAP "
                         f"queue 2, item 2: K1 past n = {max_n})")
    _cuda.check(A, "A", device=A.device, dtype=A.dtype, shape=(B, n, n))
    sfx = _cuda.suffix(A.dtype)
    at = A.transpose(-1, -2).contiguous()
    qt = torch.empty_like(at)
    r = torch.empty_like(at)
    rinv = torch.empty_like(at) if with_inv else None
    work = torch.empty((_cuda.lib().dqmc_cgs2_workspace(B, n),),
                       dtype=A.dtype, device=A.device)
    _cuda.launch("cgs2_qr", "dqmc_cgs2_qr" + sfx, A.device,
                 _cuda.ptr(at), _cuda.ptr(qt), _cuda.ptr(r), _cuda.ptr(rinv),
                 _cuda.ptr(work), B, n, _cuda.stream(A.device))
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
