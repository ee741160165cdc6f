"""Multiword CGS2 QR: the plain path of the multiword stabilization chain.

PyTorch counterpart of ``dqmc_tpu/ops/df_qr.py``, generic over the
numerics module ``nm`` (``ops/df32.py`` or ``ops/tf32.py``).  Classical
Gram-Schmidt with reorthogonalization carried in multiword arithmetic:
32-column panels, two panel-external projection passes (multiword Ozaki
matmuls), then a column loop inside the panel whose projections run
against a zero-initialized buffer of the finished columns (unfinished rows
are exact zeros, so they neither contribute nor widen the digit-plane
scales).  Everything runs on A^T and R is accumulated transposed.

This is the path on the CPU (as the JAX package's ``xla`` mode there) and
for shapes outside the panel kernels' gate (``ops/df_qr_kernel.py``).
"""

from __future__ import annotations

import torch

from dqmc_tpu_torch.ops import df32

_BLOCK = 32


def _t(x):
    return type(x)(*(c.transpose(-1, -2) for c in x))


def _rows(x, a, b):
    return type(x)(*(c[..., a:b, :] for c in x))


def df_qr(A, nm=df32):
    """(Q, R) with A = Q R to nm's floor columnwise, Q nm-orthonormal, R
    upper triangular.  A: (..., n, n) multiword tuple; n not a multiple of
    the 32-column panel runs as one full-width panel."""
    n = A.hi.shape[-1]
    dev = A.hi.device
    block = _BLOCK if n % _BLOCK == 0 else n
    QT = nm.cmap(lambda c: c.transpose(-1, -2).clone(), A)
    batch = A.hi.shape[:-2]
    rt = nm.cmap(torch.clone, nm.zeros(batch + (n, n), dev))
    col_ids = torch.arange(block, device=dev)
    one = torch.ones(batch, dtype=torch.float32, device=dev)

    for p in range(0, n, block):
        # panel-external orthogonalization, twice (CGS2)
        for _ in range(2 if p else 0):
            P = _rows(QT, p, p + block)
            Qdone = _rows(QT, 0, p)
            C = nm.matmul(P, _t(Qdone))                # (.., block, p)
            P = nm.sub(P, nm.matmul(C, Qdone))
            for q, v in zip(QT, P):
                q[..., p:p + block, :] = v
            for r, c in zip(rt, C):
                r[..., p:p + block, 0:p] += c
        # in-panel two-pass CGS against the finished columns
        P0 = _rows(QT, p, p + block)
        Qfin = nm.cmap(torch.clone, nm.zeros(batch + (block, n), dev))
        rg = nm.cmap(torch.clone, nm.zeros(batch + (block, block), dev))
        for t in range(block):
            y = _rows(P0, t, t + 1)                    # (.., 1, n)
            row = nm.zeros(batch + (1, block), dev)
            for _ in range(2):
                c = nm.matmul(y, _t(Qfin))             # (.., 1, block)
                y = nm.sub(y, nm.matmul(c, Qfin))
                row = nm.add(row, c)
            nrm2 = nm.matmul(y, _t(y))                 # (.., 1, 1)
            nrm = nm.sqrt(nm.cmap(lambda a: a[..., 0, 0], nrm2))
            safe = nm.where(nrm.hi == 0, nm.df(one), nrm)
            inv = nm.div(nm.df(one), safe)
            q = nm.mul(y, nm.cmap(lambda a: a[..., None, None], inv))
            for f, v in zip(Qfin, q):
                f[..., t:t + 1, :] = v
            diag = (col_ids == t).expand(row.hi.shape)
            row = nm.where(diag, nm.cmap(
                lambda a: a[..., None, None].expand(row.hi.shape), nrm), row)
            for g, v in zip(rg, row):
                g[..., t:t + 1, :] = v
        for q, v in zip(QT, Qfin):
            q[..., p:p + block, :] = v
        for r, g in zip(rt, rg):
            r[..., p:p + block, p:p + block] = g
    return _t(QT), _t(rt)
