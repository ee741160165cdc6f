"""The triple-float32 hybrid QR around panel kernel #8.

PyTorch counterpart of ``dqmc_tpu/ops/tf_qr_kernel.py``: the tf32 twin of
``ops/df_qr_kernel.py`` (read that module for the design) with 10 digit
planes and triple-word arithmetic.  The panel kernel is the same CUDA
source, instantiated for three words and 10 planes; its plain twin is
``df_qr_kernel.panel_plain`` with ``nm = tf32``.
"""

from __future__ import annotations

from dqmc_tpu_torch.ops import tf32
from dqmc_tpu_torch.ops.df_qr_kernel import _BLOCK, _t, kernel_shape, \
    panel_call


def tf_qr_hybrid(A):
    """(Q, R) of a tf batch (..., n, n): external CGS2 in tf32 matmuls and
    one panel kernel per panel, unrolled as in the JAX package (the
    projections of panel p run against the p finished rows; panel 0 has
    none).  Shapes outside ``kernel_shape`` take ``ops/df_qr.df_qr``."""
    n = A.hi.shape[-1]
    if not kernel_shape(n):
        from dqmc_tpu_torch.ops.df_qr import df_qr
        return df_qr(A, nm=tf32)
    dev = A.hi.device
    QT = tf32.cmap(lambda c: c.transpose(-1, -2).clone(), A)
    rt = tf32.cmap(lambda c: c.clone(),
                   tf32.zeros(A.hi.shape[:-2] + (n, n), dev))
    for p in range(0, n, _BLOCK):
        P = tf32.cmap(lambda c: c[..., p:p + _BLOCK, :], QT)
        if p:
            Qdone = tf32.cmap(lambda c: c[..., :p, :], QT)
            for _ in range(2):
                C = tf32.matmul(P, _t(Qdone))
                P = tf32.sub(P, tf32.matmul(C, Qdone))
                for r, c in zip(rt, C):
                    r[..., p:p + _BLOCK, :p] += c
        Q, Rg = panel_call(P, tf32)
        for qt, v in zip(QT, Q):
            qt[..., p:p + _BLOCK, :] = v
        for r, g in zip(rt, Rg):
            r[..., p:p + _BLOCK, p:p + _BLOCK] = g
    return _t(QT), _t(rt)
