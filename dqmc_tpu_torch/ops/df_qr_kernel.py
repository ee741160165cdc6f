"""The multiword CGS2 panel kernels (#7 df32, #8 tf32) and the df32
hybrid QR around #7.

PyTorch counterpart of ``dqmc_tpu/ops/df_qr_kernel.py``.  The df QR spends
its time in the sequential column loop of each 32-column panel, so that
loop is one kernel launch per panel (``csrc/mw_qr_panel.cu``, templated on
the word count and the digit-plane count); the panel-external projections
stay multiword Ozaki matmuls (``ops/df32.matmul``).

In-panel dot products are exact: each multiword row vector is scaled by a
power of two taken from the exponent bits of its max-abs hi and split into
NP signed 7-bit digit planes (``floor(x w + 0.5)``, the residual tracked in
multiword arithmetic); digit products accumulate exactly as integers and
recombine with power-of-two weights in multiword arithmetic, E over the
y planes first and then c over the q planes, each from high weight to low.
Projections run against the zero-initialized planes of the finished
columns, so unfinished columns contribute exactly zero.  R comes from the
process coefficients, its diagonal from the norm.

:func:`panel_plain` is the kernels' plain twin: torch ops in the kernel's
arithmetic and order (the digit-class sums as float64 products of the
integer planes), bit for bit.  A panel on a CUDA tensor launches the kernel
and a CPU panel runs the twin; nothing on the CUDA path calls the twin.
"""

from __future__ import annotations

import torch

from dqmc_tpu_torch import _cuda
from dqmc_tpu_torch.ops import df32
from dqmc_tpu_torch.ops.df32 import DF

_BLOCK = 32
_PBITS = 7
# the JAX package's gate (its bf16 class sums stay exact to n = 512); the
# kernels keep the finished columns' digit planes in shared memory
_MAX_N = 512


def _t(x):
    return type(x)(*(c.transpose(-1, -2) for c in x))


def _pow2_scales(m: torch.Tensor):
    """(s, inv_s): s = 2^(e+1) for m = f 2^e, f in [1, 2), both exact, from
    the exponent bits of float32 m >= 0; m = 0 or subnormal maps to 1."""
    e = (m.view(torch.int32) >> 23) & 0xFF
    s = ((e + 1) << 23).view(torch.float32)
    inv_s = ((253 - e) << 23).view(torch.float32)
    good = e > 0
    one = torch.ones_like(m)
    return torch.where(good, s, one), torch.where(good, inv_s, one)


def _extract_planes(v, nm, n_planes: int):
    """(planes [n_planes float32 digit tensors], s) along the last axis:
    v = s (sum_i p_i 2^-7(i+1) + r) with |v / s| < 1, so the first digit
    lies in [-128, 128] and the others in [-64, 64]."""
    mag = torch.amax(torch.abs(v.hi), dim=-1, keepdim=True)
    s, inv_s = _pow2_scales(mag)
    r = nm.cmap(lambda c: c * inv_s, v)              # exact
    planes = []
    for i in range(n_planes):
        w = float(2.0 ** (_PBITS * (i + 1)))
        inv_w = float(2.0 ** (-_PBITS * (i + 1)))
        q = torch.floor(r.hi * w + 0.5)
        planes.append(q)
        r = nm.sub(r, nm.df(q * inv_w))
    return planes, s


def _wsum(terms, w0_exp: int, nm):
    """nm sum of exact float32 terms[k] weighted 2^(w0_exp - 7k), high
    weight first."""
    acc = None
    for k, t in enumerate(terms):
        tk = nm.df(t * float(2.0 ** (w0_exp - _PBITS * k)))
        acc = tk if acc is None else nm.add(acc, tk)
    return acc


def _classes(D: torch.Tensor, n_planes: int):
    """float32 class sums sum_{i+j=w} D[:, i, j] (w < n_planes) of exact
    integer products D (B, NP, NP, ...)."""
    return [sum(D[:, i, w - i] for i in range(w + 1)).float()
            for w in range(n_planes)]


def panel_plain(P, nm):
    """Two-pass CGS of one externally orthogonalized panel (B, 32, n), the
    kernels' arithmetic in torch ops with nm.N_PLANES digit planes.
    Returns (Q (B, 32, n), Rg (B, 32, 32)) as nm tuples with Rg[b, t, u]
    the coefficient of q_u in column t (its diagonal the norm)."""
    n_planes = nm.N_PLANES
    B, block, n = P.hi.shape
    dev = P.hi.device
    Q = nm.cmap(torch.clone, nm.zeros((B, block, n), dev))
    Rg = nm.cmap(torch.clone, nm.zeros((B, block, block), dev))
    qplanes = torch.zeros((B, block, n_planes, n), dtype=torch.float64,
                          device=dev)
    sq = torch.ones((B, block), dtype=torch.float32, device=dev)
    one = torch.ones((B,), dtype=torch.float32, device=dev)
    for t in range(block):
        y = nm.cmap(lambda c: c[:, t, :], P)                   # (B, n)
        row = nm.zeros((B, block), dev)
        for _ in range(2):
            planes_y, s_y = _extract_planes(y, nm, n_planes)
            Y = torch.stack(planes_y, 1).double()              # (B, NP, n)
            # D[b, i, u, j] = <y plane i, q_u plane j>, exact
            D = torch.einsum("bik,bujk->biuj", Y, qplanes).float()
            E = _wsum([D[:, i] for i in range(n_planes)], -_PBITS, nm)
            c = None
            for j in range(n_planes):
                term = nm.cmap(lambda a: a[..., j]
                               * float(2.0 ** (-_PBITS * (j + 1))), E)
                c = term if c is None else nm.add(c, term)     # (B, 32)
            sy_sq = s_y * sq
            row = nm.add(row, nm.cmap(lambda a: a * sy_sq, c))
            sq2 = sq * sq
            e = nm.cmap(lambda a: a * sq2, c)
            planes_e, s_e = _extract_planes(e, nm, n_planes)
            Eh = torch.stack(planes_e, 1).double()             # (B, NP, 32)
            # cls[w][b, k] = sum_{i+j=w} sum_u ehat_i[u] q_u plane j [k]
            Dc = torch.einsum("biu,bujk->bijk", Eh, qplanes)
            delta = _wsum(_classes(Dc, n_planes), -2 * _PBITS, nm)
            se_sy = s_e * s_y
            y = nm.sub(y, nm.cmap(lambda a: a * se_sy, delta))
        # norm^2 from y's digit planes (exact class products)
        planes_y, s_y = _extract_planes(y, nm, n_planes)
        Y = torch.stack(planes_y, 1).double()
        Dn = torch.einsum("bik,bjk->bij", Y, Y)
        nrm2 = _wsum(_classes(Dn, n_planes), -2 * _PBITS, nm)
        sy2 = (s_y * s_y)[:, 0]
        nrm = nm.sqrt(nm.cmap(lambda a: a * sy2, nrm2))        # (B,)
        zero = nrm.hi == 0
        inv = nm.div(nm.df(one), nm.where(zero, nm.df(one), nrm))
        q = nm.mul(y, nm.cmap(lambda a: a[:, None], inv))
        q = nm.cmap(lambda a: torch.where(zero[:, None],
                                          torch.zeros_like(a), a), q)
        planes_q, s_q = _extract_planes(q, nm, n_planes)
        qplanes[:, t] = torch.stack(planes_q, 1).double()
        sq[:, t] = s_q[:, 0]
        diag = torch.arange(block, device=dev) == t
        row = nm.where(diag, nm.cmap(lambda a: a[:, None].expand(B, block),
                                     nrm), row)
        for qo, v in zip(Q, q):
            qo[:, t] = v
        for ro, v in zip(Rg, row):
            ro[:, t] = v
    return Q, Rg


def panel_cuda(P, words: int):
    """Launch the panel kernel (#7 for words = 2, #8 for 3) on a flat CUDA
    batch P (B, 32, n)."""
    B, block, n = P.hi.shape
    if block != _BLOCK or n % _BLOCK or n > _MAX_N:
        raise ValueError(f"multiword panel kernel: (B, 32, n) with n a "
                         f"multiple of 32 and <= {_MAX_N}, not "
                         f"{tuple(P.hi.shape)}")
    dev = P.hi.device
    for c in P:
        _cuda.check(c, "P", device=dev, dtype=torch.float32,
                    shape=(B, block, n))
    p = torch.stack(tuple(P)).contiguous()
    q = torch.empty_like(p)
    r = torch.empty((words, B, block, block), dtype=torch.float32,
                    device=dev)
    name = {2: "df_qr_panel", 3: "tf_qr_panel"}[words]
    _cuda.launch(name, "dqmc_" + name, dev, _cuda.ptr(p), _cuda.ptr(q),
                 _cuda.ptr(r), B, n, _cuda.stream(dev))
    return type(P)(*q.unbind(0)), type(P)(*r.unbind(0))


def panel_call(P, nm):
    """(Q, Rg) of one externally orthogonalized panel (.., 32, n): the
    kernel on CUDA tensors, the plain twin on CPU tensors."""
    lead = P.hi.shape[:-2]
    block, n = P.hi.shape[-2:]
    flat = nm.cmap(lambda c: c.reshape((-1, block, n)).contiguous(), P)
    if P.hi.device.type == "cuda":
        Q, Rg = panel_cuda(flat, len(P))
    elif P.hi.device.type == "cpu":
        Q, Rg = panel_plain(flat, nm)
    else:
        raise ValueError(f"multiword panel: unsupported device "
                         f"{P.hi.device}")
    return (nm.cmap(lambda c: c.reshape(lead + (block, n)), Q),
            nm.cmap(lambda c: c.reshape(lead + (block, block)), Rg))


def kernel_shape(n: int) -> bool:
    """The JAX package's gate for the panel-kernel path."""
    return n % _BLOCK == 0 and n <= _MAX_N


def df_qr_hybrid(A: DF):
    """(Q, R) of a df batch (..., n, n): external CGS2 in df32 matmuls and
    one panel kernel per 32-column panel, in the rolled form the JAX package
    runs by default (``_df_qr_hybrid_loop``): every panel projects against
    the full row buffer with its unfinished rows zeroed (exact zeros through
    the digit-plane matmul), panel 0 included.  Shapes outside
    :func:`kernel_shape` take ``ops/df_qr.df_qr``, as in JAX."""
    n = A.hi.shape[-1]
    if not kernel_shape(n):
        from dqmc_tpu_torch.ops.df_qr import df_qr
        return df_qr(A)
    dev = A.hi.device
    batch = A.hi.shape[:-2]
    QT = df32.cmap(lambda c: c.transpose(-1, -2).clone(), A)
    rt = df32.cmap(torch.clone, df32.zeros(batch + (n, n), dev))
    ridx = torch.arange(n, device=dev)[:, None]
    for p in range(0, n, _BLOCK):
        P = df32.cmap(lambda c: c[..., p:p + _BLOCK, :], QT)
        done = ridx < p
        Qd = df32.cmap(lambda c: torch.where(done, c, torch.zeros_like(c)),
                       QT)
        C_tot = df32.zeros(batch + (_BLOCK, n), dev)
        for _ in range(2):
            C = df32.matmul(P, _t(Qd))
            P = df32.sub(P, df32.matmul(C, Qd))
            # component-wise, as the JAX loop's accumulation
            C_tot = DF(C_tot.hi + C.hi, C_tot.lo + C.lo)
        Q, Rg = panel_call(P, df32)
        for qt, v in zip(QT, Q):
            qt[..., p:p + _BLOCK, :] = v
        for r, c, g in zip(rt, C_tot, Rg):
            r[..., p:p + _BLOCK, :] = c
            r[..., p:p + _BLOCK, p:p + _BLOCK] = g
    return _t(QT), _t(rt)
