"""Triple-float32 arithmetic (named "tf32" after the JAX package's key;
not NVIDIA's TensorFloat-32): ~72-bit significands from triples of float32.

PyTorch counterpart of ``dqmc_tpu/ops/tf32.py``.  ``TF(hi, mi, lo)`` holds
value = hi + mi + lo ("sloppy" triple-word normalization: the components
may overlap by a few bits).  Same design and module protocol as
``ops/df32.py``: the error-free transformation chains as separate torch
ops in the JAX module's order, and the integer Ozaki ``matmul`` with 10
digit planes (70 plane bits).  The triple tier is the measurement-grade
Green's-function rebuild (``engine/parity.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dqmc_tpu_torch.ops.df32 import ozaki_matmul, sqrt32, two_prod, two_sum


class TF(NamedTuple):
    """float32 triple: value = hi + mi + lo exactly."""
    hi: torch.Tensor
    mi: torch.Tensor
    lo: torch.Tensor


def cmap(f, *xs) -> TF:
    """Apply a structural (value-preserving) tensor op to each component."""
    return TF(*(f(*parts) for parts in zip(*xs)))


def df(hi) -> TF:
    """The triple of a plain float32 value (named ``df`` for the df32
    protocol)."""
    hi = torch.as_tensor(hi, dtype=torch.float32)
    z = torch.zeros_like(hi)
    return TF(hi, z, z)


def zeros(shape, device="cpu") -> TF:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return TF(z, z, z)


def from_f64(x: torch.Tensor) -> TF:
    """Exact float64 -> tf32 conversion (53 significand bits <= 72)."""
    hi = x.float()
    r = x - hi.double()
    mi = r.float()
    return TF(hi, mi, (r - mi.double()).float())


def to_f64(x: TF) -> torch.Tensor:
    return x.hi.double() + x.mi.double() + x.lo.double()


def _renorm(t0, t1, t2, *rest):
    """Triple from a decreasing-magnitude term list."""
    for r in rest:
        t2 = t2 + r
    s, e1 = two_sum(t0, t1)
    e1, e2 = two_sum(e1, t2)
    s, c = two_sum(s, e1)
    return TF(s, *two_sum(c, e2))


def add(x: TF, y: TF) -> TF:
    s0, e0 = two_sum(x.hi, y.hi)
    s1, e1 = two_sum(x.mi, y.mi)
    t1, f1 = two_sum(e0, s1)
    t2 = (e1 + f1) + (x.lo + y.lo)
    return _renorm(s0, t1, t2)


def neg(x: TF) -> TF:
    return TF(-x.hi, -x.mi, -x.lo)


def sub(x: TF, y: TF) -> TF:
    return add(x, neg(y))


def add_f32(x: TF, c) -> TF:
    s0, e0 = two_sum(x.hi, c)
    t1, f1 = two_sum(e0, x.mi)
    return _renorm(s0, t1, f1 + x.lo)


def mul(x: TF, y: TF) -> TF:
    p0, e0 = two_prod(x.hi, y.hi)
    p1, e1 = two_prod(x.hi, y.mi)
    p2, e2 = two_prod(x.mi, y.hi)
    p3 = (x.mi * y.mi + (e1 + e2)) + (x.hi * y.lo + x.lo * y.hi)
    t1, f1 = two_sum(p1, p2)
    t1, f2 = two_sum(e0, t1)
    return _renorm(p0, t1, p3 + f1 + f2)


def mul_f32(x: TF, c) -> TF:
    p0, e0 = two_prod(x.hi, c)
    p1, e1 = two_prod(x.mi, c)
    t1, f1 = two_sum(e0, p1)
    return _renorm(p0, t1, (e1 + f1) + x.lo * c)


def mul_pow2(x: TF, c) -> TF:
    """Multiply by a power of two (exact)."""
    return TF(x.hi * c, x.mi * c, x.lo * c)


def div(x: TF, y: TF) -> TF:
    """Long division: three float32 quotient digits and one correction."""
    q0 = x.hi / y.hi
    r = sub(x, mul_f32(y, q0))
    q1 = r.hi / y.hi
    r = sub(r, mul_f32(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul_f32(y, q2))
    q3 = r.hi / y.hi
    return _renorm(q0, q1, q2, q3)


def sqrt(x: TF) -> TF:
    """sqrt via two triple-word Newton corrections of the float32 root."""
    q0 = sqrt32(x.hi)
    safe = torch.where(q0 == 0, torch.ones_like(q0), q0)
    p, e = two_prod(q0, q0)
    r = sub(x, TF(p, e, torch.zeros_like(p)))
    q1 = r.hi / (2.0 * safe)
    y = _renorm(q0, q1, torch.zeros_like(q0))
    r = sub(x, mul(y, y))
    q2 = r.hi / (2.0 * safe)
    out = _renorm(q0, q1, q2)
    zero = q0 == 0
    return cmap(lambda a: torch.where(zero, torch.zeros_like(a), a), out)


def abs_(x: TF) -> TF:
    neg_mask = x.hi < 0
    return cmap(lambda a: torch.where(neg_mask, -a, a), x)


def lt(x: TF, y: TF):
    return ((x.hi < y.hi)
            | ((x.hi == y.hi) & (x.mi < y.mi))
            | ((x.hi == y.hi) & (x.mi == y.mi) & (x.lo < y.lo)))


def where(mask, x: TF, y: TF) -> TF:
    return cmap(lambda a, b: torch.where(mask, a, b), x, y)


N_PLANES = 10


def matmul(a: TF, b: TF, n_planes: int = N_PLANES) -> TF:
    """tf32 (..., m, k) @ (..., k, n) -> (..., m, n), ~2^-68 relative to
    the row/column magnitudes (10 digit planes); leading axes broadcast."""
    from dqmc_tpu_torch.ops import tf32
    return ozaki_matmul(a, b, n_planes, tf32)
