"""Double-float32 ("df32") arithmetic: ~49-bit significands from pairs of
float32 values.

PyTorch counterpart of ``dqmc_tpu/ops/df32.py``.  A ``DF(hi, lo)`` holds
value = hi + lo with |lo| <= ulp(hi)/2; every function is shape-polymorphic
and works on any device.

- Elementwise: the error-free transformations (Knuth two_sum, Dekker /
  Veltkamp two_prod) as separate torch ops, in the JAX module's order, so
  both packages round identically.  PyTorch runs each op as its own kernel
  and never contracts a multiply and an add into an FMA, which would break
  the transformations.  No fused torch op (addcmul, addmm, lerp, add with
  ``alpha=``) appears here.
- ``matmul``: the integer Ozaki scheme.  Rows of the left and columns of
  the right operand are scaled by powers of two and split into N_PLANES
  signed 7-bit digit planes; the digit products of each weight class are
  summed exactly, converted to float32 (rounding as JAX's int32 -> float32
  conversion) and recombined in df arithmetic from high weight to low.
  The plane products run as float64 matmuls of the integer planes, exact
  on either device (every partial sum is an integer below 2^53).

The numerics-module protocol (``cmap``, ``zeros``, ``df``, ``from_f64``,
``to_f64`` and the arithmetic) is shared with ``ops/tf32.py``, so the
multiword linear algebra takes either module as its ``nm``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DF(NamedTuple):
    """Non-overlapping float32 pair: value = hi + lo exactly."""
    hi: torch.Tensor
    lo: torch.Tensor


def cmap(f, *xs) -> DF:
    """Apply a structural (value-preserving) tensor op to each component."""
    return DF(*(f(*parts) for parts in zip(*xs)))


def zeros(shape, device="cpu") -> DF:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return DF(z, z)


# ----------------------------------------------------------------------
# exact powers of two
# ----------------------------------------------------------------------

def exp2i(k: torch.Tensor) -> torch.Tensor:
    """2^k as float64 for integer k, exact (k clamped to [-1022, 1023]),
    built from the exponent bits (torch.ldexp goes through pow)."""
    k = torch.clamp(k.to(torch.int64), -1022, 1023)
    return ((k + 1023) << 52).view(torch.float64)


def ldexp(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x * 2^k rounded once to float32 (exact while the result is a normal
    float32), for float32 x and an integer tensor k."""
    return (x.double() * exp2i(k)).float()


# ----------------------------------------------------------------------
# error-free transformations
# ----------------------------------------------------------------------

def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt (through float64: PyTorch's float32
    sqrt on the CPU may miss the IEEE result by one ulp)."""
    return torch.sqrt(x.double()).float()


def two_sum(a, b):
    """s + e == a + b exactly, s = fl(a + b) (Knuth, 6 ops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def quick_two_sum(a, b):
    """two_sum under the precondition |a| >= |b| (3 ops)."""
    s = a + b
    e = b - (s - a)
    return s, e


_SPLITTER = 4097.0        # 2^12 + 1 for float32's 24-bit significand


def veltkamp_split(a):
    """a == hi + lo with hi, lo carrying <= 12 significant bits each."""
    t = _SPLITTER * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly, p = fl(a * b) (Dekker, no FMA)."""
    p = a * b
    ah, al = veltkamp_split(a)
    bh, bl = veltkamp_split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


# ----------------------------------------------------------------------
# df32 arithmetic
# ----------------------------------------------------------------------

def df(hi) -> DF:
    """The pair of a plain float32 value (lo = 0)."""
    hi = torch.as_tensor(hi, dtype=torch.float32)
    return DF(hi, torch.zeros_like(hi))


def from_f64(x: torch.Tensor) -> DF:
    """Exact float64 -> df32 conversion (up to df32's 49-bit significand)."""
    hi = x.float()
    return DF(hi, (x - hi.double()).float())


def to_f64(x: DF) -> torch.Tensor:
    return x.hi.double() + x.lo.double()


def add(x: DF, y: DF) -> DF:
    """Accurate df + df (Dekker add2)."""
    s, e = two_sum(x.hi, y.hi)
    t, f = two_sum(x.lo, y.lo)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return DF(*quick_two_sum(s, e))


def add_f32(x: DF, c) -> DF:
    s, e = two_sum(x.hi, c)
    e = e + x.lo
    return DF(*quick_two_sum(s, e))


def neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def sub(x: DF, y: DF) -> DF:
    return add(x, neg(y))


def mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    return DF(*quick_two_sum(p, e))


def mul_f32(x: DF, c) -> DF:
    p, e = two_prod(x.hi, c)
    e = e + x.lo * c
    return DF(*quick_two_sum(p, e))


def mul_pow2(x: DF, c) -> DF:
    """df * power of two (exact)."""
    return DF(x.hi * c, x.lo * c)


def div(x: DF, y: DF) -> DF:
    """df / df: long division with two corrections."""
    q1 = x.hi / y.hi
    r = sub(x, mul_f32(y, q1))
    q2 = r.hi / y.hi
    r = sub(r, mul_f32(y, q2))
    q3 = r.hi / y.hi
    s, e = quick_two_sum(q1, q2)
    return add_f32(DF(s, e), q3)


def sqrt(x: DF) -> DF:
    """sqrt(df): one Newton step off the float32 root."""
    q1 = sqrt32(x.hi)
    p, e = two_prod(q1, q1)
    r = sub(x, DF(p, e))
    safe = torch.where(q1 == 0, torch.ones_like(q1), q1)
    q2 = r.hi / (2.0 * safe)
    out = DF(*quick_two_sum(q1, q2))
    zero = q1 == 0
    return DF(torch.where(zero, torch.zeros_like(q1), out.hi),
              torch.where(zero, torch.zeros_like(q1), out.lo))


def abs_(x: DF) -> DF:
    neg_mask = x.hi < 0
    return DF(torch.where(neg_mask, -x.hi, x.hi),
              torch.where(neg_mask, -x.lo, x.lo))


def lt(x: DF, y: DF):
    return (x.hi < y.hi) | ((x.hi == y.hi) & (x.lo < y.lo))


def where(mask, x: DF, y: DF) -> DF:
    return DF(torch.where(mask, x.hi, y.hi), torch.where(mask, x.lo, y.lo))


# ----------------------------------------------------------------------
# matmul: the integer Ozaki digit-plane scheme
# ----------------------------------------------------------------------

N_PLANES = 7
PLANE_BITS = 7


def digit_planes(v, dim: int, n_planes: int, nm):
    """(planes (n_planes, ...) float32 integers in [-64, 64], scale s): v =
    s * sum_i planes[i] 2^-7(i+1) up to the dropped residual, with s =
    2^(e+1) for the frexp exponent e of the max-abs hi along ``dim`` (an
    all-zero line takes magnitude 1).  The residual is tracked in ``nm``
    arithmetic, so every subtraction is exact."""
    mag = torch.amax(torch.abs(v.hi), dim=dim, keepdim=True)
    mag = torch.where(mag == 0, torch.ones_like(mag), mag)
    _, e = torch.frexp(mag)
    s = exp2i(e + 1).float()
    r = nm.cmap(lambda c: c / s, v)                  # exact (power of two)
    planes = []
    for i in range(n_planes):
        w = float(2.0 ** (PLANE_BITS * (i + 1)))
        q = torch.round(r.hi * w)                    # half to even, as rint
        planes.append(q)
        r = nm.sub(r, nm.df(q / w))                  # exact cancellation
    return torch.stack(planes), s


def class_products(ap: torch.Tensor, bp: torch.Tensor):
    """Exact digit-class sums of two plane stacks (NP, ..., m, k) and
    (NP, ..., k, n): for w = 0..NP-1, sum_{i+j=w} ap[i] @ bp[j], as float64
    integers.  Class w is one float64 matmul over the concatenated depth
    (planes 0..w of a against planes w..0 of b)."""
    n_planes, k = ap.shape[0], ap.shape[-1]
    a = ap.double().movedim(0, -2)                   # (..., m, NP, k)
    a = a.reshape(a.shape[:-2] + (n_planes * k,))
    b = bp.double().flip(0).movedim(0, -3)           # (..., NP, k, n)
    b = b.reshape(b.shape[:-3] + (n_planes * k, b.shape[-1]))
    return [a[..., :(w + 1) * k] @ b[..., (n_planes - 1 - w) * k:, :]
            for w in range(n_planes)]


def ozaki_matmul(a, b, n_planes: int, nm):
    """nm (..., m, k) @ (..., k, n) through n_planes digit planes, the
    class sums recombined from high weight to low."""
    ap, sa = digit_planes(a, -1, n_planes, nm)       # per row
    bp, sb = digit_planes(b, -2, n_planes, nm)       # per column
    groups = class_products(ap, bp)
    scale = sa * sb                                  # power of two
    acc = None
    for w in range(n_planes - 1, -1, -1):
        term = nm.df(groups[w].float()
                     * float(2.0 ** (-PLANE_BITS * (w + 2))))
        acc = term if acc is None else nm.add(acc, term)
    return nm.cmap(lambda c: c * scale, acc)


def matmul(a: DF, b: DF, n_planes: int = N_PLANES) -> DF:
    """df32 (..., m, k) @ (..., k, n) -> (..., m, n), ~2^-49 relative to
    the row/column magnitudes; leading axes broadcast."""
    from dqmc_tpu_torch.ops import df32
    return ozaki_matmul(a, b, n_planes, df32)
