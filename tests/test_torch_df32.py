"""dqmc_tpu_torch's multiword arithmetic (ops/df32.py, ops/tf32.py) held
against the JAX package's on the CPU.

The same numpy-seeded inputs go through both packages (JAX eagerly, as its
own df tests run); every elementwise operation, error-free transformation,
digit-plane split and Ozaki matmul must agree bit for bit in every word.
The port takes its float32 square root through float64 because PyTorch's
CPU float32 sqrt can miss the correctly rounded result by one ulp, which
XLA's does not (checked below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu.ops import df32 as jdf
from dqmc_tpu.ops import tf32 as jtf
from dqmc_tpu_torch.ops import df32 as tdf
from dqmc_tpu_torch.ops import tf32 as ttf
from torch_port_util import (  # noqa: F401
    mw_equal,
    release_jax_programs,
    to_np)

torch.set_num_threads(1)

NMS = {"df32": (jdf, tdf), "tf32": (jtf, ttf)}
SEEDS = (0, 1, 2)


def _values(seed, shape=(6, 7), spread=6.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) * np.exp(rng.uniform(-spread, spread,
                                                            shape))


def _both(jm, tm, x):
    return jm.from_f64(jnp.asarray(x)), tm.from_f64(torch.from_numpy(x))


def _eq(a, b):
    """Bit equality of results: multiword tuples word by word, else one
    array."""
    if isinstance(a, tuple):
        return mw_equal(a, b)
    return np.array_equal(np.asarray(a), to_np(b))


def _run(op, jm, tm, seed):
    jx, tx = _both(jm, tm, _values(seed))
    jy, ty = _both(jm, tm, _values(seed + 100))
    if op in ("add", "sub", "mul", "div", "lt"):
        return getattr(jm, op)(jx, jy), getattr(tm, op)(tx, ty)
    if op in ("add_f32", "mul_f32"):
        return getattr(jm, op)(jx, jy.hi), getattr(tm, op)(tx, ty.hi)
    if op == "mul_pow2":
        k = np.random.default_rng(seed).integers(-20, 20, (6, 7))
        c = np.float32(2.0) ** k
        return jm.mul_pow2(jx, jnp.asarray(c)), tm.mul_pow2(
            tx, torch.from_numpy(c))
    if op == "sqrt":
        jx, tx = _both(jm, tm, np.abs(_values(seed)))
        return jm.sqrt(jx), tm.sqrt(tx)
    if op == "where":
        m = np.random.default_rng(seed).random((6, 7)) < 0.5
        return jm.where(jnp.asarray(m), jx, jy), tm.where(
            torch.from_numpy(m), tx, ty)
    if op == "to_f64":
        return jm.to_f64(jx), tm.to_f64(tx)
    return getattr(jm, op)(jx), getattr(tm, op)(tx)   # abs_, neg, from_f64


OPS = ("add", "sub", "mul", "div", "sqrt", "abs_", "neg", "add_f32",
       "mul_f32", "mul_pow2", "lt", "where", "to_f64")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("nm", list(NMS))
def test_elementwise_matches_jax_bitwise(nm, op, seed):
    jm, tm = NMS[nm]
    want, got = _run(op, jm, tm, seed)
    assert _eq(want, got), (nm, op, seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("nm", list(NMS))
def test_from_f64_matches_jax_and_is_exact(nm, seed):
    """The split of float64 values is bit-equal to JAX's; the triple holds
    every float64 exactly, the pair to its 48-bit floor."""
    jm, tm = NMS[nm]
    x = _values(seed)
    jx, tx = _both(jm, tm, x)
    assert mw_equal(jx, tx)
    back = to_np(tm.to_f64(tx))
    if nm == "tf32":
        np.testing.assert_array_equal(back, x)
    else:
        assert np.abs(back - x).max() <= 2.0 ** -47 * np.abs(x).max()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("eft", ["two_sum", "quick_two_sum", "two_prod",
                                 "veltkamp_split"])
def test_error_free_transformations_match_jax(eft, seed):
    a = np.float32(_values(seed))
    b = np.float32(_values(seed + 1) * 1e-3)       # |a| >= |b| mostly
    if eft == "quick_two_sum":
        big = np.abs(a) >= np.abs(b)
        a, b = np.where(big, a, b), np.where(big, b, a)
    fj, ft = getattr(jdf, eft), getattr(tdf, eft)
    args_j = (jnp.asarray(a),) if eft == "veltkamp_split" else (
        jnp.asarray(a), jnp.asarray(b))
    args_t = tuple(torch.from_numpy(np.array(x)) for x in args_j)
    want, got = fj(*args_j), ft(*args_t)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), to_np(g))
    # and they are error-free: the words sum exactly (checked in float64)
    exact = {"two_sum": a.astype(np.float64) + b,
             "quick_two_sum": a.astype(np.float64) + b,
             "two_prod": a.astype(np.float64) * b,
             "veltkamp_split": a.astype(np.float64)}[eft]
    np.testing.assert_array_equal(
        to_np(got[0]).astype(np.float64) + to_np(got[1]), exact)


MATMUL_SHAPES = (((6, 9), (9, 4)), ((3, 5, 7), (3, 7, 2)),
                 ((16, 16), (16, 16)), ((2, 24, 40), (2, 40, 8)),
                 ((1, 33, 17), (1, 17, 33)))


@pytest.mark.parametrize("shapes", MATMUL_SHAPES,
                         ids=[f"{a}x{b}" for a, b in MATMUL_SHAPES])
@pytest.mark.parametrize("nm", list(NMS))
def test_ozaki_matmul_matches_jax_bitwise(nm, shapes):
    """Graded operands (columns of the left, rows of the right over e^+-6,
    as in the LDR folds): every word of the product equals JAX's, and the
    product agrees with the float64 product of the same operands (to the
    df32 floor, and for tf32 to the float64 reference's own)."""
    jm, tm = NMS[nm]
    sa, sb = shapes
    a = _values(3, sa, spread=1.0) * np.exp(np.linspace(6, -6, sa[-1]))
    b = _values(4, sb, spread=1.0)
    ja, ta = _both(jm, tm, a)
    jb, tb = _both(jm, tm, b)
    got = tm.matmul(ta, tb)
    assert mw_equal(jm.matmul(ja, jb), got)
    ref = to_np(tm.to_f64(ta)) @ to_np(tm.to_f64(tb))
    floor = 2.0 ** -44 if nm == "df32" else 2.0 ** -50
    scale = np.abs(to_np(tm.to_f64(ta))).max(-1, keepdims=True) \
        * np.abs(to_np(tm.to_f64(tb))).max(-2, keepdims=True) * sa[-1]
    assert (np.abs(to_np(tm.to_f64(got)) - ref) / scale).max() < floor


@pytest.mark.parametrize("nm", list(NMS))
def test_matmul_broadcasts_like_per_walker_products(nm):
    """An unbatched left operand against a walker batch (the tier's
    half-warp) gives each walker JAX's unbatched product, bit for bit."""
    jm, tm = NMS[nm]
    a, b = _values(5, (12, 12)), _values(6, (3, 12, 12))
    ja, ta = _both(jm, tm, a)
    jb, tb = _both(jm, tm, b)
    got = tm.matmul(ta, tb)
    for w in range(3):
        want = jm.matmul(ja, jm.cmap(lambda c: c[w], jb))
        assert mw_equal(want, tm.cmap(lambda c: c[w], got))


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("nm", list(NMS))
def test_digit_planes_match_jax(nm, axis):
    jm, tm = NMS[nm]
    x = _values(7, (5, 9))
    x[2] = 0.0                                       # an all-zero row
    x[:, 4] = 0.0                                    # and column
    jx, tx = _both(jm, tm, x)
    jp, js = jm._digit_planes(jx, axis, jm.N_PLANES)
    tp, ts = tdf.digit_planes(tx, axis, tm.N_PLANES, tm)
    np.testing.assert_array_equal(np.asarray(jp).astype(np.float32),
                                  to_np(tp))
    np.testing.assert_array_equal(np.asarray(js), to_np(ts))
    assert np.abs(to_np(tp)).max() <= 64


def test_ldexp_is_exact_and_matches_jax():
    """ldexp through float64 is x 2^k rounded once: exact in the normal
    range and equal to jnp.ldexp there."""
    rng = np.random.default_rng(8)
    x = np.float32(rng.standard_normal(4000))
    k = rng.integers(-60, 60, 4000).astype(np.int32)
    got = to_np(tdf.ldexp(torch.from_numpy(x), torch.from_numpy(k)))
    np.testing.assert_array_equal(got, np.ldexp(x.astype(np.float64), k)
                                  .astype(np.float32))
    np.testing.assert_array_equal(got, np.asarray(
        jnp.ldexp(jnp.asarray(x), jnp.asarray(k))))
    e = torch.arange(-149, 128)
    np.testing.assert_array_equal(to_np(tdf.exp2i(e).float()),
                                  np.ldexp(np.float32(1.0), to_np(e)))


def test_sqrt32_is_correctly_rounded():
    x = np.float32(np.abs(np.random.default_rng(9).standard_normal(200000)))
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(to_np(tdf.sqrt32(torch.from_numpy(x))),
                                  want)
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))),
                                  want)
