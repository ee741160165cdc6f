"""The site-update kernels' plain twins of dqmc_tpu_torch (what the CUDA
kernels #3, #4, #5 and #6 compute, run here on CPU tensors) against the JAX
package's Pallas kernels in interpret mode and its per-walker-order scan
schemes, at float64 on 4x4 and 6x6 lattices.

Both sides consume the same random streams (drawn from JAX keys), so the
Metropolis decisions -- hence the fields and the acceptance -- must agree
exactly; G to 1e-11 (tests/test_kernels.py holds the JAX kernels to their
scan oracle at 1e-12 to 1e-13; the port adds one more summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu.engine import EngineConfig, init_state
from dqmc_tpu.engine.sweep import (local_update_slice_delayed,
                                   local_update_slice_submatrix)
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard, RepulsiveHubbard
from dqmc_tpu.ops.kernels import (_metropolis_batched_2f_impl,
                                  _metropolis_batched_impl,
                                  _metropolis_batched_sub_impl,
                                  metropolis_slice_update)
from dqmc_tpu_torch.engine import sweep as tsweep
from dqmc_tpu_torch.ops import kernels as tk
from torch_port_util import (  # noqa: F401
    jax_slice_streams,
    release_jax_programs,
    to_np,
    torch_model)

torch.set_num_threads(1)

W = 3
G_TOL = 1e-11


def _setup(L, seed=0):
    """A JAX model, physical G (W, 1, ns, ns) and one slice's fields
    (W, ns) from freshly initialized walkers, and W slice keys."""
    model = AttractiveHubbard.build(square_lattice(L, L), U=4.0, t=1.0,
                                    mu=-0.1, beta=2.0, nt=8,
                                    dtype=jnp.float64)
    cfg = EngineConfig(nt=8, n_stab=4)
    keys = jax.random.split(jax.random.PRNGKey(seed), W + 1)
    states = jax.vmap(lambda k: init_state(model, cfg, k))(keys[:W])
    slice_keys = jax.random.split(keys[W], W)
    return model, states.G, states.fields[:, 3], slice_keys


def _couplings(model):
    """Distinct per-walker (g, alpha), as parallel tempering batches."""
    g = float(model.g) * np.array([1.0, 0.9, 1.1])
    alpha = float(model.alpha) * np.array([1.0, 1.0, 0.8])
    return g, alpha


def _assert_same(got, want):
    (Gt, ft, at), (Gj, fj, aj) = got[:3], want
    np.testing.assert_array_equal(to_np(ft), np.asarray(fj))
    np.testing.assert_array_equal(to_np(at), np.asarray(aj))
    np.testing.assert_allclose(to_np(Gt), np.asarray(Gj), atol=G_TOL)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("L", [4, 6])
def test_delayed_twin_matches_jax_batched_kernel(L):
    """#3: shared order (walker 0's), per-walker g and alpha, JAX's rank
    rule (k = 16 at ns = 16, 4 at ns = 36)."""
    model, G, fields, keys = _setup(L, seed=1)
    g, alpha = _couplings(model)
    want = _metropolis_batched_impl(jnp.asarray(g), jnp.asarray(alpha), keys,
                                    G, fields, interpret=True)
    orders, props, us = jax_slice_streams(keys, model.n_sites, jnp.float64)
    got = tk.metropolis_slice_update_batched(
        _t(g), _t(alpha), _t(orders[0]), _t(props), _t(us), _t(G),
        _t(fields))
    _assert_same(got, want)


@pytest.mark.parametrize("L,k", [(4, 4), (4, 8), (6, 4)])
def test_submatrix_twin_matches_jax_batched_kernel(L, k):
    """#5: shared order, per-walker g and alpha, block rank k."""
    model, G, fields, keys = _setup(L, seed=2)
    g, alpha = _couplings(model)
    want = _metropolis_batched_sub_impl(jnp.asarray(g), jnp.asarray(alpha),
                                        keys, G, fields, k_sub=k,
                                        interpret=True)
    orders, props, us = jax_slice_streams(keys, model.n_sites, jnp.float64)
    got = tk.metropolis_slice_update_submatrix(
        _t(g), _t(alpha), _t(orders[0]), _t(props), _t(us), _t(G),
        _t(fields), k_sub=k)
    _assert_same(got, want)


@pytest.mark.parametrize("L", [4, 6])
def test_rank1_twin_matches_jax_single_walker_kernel(L):
    """#6: each walker its own order; JAX runs its unbatched kernel once
    per walker."""
    model, G, fields, keys = _setup(L, seed=3)
    want = [metropolis_slice_update(model, keys[w], G[w], fields[w],
                                    interpret=True) for w in range(W)]
    want = tuple(np.stack([np.asarray(x[j]) for x in want])
                 for j in range(3))
    orders, props, us = jax_slice_streams(keys, model.n_sites, jnp.float64)
    tm = torch_model(model)
    got = tsweep.local_update_slice(tm, _t(G), _t(fields), _t(orders),
                                    _t(props), _t(us))
    _assert_same(got, want)


@pytest.mark.parametrize("scheme,L,k", [("delayed", 4, 4), ("delayed", 6, 8),
                                        ("submatrix", 6, 8)])
def test_per_walker_twins_match_jax_schemes(scheme, L, k):
    """The per-walker-order delayed and submatrix schemes of
    engine/sweep.py against JAX's, including a rank that does not divide
    ns (JAX pads the stream; the port runs a short last block)."""
    model, G, fields, keys = _setup(L, seed=4)
    jfn = {"delayed": local_update_slice_delayed,
           "submatrix": local_update_slice_submatrix}[scheme]
    want = [jfn(model, keys[w], G[w], fields[w], k)[:3] for w in range(W)]
    want = tuple(np.stack([np.asarray(x[j]) for x in want])
                 for j in range(3))
    orders, props, us = jax_slice_streams(keys, model.n_sites, jnp.float64)
    tfn = {"delayed": tsweep.local_update_slice_delayed,
           "submatrix": tsweep.local_update_slice_submatrix}[scheme]
    got = tfn(torch_model(model), _t(G), _t(fields), _t(orders), _t(props),
              _t(us), k)
    _assert_same(got, want)


def test_two_flavor_delayed_twin_matches_jax_kernel():
    """#4 at (W=3, ns=16, k=8), doped (U=6, mu=-0.8) on the fake G of
    tests/test_kernels.py: fields, acceptance and the sign product
    identical, G to 1e-11, and a sign flip seen."""
    ns = 16
    m = RepulsiveHubbard.build(square_lattice(4, 4), U=6.0, t=1.0, mu=-0.8,
                               beta=4.0, nt=16, dtype=jnp.float64)
    rng = np.random.default_rng(21)
    G = rng.standard_normal((W, 2, ns, ns)) * 0.3 + 0.5 * np.eye(ns)
    fields = rng.integers(0, 4, (W, ns)).astype(np.int32)
    keys = jax.random.split(jax.random.PRNGKey(29), W)
    g = np.full((W,), float(m.g))
    alpha = np.full((W,), float(m.alpha))
    want = _metropolis_batched_2f_impl(
        jnp.asarray(g), jnp.asarray(alpha), keys, jnp.asarray(G),
        jnp.asarray(fields), k_delay=8, interpret=True)
    orders, props, us = jax_slice_streams(keys, ns, jnp.float64)
    got = tk.metropolis_slice_update_batched_2f(
        _t(g), _t(alpha), _t(orders[0]), _t(props), _t(us), _t(G),
        _t(fields).long(), k_delay=8)
    _assert_same(got, want[:3])
    np.testing.assert_array_equal(to_np(got[3]), np.asarray(want[3]))
    assert (to_np(got[3]) == -1.0).any(), "no sign flip: reseed"
    # the engine's rank-1 oracle realizes the same chain and sign
    tm = torch_model(m)
    for w in range(W):
        Go, fo, ao, so = tsweep.local_update_core(
            tm, _t(G[w]), _t(fields[w]).long(), _t(orders[0]), _t(props[w]),
            _t(us[w]))
        np.testing.assert_array_equal(to_np(fo), to_np(got[1][w]))
        np.testing.assert_allclose(to_np(Go), to_np(got[0][w]), atol=G_TOL)
        assert so == float(got[3][w])


@pytest.mark.parametrize("scheme", ["rank1", "submatrix"])
def test_two_flavor_schemes_without_a_kernel_match_the_delayed_twin(scheme):
    """The 2-flavor rank-1 and submatrix forms (torch ops on any device)
    realize the chain of the 2-flavor delayed twin."""
    ns = 16
    m = RepulsiveHubbard.build(square_lattice(4, 4), U=6.0, t=1.0, mu=-0.8,
                               beta=4.0, nt=16, dtype=jnp.float64)
    rng = np.random.default_rng(5)
    G = _t(rng.standard_normal((W, 2, ns, ns)) * 0.3 + 0.5 * np.eye(ns))
    fields = _t(rng.integers(0, 4, (W, ns)))
    orders = _t(np.stack([rng.permutation(ns) for _ in range(W)]))
    props, us = _t(rng.integers(0, 3, (W, ns))), _t(rng.random((W, ns)))
    g = torch.full((W,), float(m.g), dtype=torch.float64)
    alpha = torch.zeros((W,), dtype=torch.float64)
    args = (g, alpha, orders, props, us, G, fields)
    want = tk.slice_update("delayed", *args, 8)
    got = tk.slice_update(scheme, *args, 1 if scheme == "rank1" else 4)
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
    assert torch.equal(got[2], want[2])
    np.testing.assert_allclose(to_np(got[0]), to_np(want[0]), atol=G_TOL)


def test_pick_rank_is_jax_rule():
    assert [tk.pick_rank(ns) for ns in (1024, 256, 36, 16, 20, 9)] == \
        [32, 32, 4, 16, 4, 1]
    assert tk.pick_rank(36, 8) == 4 and tk.pick_rank(48, 8) == 8


@pytest.mark.parametrize("scheme", ["rank1", "delayed", "submatrix"])
def test_cuda_slice_check_refuses_cpu_tensors(scheme):
    """The check that guards every kernel launch refuses CPU tensors: a
    slice on the CUDA path launches its kernels or raises, and never runs
    the plain twin.  Every scheme's check reaches the device check at
    ns = 16 and at the 40x40 lattice's ns = 1600; the submatrix scheme's
    kernels take every ns (#5's grid has no cluster), so its check does at
    ns = 4096 too, where the delayed and rank-1 kernels stop at MAX_SITES
    (test_cuda_slice_check_refuses_shapes_beyond_the_kernels)."""
    for n in (16, 1600) + ((4096,) if scheme == "submatrix" else ()):
        G = torch.zeros((2, n, n))
        v = torch.zeros((2, n))
        order = torch.arange(n, dtype=torch.int32)
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            tk.check_cuda_slice(G, order, v, v, v, scheme, 4)


@pytest.mark.parametrize("scheme,n,k", [("delayed", 8, 64),
                                        ("submatrix", 8, 33),
                                        ("delayed", 2049, 32),
                                        ("rank1", 2049, 1)])
def test_cuda_slice_check_refuses_shapes_beyond_the_kernels(scheme, n, k):
    """Shapes and ranks the kernels do not take (k > KMAX, ns = MAX_SITES
    + 1) raise NotImplementedError naming the ROADMAP, before any device
    check."""
    assert tk.MAX_SITES == 2048
    G = torch.zeros((1, n, 1))
    v = torch.zeros((1, n))
    order = torch.arange(n, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.check_cuda_slice(G, order, v, v, v, scheme, k)


def test_delayed_slice_budget_takes_every_kernel_shape():
    """The delayed-slice kernel's cluster and shared memory (the Python
    mirror of csrc/site_loop.cuh) fit every shape the per-slice engine
    gives it: ns <= 2048, k <= 32, one or two flavors, float32 or float64;
    so do the submatrix kernels' (#2c's cluster, #5's grid).
    A cluster is the fewest CTAs (at most 16) with at most 64 sites each,
    or past ns = 1024 16 CTAs with at most 128, and a CTA takes at most one
    block's 232,448 bytes of dynamic shared memory: the full layout up to
    205,824 bytes at ns = 1024 and 232,440 at ns = 1305 (float64, two
    flavors, k = 28); past it that case takes the lean layout, 188,688
    bytes at ns = 1600 and 231,808 at 2048, and float64 with one flavor
    takes 214,016 bytes at 2048 in the full one."""
    largest, lean = 0, set()
    for ns in range(1, tk.MAX_SITES + 1):
        C, R, Rp = tk.slice_cluster(ns)
        assert C in (1, 2, 4, 8, 16) and C * R >= ns > (C - 1) * R
        if ns <= 1024:
            assert R <= 64 and (C == 1 or -(-ns // (C // 2)) > 64)
        else:
            assert C == 16 and 64 < R <= 128
        assert Rp % 4 == 0 and R <= Rp < R + 4
        for k in range(1, tk.KMAX + 1):
            for nfl in (1, 2):
                for itemsize in (4, 8):
                    need = tk.delayed_slice_smem(ns, itemsize, nfl, k)
                    assert need <= tk.SMEM_BYTES
                    largest = max(largest, need)
                    kp = (k + 7) // 8 * 8
                    if need < 8 * kp + itemsize * nfl * 4 * k * Rp:
                        lean.add((ns, nfl, itemsize))
    assert tk.delayed_slice_smem(1024, 8, 2, 32) == 205824
    assert largest == tk.delayed_slice_smem(1305, 8, 2, 28) == 232440
    assert tk.delayed_slice_smem(1600, 8, 2, 32) == 188688
    assert tk.delayed_slice_smem(2048, 8, 2, 32) == 231808
    assert tk.delayed_slice_smem(2048, 8, 1, 32) == 214016
    # the lean layout only where the full one does not fit: float64 with
    # two flavors, from ns = 1153 at k = 32 on
    assert {(nfl, s) for _, nfl, s in lean} == {(2, 8)}
    assert min(ns for ns, _, _ in lean) > 1024
    assert (1153, 2, 8) in lean and (1152, 2, 8) not in lean
    # the submatrix scheme on the same clusters (#2c, R <= 32, ns <= 512:
    # csrc/submatrix_decide.cuh sub_smem_bytes) fits too, the largest
    # shape in 69,120 bytes; #5's grid (csrc/submatrix_update.cu
    # group_grid) is ceil(ns / 64) CTAs of at most 64 indices at any ns
    largest = 0
    for ns in range(1, 513):
        for k in range(1, tk.KMAX + 1):
            for itemsize in (4, 8):
                need = tk.submatrix_slice_smem(ns, itemsize, k)
                assert need <= tk.SMEM_BYTES
                largest = max(largest, need)
    assert largest == tk.submatrix_slice_smem(512, 8, 32) == 69120
    for ns in range(1, 4097):
        C = tk.submatrix_group_ctas(ns)
        R = -(-ns // C)
        assert R <= 64 and C * R >= ns > (C - 1) * R
    # the wrapper's check takes the largest shape, and the 40x40 lattice's
    # (and then refuses the CPU tensors)
    for n in (1600, tk.MAX_SITES):
        G = torch.zeros((1, 2, n, n), dtype=torch.float64)
        v = torch.zeros((1, n), dtype=torch.float64)
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            tk.check_cuda_slice(G, torch.arange(n, dtype=torch.int32), v,
                                torch.zeros((1, 2, n), dtype=torch.float64),
                                v, "delayed", 32)


@pytest.mark.parametrize("scheme", ["rank1", "submatrix"])
def test_cuda_slice_check_refuses_two_flavors_without_a_kernel(scheme):
    """Only the delayed scheme has a 2-flavor kernel (#4)."""
    G = torch.zeros((1, 2, 16, 16))
    v = torch.zeros((1, 16))
    d = torch.zeros((1, 2, 16))
    order = torch.arange(16, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="#4"):
        tk.check_cuda_slice(G, order, v, d, v, scheme, 4)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tk.check_cuda_slice(G, order, v, d, v, "delayed", 4)
