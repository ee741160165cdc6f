"""The site-update kernels' plain twins of dqmc_tpu_torch (what the CUDA
kernels #3, #5 and #6 compute, run here on CPU tensors) against the JAX
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
from dqmc_tpu.models import AttractiveHubbard
from dqmc_tpu.ops.kernels import (_metropolis_batched_impl,
                                  _metropolis_batched_sub_impl,
                                  metropolis_slice_update)
from dqmc_tpu_torch.engine import sweep as tsweep
from dqmc_tpu_torch.ops import kernels as tk
from torch_port_util import jax_slice_streams, to_np, torch_model

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
    (Gt, ft, at), (Gj, fj, aj) = got, want
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


def test_pick_rank_is_jax_rule():
    assert [tk.pick_rank(ns) for ns in (1024, 256, 36, 16, 20, 9)] == \
        [32, 32, 4, 16, 4, 1]
    assert tk.pick_rank(36, 8) == 4 and tk.pick_rank(48, 8) == 8


@pytest.mark.parametrize("scheme", ["rank1", "delayed", "submatrix"])
def test_cuda_slice_check_refuses_cpu_tensors(scheme):
    """The check that guards every kernel launch refuses CPU tensors: a
    slice on the CUDA path launches its kernels or raises, and never runs
    the plain twin."""
    n = 16
    G = torch.zeros((2, n, n))
    v = torch.zeros((2, n))
    order = torch.arange(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        tk.check_cuda_slice(G, order, v, v, v, scheme, 4)


@pytest.mark.parametrize("scheme,n,k", [("delayed", 8, 64),
                                        ("submatrix", 8, 33),
                                        ("delayed", 1056, 32),
                                        ("rank1", 1056, 1)])
def test_cuda_slice_check_refuses_shapes_beyond_the_kernels(scheme, n, k):
    """Shapes and ranks the kernels do not take raise NotImplementedError
    naming the ROADMAP, before any device check."""
    G = torch.zeros((1, n, 1))
    v = torch.zeros((1, n))
    order = torch.arange(n, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tk.check_cuda_slice(G, order, v, v, v, scheme, k)
