"""The fused-block twin of dqmc_tpu_torch (the plain version of the CUDA
kernels K2, which runs on CPU tensors) against the JAX Pallas kernel
fused_block(interpret=True) at float64, on the same state and streams.

Decisions (hence the fields) must agree exactly; Bbar to 1e-11 and the
acceptance to 1e-12; G to tests/test_fused.py's bounds for the JAX kernel
against its own oracle: 1e-9 forward, 2e-6 backward (naive B^-1 G B
propagation amplifies reordered rounding by ~cond(B)^2 per slice).  At 6x6
(ns = 36, flush rank k = 4) the JAX kernel itself sits 8.0e-9 from its
oracle forward, so G is held to 3e-8 there.

The 2-flavor block (the repulsive model: both flavor chains in one site
loop, R = gb r_up r_dn, a per-walker sign) and the submatrix scheme are held
to the same JAX kernel with nfl = 2 and update = "submatrix", at the
tolerances of tests/test_fused.py (G 1e-9 for two flavors, 3e-8 for the
composite Woodbury flush; backward as above)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqmc_tpu.engine import EngineConfig, init_state
from dqmc_tpu.engine.fused import fused_block
from dqmc_tpu.lattice import square_lattice
from dqmc_tpu.models import AttractiveHubbard, RepulsiveHubbard
from dqmc_tpu_torch.engine import fused as tfused
from dqmc_tpu_torch.engine.state import EngineConfig as TEngineConfig
from dqmc_tpu_torch.engine.sweep import local_update_core
from dqmc_tpu_torch.models import AttractiveHubbard as TAttractiveHubbard
from torch_port_util import (  # noqa: F401
    release_jax_programs,
    to_np,
    torch_model)

torch.set_num_threads(1)


def _setup(W=2, L=4, beta=4.0, nt=12, n_stab=3, seed=0, repulsive=None):
    """``repulsive``: None for the attractive model, else (U, mu)."""
    lat = square_lattice(L, L)
    if repulsive is None:
        model = AttractiveHubbard.build(lat, U=4.0, t=1.0, mu=-0.1,
                                        beta=beta, nt=nt, dtype=jnp.float64)
    else:
        model = RepulsiveHubbard.build(lat, U=repulsive[0], t=1.0,
                                       mu=repulsive[1], beta=beta, nt=nt,
                                       dtype=jnp.float64)
    cfg = EngineConfig(nt=nt, n_stab=n_stab)
    keys = jax.random.split(jax.random.PRNGKey(seed), W)
    states = jax.vmap(lambda k: init_state(model, cfg, k))(keys)
    return model, cfg, states


def _streams(seed, W, n_slices, ns):
    rng = np.random.default_rng(seed)
    order = np.stack([rng.permutation(ns) for _ in range(n_slices)])
    props = rng.integers(0, 3, (W, n_slices, ns))
    us = rng.random((W, n_slices, ns))
    return order.astype(np.int32), props.astype(np.int32), us


@pytest.mark.parametrize("L,forward,seed,g_tol", [
    (4, True, 0, 1e-9),
    (4, False, 1, 2e-6),
    (6, True, 4, 3e-8),
    (6, False, 5, 2e-6),
])
def test_fused_block_twin_matches_jax(L, forward, seed, g_tol):
    model, cfg, states = _setup(L=L, seed=seed)
    _hold_block_to_jax(model, cfg, states, forward, seed + 10, g_tol)


def _hold_block_to_jax(model, cfg, states, forward, stream_seed, g_tol,
                       **kw):
    """Both packages' fused_block on the same state and streams; returns
    the port's sign (W,)."""
    W, ns, n = 2, model.n_sites, cfg.n_stab
    order, props, us = _streams(stream_seed, W, n, ns)
    fb = np.array(states.fields[:, :n] if forward
                    else states.fields[:, -n:])
    Gj, fj, bj, aj, sj = fused_block(
        model, jnp.asarray(order), jnp.asarray(props), jnp.asarray(us),
        states.G, jnp.asarray(fb), n_slices=n, forward=forward,
        interpret=True, **kw)
    Gt, ft, bt, at, st = tfused.fused_block(
        torch_model(model), torch.as_tensor(order), torch.as_tensor(props),
        torch.as_tensor(us), torch.as_tensor(np.array(states.G)),
        torch.as_tensor(fb), n_slices=n, forward=forward, **kw)
    np.testing.assert_array_equal(to_np(ft), np.asarray(fj))
    np.testing.assert_allclose(to_np(Gt), np.asarray(Gj), atol=g_tol)
    np.testing.assert_allclose(to_np(bt), np.asarray(bj), atol=1e-11)
    np.testing.assert_allclose(to_np(at), np.asarray(aj), atol=1e-12)
    np.testing.assert_array_equal(to_np(st), np.asarray(sj))
    return to_np(st)


@pytest.mark.parametrize("forward,mu,seed,g_tol", [
    (True, 0.0, 0, 1e-9),
    (False, 0.0, 0, 2e-6),
    (True, -0.8, 2, 1e-9),
    (False, -0.8, 2, 2e-6),
])
def test_two_flavor_block_twin_matches_jax(forward, mu, seed, g_tol):
    """#2b: both flavors' G and Bbar, the fields, the acceptance and the
    sign, at tests/test_fused.py's 2-flavor setup (U = 4, beta = 3); half
    filling is sign-free, the doped blocks (mu = -0.8) flip a sign."""
    model, cfg, states = _setup(seed=seed, beta=3.0, repulsive=(4.0, mu))
    sgn = _hold_block_to_jax(model, cfg, states, forward, 7, g_tol)
    if mu == 0.0:
        assert (sgn == 1.0).all()
    else:
        assert (sgn == -1.0).any(), "no sign flip in the doped block: reseed"


@pytest.mark.parametrize("forward,seed,k,g_tol", [
    (True, 3, 4, 3e-8), (True, 3, 8, 3e-8),
    (False, 4, 4, 2e-6), (False, 4, 8, 2e-6),
])
def test_submatrix_block_twin_matches_jax(forward, seed, k, g_tol):
    """#2c at block ranks 4 and 8 (ns = 16)."""
    model, cfg, states = _setup(seed=seed)
    _hold_block_to_jax(model, cfg, states, forward, seed + 10, g_tol,
                       k_delay=k, update="submatrix")


def test_submatrix_site_loop_matches_delayed_site_loop():
    """One slice: the submatrix twin decides as the delayed twin does and
    reaches the same G."""
    model, cfg, states = _setup(seed=2)
    tmodel = torch_model(model)
    W, ns = 2, model.n_sites
    order, props, us = _streams(7, W, 1, ns)
    fb = torch.as_tensor(np.array(states.fields[:, :1]))
    _, _, gb, delta, _, _ = tfused.site_factors(
        tmodel, fb, torch.as_tensor(props), torch.float64)
    out = []
    for fn, k in ((tfused.site_loop_plain, 8),
                  (tfused.site_loop_sub_plain, 4)):
        G = torch.as_tensor(np.array(states.G))[:, 0].clone()
        mask = torch.zeros((W, ns), dtype=torch.float64)
        fn(G, mask, torch.as_tensor(order), gb, delta,
           torch.as_tensor(us.reshape(W, ns)), 0, k)
        out.append((G, mask))
    assert torch.equal(out[0][1], out[1][1])
    np.testing.assert_allclose(to_np(out[1][0]), to_np(out[0][0]),
                               atol=1e-11)


def test_two_flavor_block_refuses_the_submatrix_scheme():
    model, cfg, states = _setup(repulsive=(4.0, 0.0))
    order, props, us = _streams(1, 2, 3, 16)
    with pytest.raises(NotImplementedError, match="single-flavor"):
        tfused.fused_block(
            torch_model(model), torch.as_tensor(order),
            torch.as_tensor(props), torch.as_tensor(us),
            torch.as_tensor(np.array(states.G)),
            torch.as_tensor(np.array(states.fields[:, :3])), n_slices=3,
            update="submatrix")


def test_site_loop_matches_rank1_oracle():
    """One slice of the delayed rank-k loop equals the sequential rank-1
    Sherman-Morrison loop (props translated from site to visit order)."""
    model, cfg, states = _setup(seed=2)
    tmodel = torch_model(model)
    W, ns = 2, model.n_sites
    order, props, us = _streams(7, W, 1, ns)
    G = torch.as_tensor(np.array(states.G))
    fb = torch.as_tensor(np.array(states.fields[:, :1]))
    _, _, gb, delta, _, _ = tfused.site_factors(tmodel, fb,
                                                torch.as_tensor(props),
                                                torch.float64)
    Gk = G[:, 0].clone()
    mask = torch.zeros((W, ns), dtype=torch.float64)
    tfused.site_loop_plain(Gk, mask, torch.as_tensor(order), gb, delta,
                           torch.as_tensor(us.reshape(W, ns)), 0, 8)
    for w in range(W):
        Go, fo, acc, sgn = local_update_core(
            tmodel, G[w], fb[w, 0], torch.as_tensor(order[0]),
            torch.as_tensor(props[w, 0][order[0]]),
            torch.as_tensor(us[w, 0]))
        np.testing.assert_allclose(to_np(Gk[w]), to_np(Go[0]), atol=1e-11)
        np.testing.assert_array_equal(to_np(mask[w] > 0.5),
                                      to_np(fo != fb[w, 0]))
        assert acc == float(mask[w].mean()) and sgn == 1.0


@pytest.mark.parametrize("ns,k", [(16, 16), (36, 4), (64, 32), (100, 4),
                                  (256, 32), (49, 1)])
def test_flush_rank_schedule(ns, k):
    """The JAX kernel's k_delay fallback for ns % 32 != 0 (fused.py:450)."""
    assert tfused._k_delay(ns) == k


def test_wrap_gemm_plain_semantics(rng):
    A = torch.as_tensor(rng.standard_normal((2, 5, 5)))
    B = torch.as_tensor(rng.standard_normal((5, 5)))
    r, m, c = (torch.as_tensor(rng.random((2, 5)) + 0.5) for _ in range(3))
    got = tfused.wrap_gemm_plain(A, B, rv=r, mv=m, cv=c)
    want = torch.stack([torch.diag(r[w]) @ A[w] @ torch.diag(m[w]) @ B
                        @ torch.diag(c[w]) for w in range(2)])
    np.testing.assert_allclose(to_np(got), to_np(want), atol=1e-13)


def test_supports_fused():
    model, cfg, _ = _setup()
    assert tfused.supports_fused(torch_model(model), cfg)
    big = TAttractiveHubbard.build(square_lattice(24, 24), U=4.0, t=1.0,
                                   mu=0.0, beta=1.0, nt=4)
    assert not tfused.supports_fused(big)          # ns = 576 > 512


def test_supports_fused_two_flavors_and_submatrix():
    """The 2-flavor model takes the delayed scheme only; the submatrix
    scheme is single-flavor (fused.py:614-626 of the JAX package)."""
    rep = torch_model(_setup(repulsive=(4.0, 0.0))[0])
    att = torch_model(_setup()[0])
    delayed = TEngineConfig(nt=12, n_stab=3)
    sub = TEngineConfig(nt=12, n_stab=3, fused_update="submatrix",
                        submatrix_rank=8)
    assert tfused.supports_fused(rep, delayed)
    assert not tfused.supports_fused(rep, sub)
    assert tfused.supports_fused(att, sub)
    assert tfused.block_rank(sub) == 8 and tfused.block_rank(delayed) == 32
    assert tfused.block_rank(TEngineConfig(
        nt=12, n_stab=3, fused_update="submatrix")) == 32


@pytest.mark.parametrize("ns,itemsize,nfl,update,fits", [
    (256, 4, 1, "delayed", True), (512, 4, 1, "delayed", True),
    (448, 8, 1, "delayed", True), (480, 8, 1, "delayed", False),
    (256, 4, 2, "delayed", True), (448, 4, 2, "delayed", True),
    (512, 4, 2, "delayed", False), (224, 8, 2, "delayed", True),
    (256, 8, 2, "delayed", False), (512, 4, 1, "submatrix", True),
    (416, 8, 1, "submatrix", True), (448, 8, 1, "submatrix", False),
])
def test_site_loop_shared_memory_gate(ns, itemsize, nfl, update, fits):
    """What one CTA's 227 KB of shared memory holds at k = 32: the gate
    supports_fused applies on CUDA."""
    need = tfused.site_loop_smem(ns, itemsize, nfl, update)
    assert (need <= tfused._SMEM_BYTES) == fits
