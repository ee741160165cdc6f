"""dqmc_tpu_torch's CUDA kernels (K1, K2 with its 2-flavor and submatrix
site loops #2b and #2c, and the site updates #3, #4, #5, #6) against their
plain twins, on the card.

Marked ``cuda``; skips where torch.cuda.is_available() is false.  The
repository's conftest imports jax, which the card machine need not have,
so run this module there without it:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    return g


@pytest.mark.parametrize("n", [64, 36])
def test_cgs2_kernel_matches_twin_f64(gen, n):
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.ops import qr_kernel as qk
    A = torch.randn((3, n, n), generator=gen, device="cuda",
                    dtype=torch.float64)
    before = _cuda.LAUNCHES["cgs2_qr"]
    got = qk.cgs2_qr_inv(A)
    assert _cuda.LAUNCHES["cgs2_qr"] == before + 1
    want = qk.padded_qr(A, True, qk.cgs2_qr_plain)
    for g, w in zip(got, want):
        assert float((g - w).abs().max() / w.abs().max()) < 1e-12


# G: tests/test_fused.py's bounds for the JAX kernel against its own
# oracle -- naive B^-1 G B propagation amplifies reordered rounding by
# ~cond(B)^2 per slice backward
@pytest.mark.parametrize("forward,g_tol", [(True, 1e-9), (False, 2e-6)])
def test_fused_block_kernels_match_twin_f64(gen, forward, g_tol):
    from dqmc_tpu_torch.engine import fused
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import AttractiveHubbard
    model = AttractiveHubbard.build(square_lattice(4, 4), U=4.0, t=1.0,
                                    mu=-0.1, beta=4.0, nt=12,
                                    device="cuda")
    states = init_state(model, EngineConfig(nt=12, n_stab=3),
                        make_generators(3, 2, "cuda"))
    n, ns = 3, 16
    order = torch.argsort(torch.rand((n, ns), generator=gen, device="cuda"),
                          dim=-1)
    props = torch.randint(0, 3, (2, n, ns), generator=gen, device="cuda")
    us = torch.rand((2, n, ns), generator=gen, device="cuda",
                    dtype=torch.float64)
    fb = states.fields[:, :n] if forward else states.fields[:, -n:]
    args = (model, order, props, us, states.G, fb)
    Gk, fk, bk, ak, _ = fused.fused_block(*args, n_slices=n,
                                          forward=forward)
    Gp, fp, bp, ap, _ = fused.fused_block_plain(*args, n_slices=n,
                                                forward=forward)
    assert torch.equal(fk, fp)
    assert float((Gk - Gp).abs().max()) < g_tol
    assert float((bk - bp).abs().max()) < 1e-11 * max(1.0, float(
        bp.abs().max()))
    assert float((ak - ap).abs().max()) < 1e-12


def test_kernel_wrappers_check_their_inputs(gen):
    from dqmc_tpu_torch.engine import fused
    A = torch.zeros((2, 8, 8), device="cuda")
    with pytest.raises(TypeError):
        fused.wrap_gemm_cuda(A, A.double())
    with pytest.raises(ValueError):
        fused.wrap_gemm_cuda(A, A.mT)       # not contiguous


# (scheme, wrapper, rank keyword, kernels it launches)
SITE_SCHEMES = {
    "rank1": ("metropolis_slice_update", None, ("rank1_sites",)),
    "delayed": ("metropolis_slice_update_batched", "k_delay",
                ("delayed_sites", "delayed_flush")),
    "submatrix": ("metropolis_slice_update_submatrix", "k_sub",
                  ("submatrix_decide", "submatrix_prep", "submatrix_flush")),
}


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("scheme", list(SITE_SCHEMES))
def test_site_update_kernels_match_twin_f64(gen, scheme, shared):
    """#3, #5 and #6 against their twins, one slice at ns = 36 with a
    short last block (k = 8): the same decisions and G to 1e-12."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.ops import kernels as tk
    W, n, k = 3, 36, 8
    f64 = dict(device="cuda", dtype=torch.float64)
    G = (0.1 * torch.randn((W, 1, n, n), generator=gen, **f64)
         + 0.5 * torch.eye(n, **f64))
    fields = torch.randint(0, 4, (W, n), generator=gen, device="cuda")
    orders = torch.argsort(torch.rand((W, n), generator=gen,
                                      device="cuda"), dim=-1)
    props = torch.randint(0, 3, (W, n), generator=gen, device="cuda")
    us = torch.rand((W, n), generator=gen, **f64)
    g = torch.tensor([0.30, 0.28, 0.32], **f64)
    alpha = torch.full((W,), -1.0, **f64)
    name, rank_kw, launched = SITE_SCHEMES[scheme]
    fn = getattr(tk, name)
    kw = {rank_kw: k, "exact_rank": True} if rank_kw else {}
    args = (g, alpha, orders[0] if shared else orders, props, us, G, fields)
    before = dict(_cuda.LAUNCHES)
    Gk, fk, ak = fn(*args, **kw)
    assert all(_cuda.LAUNCHES[x] > before[x] for x in launched)
    Gp, fp, ap = fn(*args, plain=True, **kw)
    assert torch.equal(fk, fp)
    assert torch.equal(ak, ap)
    assert 0.0 < float(ak.mean()) < 1.0
    assert float((Gk - Gp).abs().max() / Gp.abs().max()) < 1e-12


def _block_case(gen, model_name, mu, n=3, W=2):
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    model = MODEL_REGISTRY[model_name].build(
        square_lattice(4, 4), U=4.0, t=1.0, mu=mu, beta=3.0, nt=12,
        device="cuda")
    states = init_state(model, EngineConfig(nt=12, n_stab=n),
                        make_generators(3, W, "cuda"))
    ns = 16
    order = torch.argsort(torch.rand((n, ns), generator=gen, device="cuda"),
                          dim=-1)
    props = torch.randint(0, 3, (W, n, ns), generator=gen, device="cuda")
    us = torch.rand((W, n, ns), generator=gen, device="cuda",
                    dtype=torch.float64)
    return model, states, order, props, us


@pytest.mark.parametrize("forward,g_tol", [(True, 1e-9), (False, 2e-6)])
@pytest.mark.parametrize("mu", [0.0, -0.8])
def test_two_flavor_block_kernels_match_twin_f64(gen, forward, g_tol, mu):
    """#2b: fields, signs, both flavors' G and Bbar."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.engine import fused
    model, states, order, props, us = _block_case(gen, "repulsive", mu)
    fb = states.fields[:, :3] if forward else states.fields[:, -3:]
    args = (model, order, props, us, states.G, fb)
    before = _cuda.LAUNCHES["fused_sites_2f"]
    Gk, fk, bk, ak, sk = fused.fused_block(*args, n_slices=3,
                                           forward=forward)
    assert _cuda.LAUNCHES["fused_sites_2f"] == before + 3
    Gp, fp, bp, ap, sp = fused.fused_block_plain(*args, n_slices=3,
                                                 forward=forward)
    assert torch.equal(fk, fp) and torch.equal(sk, sp)
    assert float((Gk - Gp).abs().max()) < g_tol
    assert float((bk - bp).abs().max()) < 1e-11 * max(1.0, float(
        bp.abs().max()))
    if mu == 0.0:
        assert bool((sk == 1.0).all())


@pytest.mark.parametrize("forward,g_tol", [(True, 3e-8), (False, 2e-6)])
@pytest.mark.parametrize("k", [4, 16])
def test_submatrix_block_kernel_matches_twin_f64(gen, forward, g_tol, k):
    """#2c at block ranks 4 and 16 (ns = 16)."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.engine import fused
    model, states, order, props, us = _block_case(gen, "attractive", -0.1)
    fb = states.fields[:, :3] if forward else states.fields[:, -3:]
    args = (model, order, props, us, states.G, fb)
    kw = dict(n_slices=3, forward=forward, k_delay=k, update="submatrix")
    before = _cuda.LAUNCHES["fused_sites_sub"]
    Gk, fk, bk, ak, _ = fused.fused_block(*args, **kw)
    assert _cuda.LAUNCHES["fused_sites_sub"] == before + 3
    Gp, fp, bp, ap, _ = fused.fused_block_plain(*args, **kw)
    assert torch.equal(fk, fp)
    assert float((Gk - Gp).abs().max()) < g_tol
    assert float((bk - bp).abs().max()) < 1e-11 * max(1.0, float(
        bp.abs().max()))


@pytest.mark.parametrize("shared", [True, False])
def test_two_flavor_site_update_kernel_matches_twin_f64(gen, shared):
    """#4 against its twin, one slice, doped couplings on a fake G so that
    signs flip: the same decisions and signs.  At ns = 36 with a short last
    block (k = 8, two columns per thread), G to 1e-12 of its largest
    entry; at the repulsive preset's shape (W = 32, ns = 64, k = 32: one
    column per thread, two full blocks) to 1e-9: 64 visits on the fake G
    drive |G| to O(1e3) through near-singular accepted moves, and the card
    measured 1.4e-11."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.ops import kernels as tk
    f64 = dict(device="cuda", dtype=torch.float64)
    for W, n, k, tol in ((3, 36, 8, 1e-12), (32, 64, 32, 1e-9)):
        G = (0.3 * torch.randn((W, 2, n, n), generator=gen, **f64)
             + 0.5 * torch.eye(n, **f64))
        fields = torch.randint(0, 4, (W, n), generator=gen, device="cuda")
        orders = torch.argsort(torch.rand((W, n), generator=gen,
                                          device="cuda"), dim=-1)
        props = torch.randint(0, 3, (W, n), generator=gen, device="cuda")
        us = torch.rand((W, n), generator=gen, **f64)
        g = 1.0 + 0.1 * torch.tensor([0.0, -1.0, 1.0], **f64).repeat(
            -(-W // 3))[:W]
        alpha = torch.zeros((W,), **f64)
        args = (g, alpha, orders[0] if shared else orders, props, us, G,
                fields)
        kw = dict(k_delay=k, exact_rank=True)
        before = dict(_cuda.LAUNCHES)
        Gk, fk, ak, sk = tk.metropolis_slice_update_batched_2f(*args, **kw)
        blocks = -(-n // k)
        assert _cuda.LAUNCHES["delayed_sites_2f"] == \
            before["delayed_sites_2f"] + blocks
        assert _cuda.LAUNCHES["delayed_flush"] == \
            before["delayed_flush"] + blocks
        Gp, fp, ap, sp = tk.metropolis_slice_update_batched_2f(
            *args, plain=True, **kw)
        assert torch.equal(fk, fp) and torch.equal(ak, ap)
        assert torch.equal(sk, sp)
        assert bool((sp == -1.0).any()), "no sign flip: reseed"
        assert float((Gk - Gp).abs().max() / Gp.abs().max()) < tol
