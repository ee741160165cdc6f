"""dqmc_tpu_torch's CUDA kernels against their plain twins, on the card.

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
