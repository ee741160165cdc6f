"""dqmc_tpu_torch's CUDA kernels (K1, K2 with its 2-flavor and submatrix
site loops #2b and #2c, the site updates #3, #4, #5, #6, and the multiword
panel kernels #7, #8) against their plain twins, on the card.

Marked ``cuda``; skips where torch.cuda.is_available() is false.  The
repository's conftest imports jax, which the card machine need not have,
so run this module there without it:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        -m cuda tests/test_torch_cuda.py -q
"""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import panel_cases  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    return g


@pytest.mark.parametrize("n", [64, 36, 256])
def test_cgs2_kernel_matches_twin_f64(gen, n):
    """Q, R and the blockwise R^{-1} against the twin (n = 256: eight
    panels, a split block-pass contraction), one counted launch per call,
    and the same bits on a second call."""
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
    for g, again in zip(got, qk.cgs2_qr_inv(A)):
        assert torch.equal(g, again)


def test_wrap_gemm_kernel_matches_plain(gen):
    """The wrap GEMM against its plain version in both types, at a ragged
    n (36, 32 x 32 tiles), at n = 64 and at n = 256 (64 x 64 tiles), and at
    odd n (25, 81: scalar loads and stores, masked edges), with A shared, B
    shared (one tall GEMM) and neither, every scale vector, and the same
    bits on a second call."""
    from dqmc_tpu_torch.engine import fused
    for dtype in (torch.float64, torch.float32):
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        for W, n in ((4, 36), (8, 64), (3, 256), (2, 25), (2, 81)):
            rand = lambda *s: torch.rand(s, generator=gen, device="cuda",
                                         dtype=dtype) + 0.5
            Aw, Bw, K = rand(W, n, n), rand(W, n, n), rand(n, n)
            rv, mv, cv = rand(W, n), rand(W, n), rand(W, n)
            for A, B in ((K, Bw), (Aw, K), (Aw, Bw)):
                got = fused.wrap_gemm_cuda(A, B, rv=rv, mv=mv, cv=cv)
                want = fused.wrap_gemm_plain(A, B, rv=rv, mv=mv, cv=cv)
                assert float((got - want).abs().max()
                             / want.abs().max()) < tol
                assert torch.equal(
                    got, fused.wrap_gemm_cuda(A, B, rv=rv, mv=mv, cv=cv))
            got = fused.wrap_gemm_cuda(Aw, K)
            assert float((got - Aw @ K).abs().max()
                         / (Aw @ K).abs().max()) < tol


# G: tests/test_fused.py's bounds for the JAX kernel against its own
# oracle -- naive B^-1 G B propagation amplifies reordered rounding by
# ~cond(B)^2 per slice backward
@pytest.mark.parametrize("forward,g_tol", [(True, 1e-9), (False, 2e-6)])
def test_fused_block_kernels_match_twin_f64(gen, forward, g_tol):
    """K2 at ns = 16 (3 slices) and at the kernel's largest ns = 512 (a
    16 x 32 lattice, one slice: a cluster of 16 CTAs per walker)."""
    from dqmc_tpu_torch.engine import fused
    for L, n in (((4, 4), 3), ((16, 32), 1)):
        model, states, order, props, us = _block_case(
            gen, "attractive", -0.1, n=n, L=L, beta=4.0)
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
                ("delayed_slice",)),
    "submatrix": ("metropolis_slice_update_submatrix", "k_sub",
                  ("submatrix_group", "submatrix_flush")),
}


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("scheme", list(SITE_SCHEMES))
def test_site_update_kernels_match_twin_f64(gen, scheme, shared):
    """#3, #5 and #6 against their twins, one slice at ns = 36 with a
    short last block (k = 8): the same decisions and G to 1e-12.  #6 also
    at ns = 256 and 1024 (clusters of 4 and 16 CTAs per walker; float64
    rows past a CTA's shared memory stay in G at 1024): the same
    decisions, G to 1e-9 of its largest entry (ns sequential rank-1
    updates, the kernel's fused multiply-adds against the twin's rounded
    products), and the same bits on a second call."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.ops import kernels as tk
    name, rank_kw, launched = SITE_SCHEMES[scheme]
    fn = getattr(tk, name)
    f64 = dict(device="cuda", dtype=torch.float64)
    sizes = ((3, 36, 1e-12),) + (((2, 256, 1e-9), (2, 1024, 1e-9))
                                 if scheme == "rank1" else ())
    for W, n, g_tol in sizes:
        k = 8
        G = ((0.6 / n ** 0.5) * torch.randn((W, 1, n, n), generator=gen,
                                            **f64)
             + 0.5 * torch.eye(n, **f64))
        fields = torch.randint(0, 4, (W, n), generator=gen, device="cuda")
        orders = torch.argsort(torch.rand((W, n), generator=gen,
                                          device="cuda"), dim=-1)
        props = torch.randint(0, 3, (W, n), generator=gen, device="cuda")
        us = torch.rand((W, n), generator=gen, **f64)
        g = torch.tensor([0.30, 0.28, 0.32][:W], **f64)
        alpha = torch.full((W,), -1.0, **f64)
        kw = {rank_kw: k, "exact_rank": True} if rank_kw else {}
        args = (g, alpha, orders[0] if shared else orders, props, us, G,
                fields)
        before = dict(_cuda.LAUNCHES)
        Gk, fk, ak = fn(*args, **kw)
        assert all(_cuda.LAUNCHES[x] > before[x] for x in launched)
        Gp, fp, ap = fn(*args, plain=True, **kw)
        assert torch.equal(fk, fp)
        assert torch.equal(ak, ap)
        assert 0.0 < float(ak.mean()) < 1.0
        assert float((Gk - Gp).abs().max() / Gp.abs().max()) < g_tol
        if n > 36:
            again = fn(*args, **kw)
            assert torch.equal(Gk, again[0]) and torch.equal(fk, again[1])


def _block_case(gen, model_name, mu, n=3, W=2, L=(4, 4), beta=3.0,
                dtype=torch.float64):
    from dqmc_tpu_torch.engine.state import EngineConfig, make_generators
    from dqmc_tpu_torch.engine.sweep import init_state
    from dqmc_tpu_torch.lattice import square_lattice
    from dqmc_tpu_torch.models import MODEL_REGISTRY
    model = MODEL_REGISTRY[model_name].build(
        square_lattice(*L), U=4.0, t=1.0, mu=mu, beta=beta, nt=12,
        dtype=dtype, device="cuda")
    states = init_state(model, EngineConfig(nt=12, n_stab=n),
                        make_generators(3, W, "cuda"))
    ns = model.n_sites
    order = torch.argsort(torch.rand((n, ns), generator=gen, device="cuda"),
                          dim=-1)
    props = torch.randint(0, 3, (W, n, ns), generator=gen, device="cuda")
    us = torch.rand((W, n, ns), generator=gen, device="cuda", dtype=dtype)
    return model, states, order, props, us


@pytest.mark.parametrize("forward,g_tol", [(True, 1e-9), (False, 2e-6)])
@pytest.mark.parametrize("mu", [0.0, -0.8])
def test_two_flavor_block_kernels_match_twin_f64(gen, forward, g_tol, mu):
    """#2b: fields, signs, both flavors' G and Bbar, at ns = 16 (3 slices)
    and, one slice each, at ns = 256 and ns = 512 (16 x 32) in float64 and
    at ns = 512 in float32 (at most 1% of the decisions may differ there:
    two float32 arithmetics)."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.engine import fused
    for L, n, dtype in (((4, 4), 3, torch.float64),
                        ((16, 16), 1, torch.float64),
                        ((16, 32), 1, torch.float64),
                        ((16, 32), 1, torch.float32)):
        model, states, order, props, us = _block_case(
            gen, "repulsive", mu, n=n, L=L, dtype=dtype)
        fb = states.fields[:, :n] if forward else states.fields[:, -n:]
        args = (model, order, props, us, states.G, fb)
        before = _cuda.LAUNCHES["fused_sites_2f"]
        Gk, fk, bk, ak, sk = fused.fused_block(*args, n_slices=n,
                                               forward=forward)
        assert _cuda.LAUNCHES["fused_sites_2f"] == before + n
        Gp, fp, bp, ap, sp = fused.fused_block_plain(*args, n_slices=n,
                                                     forward=forward)
        if dtype == torch.float32:
            assert int((fk != fp).sum()) <= 0.01 * fk.numel()
            if torch.equal(fk, fp):
                assert torch.equal(sk, sp)
                assert float((Gk - Gp).abs().max()
                             / Gp.abs().max()) < 1e-2
            continue
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
    block (k = 8), G to 1e-12 of its largest
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
        # the whole slice, every block and its flush, in one launch
        assert _cuda.LAUNCHES["delayed_slice_2f"] == \
            before["delayed_slice_2f"] + 1
        Gp, fp, ap, sp = tk.metropolis_slice_update_batched_2f(
            *args, plain=True, **kw)
        assert torch.equal(fk, fp) and torch.equal(ak, ap)
        assert torch.equal(sk, sp)
        assert bool((sp == -1.0).any()), "no sign flip: reseed"
        assert float((Gk - Gp).abs().max() / Gp.abs().max()) < tol


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("words", [2, 3])
def test_mw_panel_kernels_match_twin(gen, words, n):
    """#7 (two words) and #8 (three) against their plain twin: every word
    of Q and R bit for bit, on a (4, 32, n) panel graded over e^+-4; then,
    for n = 256, chip_smoke.py's graded panels at every shape phase 14
    checks (n = 256, 64, 512 -- tf32's shared-memory ceiling -- and 32),
    and for n = 64 its panels with exactly zero rows and with first digits
    of 128 in y, q and e (the carry planes)."""
    from dqmc_tpu_torch import _cuda
    from dqmc_tpu_torch.ops import df32, df_qr_kernel, tf32
    nm = df32 if words == 2 else tf32
    P = nm.from_f64(torch.randn((4, 32, n), generator=gen, device="cuda",
                                dtype=torch.float64)
                    * torch.exp(torch.linspace(4, -4, 32, device="cuda",
                                               dtype=torch.float64))[:, None])
    name = "df_qr_panel" if words == 2 else "tf_qr_panel"
    cases = [(f"graded (4, 32, {n})", P)] + [
        (label, Pc) for label, Pc in panel_cases(torch, gen, nm)
        if label.startswith("graded") == (n == 256)]
    for label, Pc in cases:
        before = _cuda.LAUNCHES[name]
        got = df_qr_kernel.panel_cuda(Pc, words)
        assert _cuda.LAUNCHES[name] == before + 1
        want = df_qr_kernel.panel_plain(Pc, nm)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert torch.equal(a, b), label


@pytest.mark.parametrize("words", [2, 3])
def test_mw_hybrid_qr_on_cuda_matches_cpu(gen, words):
    """The hybrid QR on the card (external projections in multiword
    matmuls, panels through the kernel) equals the CPU path (the twin) bit
    for bit: the Ozaki plane products are exact on both devices."""
    from dqmc_tpu_torch.ops import df32, df_qr_kernel, tf32, tf_qr_kernel
    nm = df32 if words == 2 else tf32
    hybrid = (df_qr_kernel.df_qr_hybrid if words == 2
              else tf_qr_kernel.tf_qr_hybrid)
    A = nm.from_f64(torch.randn((2, 64, 64), generator=gen, device="cuda",
                                dtype=torch.float64))
    got = hybrid(A)
    want = hybrid(nm.cmap(lambda c: c.cpu(), A))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a.cpu(), b)
