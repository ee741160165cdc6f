"""Fused propagate+update block: the CUDA kernels K2, their plain twins, and
the walker-batched sweep built on them.

PyTorch counterpart of ``dqmc_tpu/engine/fused.py``.  One stabilization
block of ``n_slices`` slices runs, per slice, the similarity wrap of G
through B = diag(expV) expK, the sequential Metropolis site loop, and one
step of the block product Bbar.  The block's field-dependent factors (gb,
delta, both expV candidates) are precomputed site-major outside the loop:
every site is visited once per slice, so its pre-update field is the
slice-start field.  The loop emits the accept mask; the caller rebuilds
the fields.

Three variants of the JAX kernel body are served:

- delayed rank-k updates, one stored flavor (det_power = 2);
- delayed rank-k updates, two flavors (det_power = 1, the repulsive
  model): both flavor chains of a walker in one site loop, coupled through
  R = gb r_up r_dn, accepted on |R|, with a per-walker sign;
- ``update = "submatrix"`` (one flavor only): per group of k visits the
  decisions run on the k x k submatrix G[I, I] through a bordered Woodbury
  inverse W, then G += G[:, I] W (G[I, :] - E_I), inside the block.

Three primitives carry a block, each with a CUDA kernel
(``csrc/fused_block.cu``) and a plain torch version:

- ``wrap_gemm``: C = diag(r) A diag(m) B diag(c), batched over the walkers'
  flavor chains;
- ``site_loop``: one slice of the delayed rank-k Metropolis loop;
- ``site_loop_sub``: one slice of the submatrix scheme.

:func:`fused_block` takes the kernels for CUDA tensors and the plain
versions for CPU tensors; :func:`fused_block_plain` always takes the plain
ones (the on-card reference).  The block product is accumulated in
application order (normal form) in both sweep directions.

Markov chain: shared per-slice visit order across walkers (walker 0's
stream), per-walker proposals (indexed by site) and uniforms (indexed by
visit) -- the JAX fused engine's layout, so both packages realize the same
chain from the same streams.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from dqmc_tpu_torch import _cuda
from dqmc_tpu_torch.engine.state import EngineConfig, WalkerState
from dqmc_tpu_torch.engine.sweep import draw_sweep_streams as \
    draw_walker_streams
from dqmc_tpu_torch.engine.sweep import run_sweep
from dqmc_tpu_torch.hsfield import new_state
from dqmc_tpu_torch.ops import kernels
from dqmc_tpu_torch.ops.kernels import pick_rank

_K = 32                 # block rank when it divides ns; the kernels' largest
_SMEM_BYTES = 232448    # dynamic shared memory one block may use (H100)


def _decide_smem(itemsize: int) -> int:
    """Static shared memory of the submatrix decisions: G[I, I] and W
    (32 x 33 each), five 32-vectors and the block's sites
    (csrc/submatrix_decide.cuh DecideSmem)."""
    return (2 * 32 * 33 + 5 * 32) * itemsize + 4 * 32


# ----------------------------------------------------------------------
# primitives: plain torch
# ----------------------------------------------------------------------

def wrap_gemm_plain(A, B, rv=None, mv=None, cv=None):
    """diag(rv) A diag(mv) B diag(cv); A or B may be one shared (n, n)
    matrix, the scale vectors are (W, n) or None."""
    if mv is not None:
        A = A * mv[:, None, :]
    C = A @ B
    if rv is not None:
        C = rv[:, :, None] * C
    if cv is not None:
        C = C * cv[:, None, :]
    return C


def site_loop_plain(G, mask, order, gb, delta, us, l, k, sgn=None):
    """Slice ``l`` of the delayed rank-k Metropolis loop, in place on G and
    mask (W, n_slices n).  gb (W, n_slices n) is site-indexed, us
    visit-indexed, order (n_slices, n).  One flavor: G (W, n, n), delta
    (W, n_slices n), R = gb r^2.  Two: G (W, 2, n, n), delta
    (W, 2, n_slices n), R = gb r_up r_dn accepted on |R|, and ``sgn`` (W,)
    flips per accepted R < 0."""
    Gf, df = kernels.flavor_view(G, 3), kernels.flavor_view(delta, 2)
    W, nfl, n, _ = Gf.shape
    base = l * n
    U = torch.zeros((W, nfl, k, n), dtype=G.dtype, device=G.device)
    V = torch.zeros_like(U)
    for idx, i in enumerate(order[l].tolist()):
        slot = idx % k
        row = Gf[:, :, i, :] + torch.einsum(
            "wfs,wfsn->wfn", U[:, :, :slot, i], V[:, :, :slot])
        col = Gf[:, :, :, i] + torch.einsum(
            "wfs,wfsn->wfn", V[:, :, :slot, i], U[:, :, :slot])
        d = df[:, :, base + i]
        rf = 1.0 + (1.0 - row[:, :, i]) * d
        accept = kernels.accept_visit(gb[:, base + i], rf,
                                      us[:, base + idx], sgn)
        prefac = torch.where(accept[:, None], d / rf, torch.zeros_like(d))
        U[:, :, slot] = prefac[:, :, None] * col
        V[:, :, slot] = row
        V[:, :, slot, i] -= 1.0
        mask[:, base + i] = accept.to(G.dtype)
        if slot == k - 1:
            Gf += U.mT @ V


def site_loop_sub_plain(G, mask, order, gb, delta, us, l, k, sgn=None):
    """Slice ``l`` of the submatrix scheme, in place on G (W, n, n) and
    mask; arguments as :func:`site_loop_plain` (one flavor, k divides n).
    Per group of k visits: the decisions on G[I, I] through the bordered
    inverse W, the flush operands Ut = G[:, I]^T and M = W (G[I, :] - E_I),
    then G += Ut^T M -- the pieces of the per-slice submatrix twin, with
    the site-indexed factors gathered into visit order."""
    W, n, _ = G.shape
    base = l * n
    order_l = order[l]
    at = base + order_l.long()
    gb_v, delta_v = gb[:, at], delta[:, at]
    us_v = us[:, base:base + n]
    acc = torch.zeros((W, n), dtype=G.dtype, device=G.device)
    new = lambda *shape: torch.zeros((W,) + shape, dtype=G.dtype,
                                     device=G.device)
    Wm, Ut, M = new(k, k), new(k, n), new(k, n)
    for v0 in range(0, n, k):
        kernels.submatrix_decide_plain(G, Wm, acc, order_l, gb_v, delta_v,
                                       us_v, v0, k)
        kernels.submatrix_prep_plain(G, Wm, Ut, M, order_l, v0, k)
        kernels.rank_k_flush_plain(G, Ut, M, k)
    mask[:, at] = acc


# ----------------------------------------------------------------------
# primitives: CUDA kernels
# ----------------------------------------------------------------------

def wrap_gemm_cuda(A, B, rv=None, mv=None, cv=None):
    """Launch the wrap GEMM kernel; same contract as wrap_gemm_plain."""
    X = A if A.dim() == 3 else B
    W, n, dev, dt = X.shape[0], X.shape[-1], X.device, X.dtype
    for name, M in (("A", A), ("B", B)):
        _cuda.check(M, name, device=dev, dtype=dt,
                    shape=(W, n, n) if M.dim() == 3 else (n, n))
    for name, v in (("rv", rv), ("mv", mv), ("cv", cv)):
        if v is not None:
            _cuda.check(v, name, device=dev, dtype=dt, shape=(W, n))
    C = torch.empty((W, n, n), dtype=dt, device=dev)
    stride = lambda M: n * n if M.dim() == 3 else 0
    _cuda.launch("fused_wrap", "dqmc_wrap_gemm" + _cuda.suffix(dt), dev,
                 _cuda.ptr(C), _cuda.ptr(A), stride(A), _cuda.ptr(B),
                 stride(B), _cuda.ptr(rv), _cuda.ptr(mv), _cuda.ptr(cv), n,
                 n, W, _cuda.stream(dev))
    return C


def _check_site_loop(G, mask, order, gb, delta, us, sgn, k, update):
    """The site-loop kernels' inputs: contiguous CUDA tensors of G's dtype,
    G (W, n, n) with delta (W, L), or (W, 2, n, n) with (W, 2, L) and
    sgn (W,), at a rank and size whose buffers fit one CTA."""
    W, n = G.shape[0], G.shape[-1]
    flv = tuple(G.shape[1:-2])
    dev, dt = G.device, G.dtype
    L = mask.shape[1]
    need = site_loop_smem(n, G.element_size(), len(flv) + 1, update, k)
    if k > _K or n % k or n > 512 or need > _SMEM_BYTES:
        raise NotImplementedError(
            f"fused site loop ({update}, {len(flv) + 1} flavor(s), "
            f"{dt}) at ns={n}, k={k}: the kernel takes ns <= 512, k <= {_K} "
            f"dividing ns, and {need} bytes of rank-k buffers against one "
            f"CTA's {_SMEM_BYTES} (ROADMAP: shapes the fused kernels do not "
            f"take)")
    _cuda.check(G, "G", device=dev, dtype=dt, shape=(W,) + flv + (n, n))
    _cuda.check(delta, "delta", device=dev, dtype=dt, shape=(W,) + flv + (L,))
    for name, t in (("mask", mask), ("gb", gb), ("us", us)):
        _cuda.check(t, name, device=dev, dtype=dt, shape=(W, L))
    _cuda.check(order, "order", device=dev, dtype=torch.int32,
                shape=(L // n, n))
    if flv:
        _cuda.check(sgn, "sgn", device=dev, dtype=dt, shape=(W,))
    return W, n, L


def site_loop_cuda(G, mask, order, gb, delta, us, l, k, sgn=None):
    """Launch the delayed site-loop kernel for slice ``l``, its one-flavor
    or its two-flavor instantiation by G's shape; same contract as
    site_loop_plain (G, mask and sgn updated in place)."""
    two = G.dim() == 4
    if two and G.shape[1] != 2:
        raise ValueError(f"site loop: G {tuple(G.shape)} must have one "
                         f"flavor (W, n, n) or two (W, 2, n, n)")
    W, n, L = _check_site_loop(G, mask, order, gb, delta, us, sgn, k,
                               "delayed")
    off = l * n
    dev = G.device
    _cuda.launch("fused_sites_2f" if two else "fused_sites",
                 ("dqmc_site_loop_2f" if two else "dqmc_site_loop")
                 + _cuda.suffix(G.dtype), dev,
                 _cuda.ptr(G), _cuda.ptr(mask, off), L,
                 _cuda.ptr(order, off), _cuda.ptr(gb, off),
                 _cuda.ptr(delta, off), _cuda.ptr(us, off), L,
                 _cuda.ptr(sgn), n, k, W, _cuda.stream(dev))


def site_loop_sub_cuda(G, mask, order, gb, delta, us, l, k, sgn=None):
    """Launch the submatrix site-loop kernel for slice ``l``; same contract
    as site_loop_sub_plain."""
    if G.dim() != 3:
        raise ValueError("submatrix site loop: one flavor, G (W, n, n)")
    W, n, L = _check_site_loop(G, mask, order, gb, delta, us, None, k,
                               "submatrix")
    off = l * n
    dev = G.device
    _cuda.launch("fused_sites_sub",
                 "dqmc_site_loop_sub" + _cuda.suffix(G.dtype), dev,
                 _cuda.ptr(G), _cuda.ptr(mask, off), L,
                 _cuda.ptr(order, off), _cuda.ptr(gb, off),
                 _cuda.ptr(delta, off), _cuda.ptr(us, off), L, n, k, W,
                 _cuda.stream(dev))


_PLAIN = SimpleNamespace(gemm=wrap_gemm_plain, sites=site_loop_plain,
                         sites_sub=site_loop_sub_plain)
_KERNELS = SimpleNamespace(gemm=wrap_gemm_cuda, sites=site_loop_cuda,
                           sites_sub=site_loop_sub_cuda)


# ----------------------------------------------------------------------
# one stabilization block
# ----------------------------------------------------------------------

def _k_delay(ns: int, k: int = _K) -> int:
    """The JAX flush schedule: k (32) when it divides ns, else the largest
    of 16/8/4/2/1 that does (ns = 36 -> 4)."""
    return pick_rank(ns, k)


def site_factors(model, fields_blk, props, dtype):
    """Every field-dependent Metropolis factor of a block, site-major
    (fused.py:466-508): each site is visited once per slice, so its
    pre-update field is the slice-start field.  Returns (old, new) fields
    (W, n_slices, ns) and gb = gamma ratio * boson ratio, delta =
    exp(g d_eta) - 1, and exp(g eta) of the old and the proposed field, each
    (W, n_slices * ns).  A 2-flavor model's delta and exp(g eta) are
    (W, 2, n_slices * ns), the second flavor with the opposite coupling."""
    W = fields_blk.shape[0]
    g, alpha = model.g.to(dtype), model.alpha.to(dtype)
    eta, gamma = model.eta.to(dtype), model.gamma.to(dtype)
    old = fields_blk.to(torch.int64)
    new = new_state(old, props.to(torch.int64))
    eta_old, eta_new = eta[old], eta[new]
    d_eta = eta_new - eta_old
    gb = ((gamma[new] / gamma[old])
          * torch.exp(alpha * g * d_eta)).reshape(W, -1)
    if model.n_flavor == 1:
        flat = lambda x: torch.reshape(x, (W, -1))
    else:
        flat = lambda x: torch.stack([x, -x], dim=1).reshape(W, 2, -1)
    return (old, new, gb, torch.expm1(flat(g * d_eta)),
            torch.exp(flat(g * eta_old)), torch.exp(flat(g * eta_new)))


def _block(prims, model, order, props, us, G, fields_blk, n_slices, forward,
           k_delay, update):
    W, nfl, ns, _ = G.shape
    if nfl not in (1, 2) or nfl != model.n_flavor:
        raise ValueError(f"fused_block: G {tuple(G.shape)} for a model of "
                         f"{model.n_flavor} flavors")
    if update not in ("delayed", "submatrix"):
        raise ValueError(f"fused_block: update {update!r}: delayed or "
                         f"submatrix")
    if nfl == 2 and update == "submatrix":
        raise NotImplementedError(
            "fused_block: the submatrix scheme is single-flavor only (the "
            "delayed scheme serves two flavors), as in the JAX package")
    sites = prims.sites_sub if update == "submatrix" else prims.sites
    dtype, dev = G.dtype, G.device
    k = _k_delay(ns, k_delay)
    L = n_slices * ns
    C = W * nfl                  # flavor chains: walker w's are C-rows
    old, new, gb, delta, ev_old, ev_new = site_factors(model, fields_blk,
                                                       props, dtype)
    ev_old, ev_new = ev_old.reshape(C, L), ev_new.reshape(C, L)
    us = us.to(dtype).reshape(W, L).contiguous()
    order = order.to(device=dev, dtype=torch.int32).contiguous()
    expK = model.expK.to(dtype).contiguous()
    invexpK = model.invexpK.to(dtype).contiguous()

    Gw = G.reshape(C, ns, ns).clone(memory_format=torch.contiguous_format)
    mask = torch.zeros((W, L), dtype=dtype, device=dev)
    sgn = torch.ones((W,), dtype=dtype, device=dev)
    bbar = torch.eye(ns, dtype=dtype, device=dev).repeat(C, 1, 1)
    for step in range(n_slices):
        l = step if forward else n_slices - 1 - step
        sl = slice(l * ns, (l + 1) * ns)
        if forward:
            # G' = diag(ev) expK G invexpK diag(1/ev), pre-update fields
            ev = ev_old[:, sl].contiguous()
            Gw = prims.gemm(prims.gemm(expK, Gw), invexpK, rv=ev,
                            cv=1.0 / ev)
        sites(Gw.view(W, 2, ns, ns) if nfl == 2 else Gw, mask, order, gb,
              delta, us, l, k, sgn if nfl == 2 else None)
        # a walker's accept decides both of its flavor chains
        taken = (mask[:, sl] > 0.5).repeat_interleave(nfl, dim=0)
        ev = torch.where(taken, ev_new[:, sl], ev_old[:, sl])
        if forward:
            bbar = prims.gemm(expK, bbar, rv=ev)       # diag(ev) expK Bbar
        else:
            # G' = invexpK diag(1/ev) G diag(ev) expK, post-update fields
            Gw = prims.gemm(invexpK, prims.gemm(Gw, expK, rv=1.0 / ev,
                                                mv=ev))
            bbar = prims.gemm(bbar, expK, mv=ev)       # Bbar diag(ev) expK

    accepted = mask.reshape(W, n_slices, ns) > 0.5
    fields_new = torch.where(accepted, new, old).to(fields_blk.dtype)
    acc = mask.sum(dim=1) / L
    return (Gw.view(W, nfl, ns, ns), fields_new, bbar.view(W, nfl, ns, ns),
            acc, sgn)


def fused_block(model, order, props, us, G, fields_blk, *, n_slices: int,
                k_delay: int = _K, forward: bool = True,
                update: str = "delayed"):
    """Run one stabilization block for a walker batch.

    order (n_slices, ns) shared visit orders; props (W, n_slices, ns)
    proposal draws indexed by SITE; us (W, n_slices, ns) uniforms indexed by
    visit; G (W, nfl, ns, ns); fields_blk (W, n_slices, ns).  ``update`` is
    the in-slice scheme, delayed or submatrix, of block rank ``k_delay``
    (or the largest of 16/8/4/2/1 dividing ns when it does not).  Returns
    (G', fields_blk', Bbar (W, nfl, ns, ns), acc (W,), sign (W,)), Bbar the
    block's propagator product in application order and sign the product
    of the block's sign flips.  CUDA tensors run the kernels, CPU tensors
    the plain versions."""
    if G.device.type == "cuda":
        prims = _KERNELS
    elif G.device.type == "cpu":
        prims = _PLAIN
    else:
        raise ValueError(f"fused_block: unsupported device {G.device}")
    return _block(prims, model, order, props, us, G, fields_blk, n_slices,
                  forward, k_delay, update)


def fused_block_plain(model, order, props, us, G, fields_blk, *,
                      n_slices: int, k_delay: int = _K,
                      forward: bool = True, update: str = "delayed"):
    """fused_block through the plain primitives on any device."""
    return _block(_PLAIN, model, order, props, us, G, fields_blk, n_slices,
                  forward, k_delay, update)


# ----------------------------------------------------------------------
# walker-batched fused sweep driver
# ----------------------------------------------------------------------

def block_rank(cfg: EngineConfig) -> int:
    """The fused block's rank before the divisibility rule: the submatrix
    scheme takes ``submatrix_rank`` when set, everything else 32 (the JAX
    package's rule, fused.py:679-681)."""
    if cfg.fused_update == "submatrix" and cfg.submatrix_rank:
        return cfg.submatrix_rank
    return _K


def site_loop_smem(ns: int, itemsize: int, nfl: int = 1,
                   update: str = "delayed", k: int = _K) -> int:
    """Shared memory one CTA of the site-loop kernel needs, in bytes: the
    U/V buffers of each flavor (2 nfl k ns elements; Ut/M for the submatrix
    scheme) and, for the submatrix scheme, its k x k decision data."""
    k = pick_rank(ns, k)
    dyn = 2 * nfl * k * ns * itemsize
    return dyn + (_decide_smem(itemsize) if update == "submatrix" else 0)


def supports_fused(model, cfg: EngineConfig | None = None) -> bool:
    """Dense models with ns <= 512: single-flavor det^2 (either in-slice
    scheme) or two-flavor det^1 (delayed only), as in the JAX package.

    On CUDA the site loop keeps its rank-k buffers in one CTA's shared
    memory (227 KB), both flavors of a walker in the same CTA, and the
    block rank stops at 32.  At k = 32 (ns a multiple of 32) that leaves
    out float64 at ns >= 480 (448 for the submatrix scheme) with one
    flavor, and float32 at ns >= 480 and float64 at ns >= 256 with two.
    ``engine = auto`` takes the per-slice engine there."""
    ns = model.n_sites
    update = cfg.fused_update if cfg is not None else "delayed"
    kinds = (model.n_flavor, model.det_power)
    flavor_ok = kinds == (1, 2) or (kinds == (2, 1) and update != "submatrix")
    if not flavor_ok or getattr(model, "checkerboard", False) or ns > 512:
        return False
    if model.device.type != "cuda":
        return True
    k = block_rank(cfg) if cfg is not None else _K
    smem = site_loop_smem(ns, model.expK.element_size(), model.n_flavor,
                          update, k)
    return _k_delay(ns, k) <= _K and smem <= _SMEM_BYTES


def draw_sweep_streams(gens, nt: int, ns: int, dtype):
    """One sweep's streams: orders (nt, ns) from walker 0, props and us
    (W, nt, ns) from each walker's generator."""
    orders, props, us = draw_walker_streams(gens, nt, ns, dtype)
    return orders[0], props, us


def sweep_fused(model, cfg: EngineConfig, states: WalkerState, *,
                forward: bool = True, streams=None) -> WalkerState:
    """One walker-batched Monte-Carlo sweep on the fused block path.

    ``streams = (orders (nt, ns), props (W, nt, ns), us (W, nt, ns))``
    replaces the draw from the walker generators (tests hand in the JAX
    package's streams).  A ragged last block (nt % n_stab != 0) runs last
    forward and first backward."""
    if not supports_fused(model, cfg):
        raise NotImplementedError(
            "fused sweep: a dense 1-flavor (det^2) or 2-flavor (det^1, "
            "delayed scheme only) model with ns <= 512 whose rank-k buffers "
            "fit one CTA's shared memory (ROADMAP: shapes the fused kernels "
            "do not take)")
    if streams is None:
        streams = draw_sweep_streams(states.gens, cfg.nt, model.n_sites,
                                     model.dtype)
    orders, props, us = (torch.as_tensor(x).to(model.device)
                         for x in streams)

    def run_block(l0, n, G, fields_blk):
        win = slice(l0, l0 + n)
        return fused_block(model, orders[win], props[:, win], us[:, win], G,
                           fields_blk, n_slices=n, forward=forward,
                           k_delay=block_rank(cfg), update=cfg.fused_update)

    return run_sweep(model, cfg, states, run_block, forward=forward)


def sweep_pair_fused(model, cfg: EngineConfig, states: WalkerState,
                     streams=None) -> WalkerState:
    """Forward then backward fused sweep; ``streams`` is None or a pair
    (forward streams, backward streams)."""
    fwd, bwd = streams if streams is not None else (None, None)
    states = sweep_fused(model, cfg, states, forward=True, streams=fwd)
    return sweep_fused(model, cfg, states, forward=False, streams=bwd)
