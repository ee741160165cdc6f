"""Fused propagate+update block: the CUDA kernel K2, its plain twin, and the
walker-batched sweep driver built on it.

PyTorch counterpart of ``dqmc_tpu/engine/fused.py`` (delayed scheme, one
stored flavor).  One stabilization block of ``n_slices`` slices runs, per
slice, the similarity wrap of G through B = diag(expV) expK, the
sequential Metropolis site loop with delayed rank-k updates, and one step of
the block product Bbar.  The block's field-dependent factors (gb, delta,
both expV candidates) are precomputed site-major outside the loop: every
site is visited once per slice, so its pre-update field is the slice-start
field.  The loop emits the accept mask; the caller rebuilds the fields.

Two primitives carry a block, each with a CUDA kernel
(``csrc/fused_block.cu``) and a plain torch version:

- ``wrap_gemm``: C = diag(r) A diag(m) B diag(c), batched over walkers;
- ``site_loop``: one slice of the delayed rank-k Metropolis loop.

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

import dataclasses

import torch

from dqmc_tpu_torch import _cuda
from dqmc_tpu_torch.engine.state import EngineConfig, WalkerState
from dqmc_tpu_torch.engine.sweep import (draw_slice_randoms, identity_slot,
                                         slot_get, stack_from_slots)
from dqmc_tpu_torch.hsfield import new_state
from dqmc_tpu_torch.ops.linalg import inv_one_plus_ldr_dag, mat_mul_ldr

_K = 32                 # delayed-update rank when it divides ns
_SMEM_BYTES = 232448    # dynamic shared memory one block may use (H100)


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


def site_loop_plain(G, mask, order, gb, delta, us, l, k):
    """Slice ``l`` of the delayed rank-k Metropolis loop, in place on
    G (W, n, n) and mask (W, n_slices n).  gb/delta (W, n_slices n) are
    site-indexed, us visit-indexed, order (n_slices, n)."""
    W, n, _ = G.shape
    base = l * n
    U = torch.zeros((W, k, n), dtype=G.dtype, device=G.device)
    V = torch.zeros_like(U)
    for idx, i in enumerate(order[l].tolist()):
        slot = idx % k
        row = G[:, i, :] + torch.einsum("ws,wsn->wn", U[:, :slot, i],
                                        V[:, :slot])
        col = G[:, :, i] + torch.einsum("ws,wsn->wn", V[:, :slot, i],
                                        U[:, :slot])
        d = delta[:, base + i]
        rf = 1.0 + (1.0 - row[:, i]) * d
        R = gb[:, base + i] * rf * rf                  # >= 0
        accept = us[:, base + idx] < R
        prefac = torch.where(accept, d / rf, torch.zeros_like(d))
        U[:, slot] = prefac[:, None] * col
        V[:, slot] = row
        V[:, slot, i] -= 1.0
        mask[:, base + i] = accept.to(G.dtype)
        if slot == k - 1:
            G += torch.einsum("wsa,wsb->wab", U, V)


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


def site_loop_cuda(G, mask, order, gb, delta, us, l, k):
    """Launch the site-loop kernel for slice ``l``; same contract as
    site_loop_plain (G and mask updated in place)."""
    W, n, _ = G.shape
    dev, dt = G.device, G.dtype
    L = mask.shape[1]
    _cuda.check(G, "G", device=dev, dtype=dt, shape=(W, n, n))
    for name, t in (("mask", mask), ("gb", gb), ("delta", delta),
                    ("us", us)):
        _cuda.check(t, name, device=dev, dtype=dt, shape=(W, L))
    _cuda.check(order, "order", device=dev, dtype=torch.int32,
                shape=(L // n, n))
    off = l * n
    _cuda.launch("fused_sites", "dqmc_site_loop" + _cuda.suffix(dt), dev,
                 _cuda.ptr(G), _cuda.ptr(mask, off), L,
                 _cuda.ptr(order, off), _cuda.ptr(gb, off),
                 _cuda.ptr(delta, off), _cuda.ptr(us, off), L, n, k, W,
                 _cuda.stream(dev))


_PLAIN = (wrap_gemm_plain, site_loop_plain)
_KERNELS = (wrap_gemm_cuda, site_loop_cuda)


# ----------------------------------------------------------------------
# one stabilization block
# ----------------------------------------------------------------------

def _k_delay(ns: int) -> int:
    """The JAX flush schedule: k = 32 when it divides ns, else the largest
    of 16/8/4/2/1 that does (ns = 36 -> 4)."""
    return next(c for c in (_K, 16, 8, 4, 2, 1) if ns % c == 0)


def site_factors(model, fields_blk, props, dtype):
    """Every field-dependent Metropolis factor of a block, site-major
    (fused.py:466-508): each site is visited once per slice, so its
    pre-update field is the slice-start field.  Returns (old, new) fields
    (W, n_slices, ns) and gb = gamma ratio * boson ratio, delta =
    exp(g d_eta) - 1, and exp(g eta) of the old and the proposed field, each
    (W, n_slices * ns)."""
    W = fields_blk.shape[0]
    g, alpha = model.g.to(dtype), model.alpha.to(dtype)
    eta, gamma = model.eta.to(dtype), model.gamma.to(dtype)
    old = fields_blk.to(torch.int64)
    new = new_state(old, props.to(torch.int64))
    eta_old, eta_new = eta[old], eta[new]
    d_eta = eta_new - eta_old
    flat = lambda x: x.reshape(W, -1)
    gb = flat((gamma[new] / gamma[old]) * torch.exp(alpha * g * d_eta))
    delta = flat(torch.expm1(g * d_eta))
    return (old, new, gb, delta, flat(torch.exp(g * eta_old)),
            flat(torch.exp(g * eta_new)))


def _block(prims, model, order, props, us, G, fields_blk, n_slices, forward):
    gemm, sites = prims
    W, nfl, ns, _ = G.shape
    if nfl != 1:
        raise NotImplementedError(
            "fused_block: one stored flavor only; the 2-flavor kernel is not "
            "ported yet (ROADMAP: Pallas kernels to port, #2b)")
    dtype, dev = G.dtype, G.device
    k = _k_delay(ns)
    L = n_slices * ns
    old, new, gb, delta, ev_old, ev_new = site_factors(model, fields_blk,
                                                       props, dtype)
    us = us.to(dtype).reshape(W, L).contiguous()
    order = order.to(device=dev, dtype=torch.int32).contiguous()
    expK = model.expK.to(dtype).contiguous()
    invexpK = model.invexpK.to(dtype).contiguous()

    Gw = G[:, 0].clone(memory_format=torch.contiguous_format)
    mask = torch.zeros((W, L), dtype=dtype, device=dev)
    bbar = torch.eye(ns, dtype=dtype, device=dev).repeat(W, 1, 1)
    for step in range(n_slices):
        l = step if forward else n_slices - 1 - step
        sl = slice(l * ns, (l + 1) * ns)
        if forward:
            # G' = diag(ev) expK G invexpK diag(1/ev), pre-update fields
            ev = ev_old[:, sl].contiguous()
            Gw = gemm(gemm(expK, Gw), invexpK, rv=ev, cv=1.0 / ev)
        sites(Gw, mask, order, gb, delta, us, l, k)
        ev = torch.where(mask[:, sl] > 0.5, ev_new[:, sl], ev_old[:, sl])
        if forward:
            bbar = gemm(expK, bbar, rv=ev)             # diag(ev) expK Bbar
        else:
            # G' = invexpK diag(1/ev) G diag(ev) expK, post-update fields
            Gw = gemm(invexpK, gemm(Gw, expK, rv=1.0 / ev, mv=ev))
            bbar = gemm(bbar, expK, mv=ev)             # Bbar diag(ev) expK

    accepted = mask.reshape(W, n_slices, ns) > 0.5
    fields_new = torch.where(accepted, new, old).to(fields_blk.dtype)
    acc = mask.sum(dim=1) / L
    sgn = torch.ones((W,), dtype=dtype, device=dev)
    return Gw[:, None], fields_new, bbar[:, None], acc, sgn


def fused_block(model, order, props, us, G, fields_blk, *, n_slices: int,
                forward: bool = True):
    """Run one stabilization block for a walker batch.

    order (n_slices, ns) shared visit orders; props (W, n_slices, ns)
    proposal draws indexed by SITE; us (W, n_slices, ns) uniforms indexed by
    visit; G (W, 1, ns, ns); fields_blk (W, n_slices, ns).  Returns
    (G', fields_blk', Bbar (W, 1, ns, ns), acc (W,), sign (W,)), Bbar the
    block's propagator product in application order.  CUDA tensors run the
    kernels, CPU tensors the plain versions."""
    if G.device.type == "cuda":
        prims = _KERNELS
    elif G.device.type == "cpu":
        prims = _PLAIN
    else:
        raise ValueError(f"fused_block: unsupported device {G.device}")
    return _block(prims, model, order, props, us, G, fields_blk, n_slices,
                  forward)


def fused_block_plain(model, order, props, us, G, fields_blk, *,
                      n_slices: int, forward: bool = True):
    """fused_block through the plain primitives on any device."""
    return _block(_PLAIN, model, order, props, us, G, fields_blk, n_slices,
                  forward)


# ----------------------------------------------------------------------
# walker-batched fused sweep driver
# ----------------------------------------------------------------------

def supports_fused(model, cfg: EngineConfig | None = None) -> bool:
    """Dense single-flavor det^2 models with ns <= 512; on CUDA the site
    loop's U/V buffers (2 k ns elements) must fit in shared memory, which
    rules out float64 at ns = 480 and 512."""
    ns = model.n_sites
    smem = 2 * _k_delay(ns) * ns * model.expK.element_size()
    return (model.n_flavor == 1 and model.det_power == 2
            and not getattr(model, "checkerboard", False) and ns <= 512
            and (model.device.type != "cuda" or smem <= _SMEM_BYTES))


def draw_sweep_streams(gens, nt: int, ns: int, dtype):
    """One sweep's streams: orders (nt, ns) from walker 0, props and us
    (W, nt, ns) from each walker's generator."""
    per = [draw_slice_randoms(g, ns, dtype, (nt,)) for g in gens]
    return (per[0][0], torch.stack([p[1] for p in per]),
            torch.stack([p[2] for p in per]))


def _stabilize_one(G, F_prev, other, Bbar, forward):
    """Stabilization at a block boundary: extend the carried chain factor
    with the block product and recompute G from the stable factorization;
    ``other`` is the opposite half-chain's slot from the input stack.
    Returns (G_new, F_new, log_det, err) with err the per-walker max
    deviation of the propagated G from the stabilized one."""
    if forward:
        F_new = mat_mul_ldr(Bbar, F_prev)
        G_new, log_det = inv_one_plus_ldr_dag(F_new, other)
    else:
        F_new = mat_mul_ldr(Bbar.transpose(-1, -2), F_prev)
        G_new, log_det = inv_one_plus_ldr_dag(other, F_new)
    err = torch.amax(torch.abs(G - G_new), dim=(1, 2, 3))
    return G_new, F_new, log_det, err


def sweep_fused(model, cfg: EngineConfig, states: WalkerState, *,
                forward: bool = True, streams=None) -> WalkerState:
    """One walker-batched Monte-Carlo sweep on the fused block path.

    ``streams = (orders (nt, ns), props (W, nt, ns), us (W, nt, ns))``
    replaces the draw from the walker generators (tests hand in the JAX
    package's streams).  A ragged last block (nt % n_stab != 0) runs last
    forward and first backward."""
    if not supports_fused(model, cfg):
        raise NotImplementedError("fused sweep: dense single-flavor "
                                  "det^2 model with ns <= 512 required")
    W = states.G.shape[0]
    nfl, ns, dtype, dev = model.n_flavor, model.n_sites, model.dtype, \
        model.device
    if streams is None:
        streams = draw_sweep_streams(states.gens, cfg.nt, ns, dtype)
    orders, props, us = (torch.as_tensor(x).to(dev) for x in streams)

    n_stab = cfg.n_stab
    n_full, rem = cfg.nt // n_stab, cfg.nt % n_stab
    blocks = [(i, i * n_stab, n_stab) for i in range(n_full)]
    tail = (cfg.n_stack - 1, n_full * n_stab, rem) if rem else None
    if forward:
        seq = blocks + ([tail] if tail else [])
    else:
        seq = ([tail] if tail else []) + blocks[::-1]

    id_w = identity_slot(nfl, ns, dtype, dev, (W,))
    fields = states.fields.clone()
    G, F_prev, log_det = states.G, id_w, states.log_det_M
    acc, sgn = states.acc_sum, states.sign
    emax, esum, ecnt = states.err_max, states.err_sum, states.err_count
    slots, tail_slot = [], None
    for blk in seq:
        i_stack, l0, n = blk
        win = slice(l0, l0 + n)
        G, fb, bbar, acc_b, sgn_b = fused_block(
            model, orders[win], props[:, win], us[:, win], G, fields[:, win],
            n_slices=n, forward=forward)
        fields[:, win] = fb
        other = slot_get(states.stack, i_stack + (2 if forward else 0))
        G, F_prev, log_det, err = _stabilize_one(G, F_prev, other, bbar,
                                                 forward)
        if blk is tail:
            tail_slot = F_prev
        else:
            slots.append(F_prev)
        acc = acc + acc_b * (n / cfg.nt)
        sgn = sgn * sgn_b
        emax = torch.maximum(emax, err)
        esum = esum + err
        ecnt = ecnt + 1.0
    stack = stack_from_slots(slots, id_w, tail_slot, reverse=not forward)
    return dataclasses.replace(
        states, fields=fields, G=G, stack=stack, log_det_M=log_det,
        acc_sum=acc, sign=sgn, err_max=emax, err_sum=esum, err_count=ecnt)


def sweep_pair_fused(model, cfg: EngineConfig, states: WalkerState,
                     streams=None) -> WalkerState:
    """Forward then backward fused sweep; ``streams`` is None or a pair
    (forward streams, backward streams)."""
    fwd, bwd = streams if streams is not None else (None, None)
    states = sweep_fused(model, cfg, states, forward=True, streams=fwd)
    return sweep_fused(model, cfg, states, forward=False, streams=bwd)
